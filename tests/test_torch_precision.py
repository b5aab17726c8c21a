"""The port's float32 guard, ``_tensor.fp32()``, on the CPU.

cuDNN's convolutions default to TF32 on the card, and a caller may switch
cuBLAS's matmuls to it too. The package sets no process-global flag: each
net's ``forward`` and the training step run under ``fp32()``, which
switches both flags off for its block and restores the caller's values.
Here the flags are spied on inside the nets' convolutions and linear
layers (``F.conv2d`` / ``F.linear``) and inside the training step's
backward pass (a module backward hook), with the caller's flags set True.
The card's numbers under such a caller are held in ``test_torch_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from perception_tpu_torch._tensor import fp32
from perception_tpu_torch.models import train
from perception_tpu_torch.models.face import ActionUnitHead, FaceLandmarkNet
from perception_tpu_torch.models.face_detect import FaceDetectorNet
from perception_tpu_torch.models.hand import HandLandmarkNet
from perception_tpu_torch.models.pose import PoseNet


def flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def tf32_on(monkeypatch):
    """The caller's TF32 switched on for both libraries."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


@pytest.fixture
def seen(monkeypatch):
    """The flags at each ``F.conv2d`` and ``F.linear`` call."""
    out = []
    for name in ("conv2d", "linear"):
        def spy(*args, _real=getattr(F, name), **kwargs):
            out.append(flags())
            return _real(*args, **kwargs)
        monkeypatch.setattr(F, name, spy)
    return out


def tiny_posenet():
    torch.manual_seed(0)
    return PoseNet(num_parts=3, num_limbs=2, num_stages=2, backbone_widths=(4, 4, 4), stage_width=4,
                   stage_depth=1)


@pytest.mark.parametrize("before", [(True, True), (True, False), (False, True), (False, False)])
def test_fp32_restores_the_callers_flags(monkeypatch, before):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before[0])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before[1])
    with fp32():
        assert flags() == (False, False)
        with fp32():
            assert flags() == (False, False)
        assert flags() == (False, False)
    assert flags() == before
    with pytest.raises(ZeroDivisionError):
        with fp32():
            1 / 0
    assert flags() == before


@pytest.mark.parametrize("net, x", [
    (tiny_posenet, (1, 3, 16, 16)),
    (lambda: FaceLandmarkNet(width=4), (2, 1, 16, 16)),
    (lambda: HandLandmarkNet(width=4), (2, 1, 16, 16)),
    (ActionUnitHead, (2, 70, 2)),
    (FaceDetectorNet, (1, 1, 32, 32)),
])
def test_nets_compute_in_float32_under_a_tf32_caller(tf32_on, seen, net, x):
    out = net()(torch.rand(x))
    assert all(bool(torch.isfinite(o).all()) for o in out) if isinstance(out, tuple) else bool(
        torch.isfinite(out).all())
    assert seen and set(seen) == {(False, False)}
    assert flags() == (True, True)


def test_posenet_blocks_guard_themselves(tf32_on, seen):
    net = tiny_posenet()
    net.backbone[0](torch.rand(1, 3, 8, 8))
    net.stages[0](torch.rand(1, 4, 2, 2))
    assert len(seen) == 2 + 4 and set(seen) == {(False, False)}
    assert flags() == (True, True)


def test_train_step_backward_in_float32(tf32_on, seen):
    net = tiny_posenet()
    in_backward = []
    net.backbone[0].convs[1].register_full_backward_hook(lambda *_: in_backward.append(flags()))
    opt = train.make_optimizer(1e-3, "sgd")
    step = train.make_train_step(opt)
    gen = torch.Generator().manual_seed(1)
    batch = {"image": torch.rand(2, 3, 16, 16, generator=gen),
             "paf": torch.rand(2, 4, 2, 2, generator=gen),
             "heatmap": torch.rand(2, 4, 2, 2, generator=gen)}
    state, loss = step(train.init_train_state(net, opt), batch)
    assert state.step == 1 and bool(torch.isfinite(loss))
    assert seen and set(seen) == {(False, False)}
    assert in_backward == [(False, False)]
    assert flags() == (True, True)
