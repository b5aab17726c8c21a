"""Turn the JAX package's pipeline state into the port's.

The pipelines have no weights. The cuboid pipeline's state is the camera
and the preprocessed template (``template_features``' points, normals
and mask): ``state_from_jax`` takes them as numpy arrays (``np.asarray``
of the JAX side's values). Odometry's state is an ``OdometryState``:
``odometry_state_from_jax`` takes one whose leaves are numpy arrays. The
keyframe SLAM system's state is a ``SlamState``: ``slam_state_from_jax``
takes one the same way, and views the BRIEF descriptors (``uint32`` in
JAX) as the port's ``int32`` words. So both packages compute on the same
state. The streaming tracker's state is its ``TrackSlots``:
``track_slots_from_jax`` takes one whose leaves are numpy arrays. Each
puts the state on the card unless the caller passes ``device="cpu"``.

The face tracker's slots are a ``FaceTrackState`` and the person
tracker's table a ``TrackState``: ``face_tracks_from_jax`` and
``person_tracks_from_jax`` take them the same way.

The nets have weights: ``posenet_from_flax``, ``handnet_from_flax``,
``facenet_from_flax``, ``face_detector_from_flax`` and
``au_head_from_flax`` take a flax variable tree of numpy arrays (``{"params": ...}``, as
``io.flax_msgpack`` reads the repo's fixtures), map each flax module
name to the port's module by name, and return a state dict for
``load_state_dict``. flax kernels are ``(kh, kw, in, out)`` over NHWC,
the port's ``(out, in, kh, kw)`` over NCHW; both compute
cross-correlation, so nothing is flipped. Input channels keep flax's
order, which for a pose stage is the concat ``[features, paf, hm]``. A
``Dense`` kernel ``(in, out)`` is ``Linear.weight`` ``(out, in)``.
``posenet_to_flax``, ``handnet_to_flax``, ``facenet_to_flax``,
``face_detector_to_flax`` and ``au_head_to_flax`` are the inverses: a
net -> its flax variable tree of float32 numpy arrays, as
``flax.serialization`` saves it.

Training state: ``train_state_from_jax`` takes a JAX ``TrainState``
(``models/train.py``) whose leaves are numpy arrays and gives the port's:
the flax parameters through the converters above, and optax's state
(Adam's count, mu and nu; the SGD trace; RMSprop's nu; Adagrad's sum of
squares; Adadelta's two averages) as the port optimizer's state, so a
JAX run can be continued by the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from perception_tpu_torch.geometry.camera import PinholeCamera
from perception_tpu_torch.models.face import ActionUnitHead, FaceLandmarkNet
from perception_tpu_torch.models.face_detect import FaceDetectorNet
from perception_tpu_torch.models.hand import HandLandmarkNet
from perception_tpu_torch.models.object_tracking import TrackSlots
from perception_tpu_torch.models.pose import PoseNet
from perception_tpu_torch.models.slam.odometry import OdometryState
from perception_tpu_torch.models.tracking import TrackState
from perception_tpu_torch.models.slam.system import (
    EdgeList,
    KeyframeStore,
    LandmarkTable,
    ObsTable,
    SlamState,
)
from perception_tpu_torch.ops.voxelhash import VoxelHash


class CuboidState(NamedTuple):
    camera: PinholeCamera
    template: torch.Tensor          # (M, 3) float32
    template_normals: torch.Tensor  # (M, 3) float32
    template_mask: torch.Tensor     # (M,) bool


def state_from_jax(
    camera_K, width: int, height: int, template, template_normals, template_mask,
    device="cuda",
) -> CuboidState:
    """Intrinsics (3x3 or flat 9) + image size + template arrays -> CuboidState."""
    return CuboidState(
        camera=PinholeCamera.from_K(camera_K, width=width, height=height),
        template=torch.tensor(np.asarray(template, np.float32), device=device),
        template_normals=torch.tensor(np.asarray(template_normals, np.float32), device=device),
        template_mask=torch.tensor(np.asarray(template_mask, bool), device=device),
    )


def _leaf(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)  # keeps float32 / int32 / bool


def odometry_state_from_jax(state, device="cuda") -> OdometryState:
    """A JAX ``OdometryState`` whose leaves are numpy arrays (``np.asarray``
    of each, the ``VoxelHash`` included) -> the port's state on ``device``.
    The JAX hash's transposed ``tableT`` has no counterpart and is dropped."""
    fields = {name: _leaf(getattr(state, name), device)
              for name in OdometryState._fields if name != "map_hash"}
    vh = state.map_hash
    fields["map_hash"] = VoxelHash(*(_leaf(getattr(vh, name), device) for name in VoxelHash._fields))
    return OdometryState(**fields)


def slam_state_from_jax(state, device="cuda") -> SlamState:
    """A JAX ``SlamState`` whose leaves are numpy arrays
    (``jax.tree.map(np.asarray, state)``) -> the port's state on ``device``."""
    kf = state.keyframes
    keyframes = {name: _leaf(getattr(kf, name), device) for name in KeyframeStore._fields}
    keyframes["desc"] = _leaf(np.asarray(kf.desc).view(np.int32), device)

    def table(cls, value):
        return cls(*(_leaf(getattr(value, name), device) for name in cls._fields))

    return SlamState(
        odom=odometry_state_from_jax(state.odom, device),
        keyframes=KeyframeStore(**keyframes),
        landmarks=table(LandmarkTable, state.landmarks),
        obs=table(ObsTable, state.obs),
        edges=table(EdgeList, state.edges),
        current_kf=_leaf(state.current_kf, device),
        loop_found=_leaf(state.loop_found, device),
    )


def track_slots_from_jax(slots, device="cuda") -> TrackSlots:
    """A JAX ``TrackSlots`` whose leaves are numpy arrays
    (``jax.tree.map(np.asarray, slots)``) -> the port's slots on ``device``."""
    return TrackSlots(*(_leaf(getattr(slots, name), device) for name in TrackSlots._fields))


def face_tracks_from_jax(state, device="cuda"):
    """A JAX ``FaceTrackState`` whose leaves are numpy arrays -> the port's.
    (``models/face_multi`` imports this module through its fixture, so it
    is imported here, not at the top.)"""
    from perception_tpu_torch.models.face_multi import FaceTrackState

    return FaceTrackState(*(_leaf(getattr(state, name), device) for name in FaceTrackState._fields))


def person_tracks_from_jax(state, device="cuda") -> TrackState:
    """A JAX ``TrackState`` (``models/tracking.py``) whose leaves are numpy
    arrays -> the port's."""
    return TrackState(*(_leaf(getattr(state, name), device) for name in TrackState._fields))


def _conv_state(tree: dict, names: dict, device) -> dict:
    """{port module: flax module} -> the port's state dict; every flax
    module is used once. A conv kernel is (kh, kw, in, out), a ``Dense``
    kernel (in, out)."""
    unused = set(tree)
    state = {}
    for port, flax in names.items():
        leaf = tree[flax]
        unused.discard(flax)
        kernel = np.asarray(leaf["kernel"], np.float32)
        kernel = kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T
        state[f"{port}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel)).to(device)
        state[f"{port}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32)).to(device)
    if unused:
        raise ValueError(f"flax modules with no counterpart: {sorted(unused)}")
    return state


def _to_flax(state: dict, names: dict) -> dict:
    """The inverse of ``_conv_state``: ``net.state_dict()`` and {port
    module: flax path "A/B"} -> {"params": nested flax tree} of float32
    numpy arrays; a 4-d weight goes back to (kh, kw, in, out), a 2-d one
    to (in, out)."""
    tree = {}
    for port, flax in names.items():
        w = state[f"{port}.weight"].detach().cpu().numpy().astype(np.float32)
        node = tree
        for part in flax.split("/"):
            node = node.setdefault(part, {})
        node["kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T)
        node["bias"] = state[f"{port}.bias"].detach().cpu().numpy().astype(np.float32)
    return {"params": tree}


def _posenet_names(net: PoseNet) -> dict:
    depth, blocks = net.stage_depth, len(net.backbone)
    names = {}
    for i in range(blocks + 1):
        port = f"backbone.{i}" if i < blocks else "features"
        for j in range(len(net.features.convs)):
            names[f"{port}.convs.{j}"] = f"ConvBlock_{i}/Conv_{j}"
    for s in range(len(net.stages)):
        for j in range(depth):
            names[f"stages.{s}.convs.{j}"] = f"Stage_{s}/Conv_{j}"
        for j, head in enumerate(("mix", "paf", "hm")):
            names[f"stages.{s}.{head}"] = f"Stage_{s}/Conv_{depth + j}"
    return names


def posenet_from_flax(params: dict, net: PoseNet, device="cuda") -> dict:
    """A flax ``PoseNet`` variable tree -> ``net``'s state dict on ``device``.

    ``ConvBlock_i`` is ``backbone[i]`` and the last one ``features``;
    ``Stage_s/Conv_j`` is ``stages[s].convs[j]`` for j below the stage
    depth, then ``mix``, ``paf`` and ``hm``.
    """
    tree = params["params"]
    flat = {f"{outer}/{inner}": leaf for outer, sub in tree.items() for inner, leaf in sub.items()}
    return _conv_state(flat, _posenet_names(net), device)


def posenet_to_flax(net: PoseNet) -> dict:
    """``net`` -> its flax ``PoseNet`` variable tree (numpy float32)."""
    return _to_flax(net.state_dict(), _posenet_names(net))


def _facenet_names(net: FaceLandmarkNet) -> dict:
    n = len(net.convs)
    names = {f"convs.{j}": f"Conv_{j}" for j in range(n)}
    names["head"] = f"Conv_{n}"
    return names


def facenet_from_flax(params: dict, net: FaceLandmarkNet, device="cuda") -> dict:
    """A flax ``FaceLandmarkNet`` (or ``HandLandmarkNet``) variable tree ->
    ``net``'s state dict: ``Conv_0`` to ``Conv_4`` are ``convs``, ``Conv_5``
    the ``head``."""
    return _conv_state(params["params"], _facenet_names(net), device)


def facenet_to_flax(net: FaceLandmarkNet) -> dict:
    """``net`` -> its flax ``FaceLandmarkNet`` variable tree (numpy float32)."""
    return _to_flax(net.state_dict(), _facenet_names(net))


def handnet_to_flax(net: HandLandmarkNet) -> dict:
    """``net`` -> its flax ``HandLandmarkNet`` variable tree (numpy float32)."""
    return facenet_to_flax(net)


def handnet_from_flax(params: dict, net: HandLandmarkNet, device="cuda") -> dict:
    """A flax ``HandLandmarkNet`` variable tree -> ``net``'s state dict (the
    face landmark net's layout)."""
    return facenet_from_flax(params, net, device)


def face_detector_from_flax(params: dict, net: FaceDetectorNet, device="cuda") -> dict:
    """A flax ``FaceDetectorNet`` variable tree -> ``net``'s state dict:
    ``Conv_0`` to ``Conv_3`` are ``convs``, ``Conv_4`` ``heat``, ``Conv_5``
    ``size``."""
    return _conv_state(params["params"], _detector_names(net), device)


def _detector_names(net: FaceDetectorNet) -> dict:
    n = len(net.convs)
    names = {f"convs.{j}": f"Conv_{j}" for j in range(n)}
    names.update(heat=f"Conv_{n}", size=f"Conv_{n + 1}")
    return names


def face_detector_to_flax(net: FaceDetectorNet) -> dict:
    """``net`` -> its flax ``FaceDetectorNet`` variable tree (numpy float32)."""
    return _to_flax(net.state_dict(), _detector_names(net))


_AU_NAMES = {"hidden": "Dense_0", "intensity": "Dense_1", "presence": "Dense_2"}


def au_head_from_flax(params: dict, net: ActionUnitHead, device="cuda") -> dict:
    """A flax ``ActionUnitHead`` variable tree -> ``net``'s state dict:
    ``Dense_0`` is ``hidden``, ``Dense_1`` ``intensity``, ``Dense_2``
    ``presence``."""
    return _conv_state(params["params"], _AU_NAMES, device)


def au_head_to_flax(net: ActionUnitHead) -> dict:
    """``net`` -> its flax ``ActionUnitHead`` variable tree (numpy float32)."""
    return _to_flax(net.state_dict(), _AU_NAMES)


def _from_flax(net: nn.Module):
    """The converter of ``net``'s class (a ``ModuleDict`` converts per key)."""
    for cls, fn in ((PoseNet, posenet_from_flax), (FaceDetectorNet, face_detector_from_flax),
                    (ActionUnitHead, au_head_from_flax), (FaceLandmarkNet, facenet_from_flax)):
        if isinstance(net, cls):
            return fn
    if isinstance(net, nn.ModuleDict):
        def per_key(tree, net, device):
            return {f"{k}.{name}": v for k, sub in net.items()
                    for name, v in _from_flax(sub)(tree[k], sub, device).items()}
        return per_key
    raise TypeError(f"no flax converter for {type(net).__name__}")


# optax state fields (a NamedTuple in the chain's state tuple) -> the port
# optimizer's per-parameter state keys.
_OPTAX_STATE = {
    "ScaleByAdamState": {"mu": "exp_avg", "nu": "exp_avg_sq"},
    "TraceState": {"trace": "momentum_buffer"},
    "ScaleByRmsState": {"nu": "nu"},
    "ScaleByRssState": {"sum_of_squares": "sum_of_squares"},
    "ScaleByAdaDeltaState": {"e_g": "square_avg", "e_x": "acc_delta"},
}


def train_state_from_jax(state, net: nn.Module, optimizer, device="cuda"):
    """A JAX ``TrainState`` whose leaves are numpy arrays
    (``jax.tree.map(np.asarray, state)``) -> the port's ``TrainState`` on
    ``device``: ``net`` (the port's architecture of the flax params) gets
    the params, and ``optimizer`` (``models/train.make_optimizer`` of the
    same kind as the JAX optimizer) a fresh state filled from optax's
    state; the update count is the JAX step."""
    from perception_tpu_torch.models.train import init_train_state

    convert = _from_flax(net)
    net.load_state_dict(convert(state.params, net, device), assign=True)
    ts = init_train_state(net.to(device), optimizer)
    by_name = dict(net.named_parameters())
    opt = ts.opt_state
    for part in state.opt_state:
        fields = _OPTAX_STATE.get(type(part).__name__)
        if fields is None:
            continue
        for field, key in fields.items():
            for name, value in convert(getattr(part, field), net, device).items():
                opt.state[by_name[name]][key] = value
        if type(part).__name__ == "ScaleByAdamState":
            for p in by_name.values():
                opt.state[p]["step"] = torch.tensor(float(np.asarray(part.count)))
    return ts._replace(step=int(np.asarray(state.step)))
