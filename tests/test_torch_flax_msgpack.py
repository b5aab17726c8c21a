"""The port's flax msgpack reader against ``flax.serialization``.

``io.flax_msgpack.msgpack_restore`` must give the tree that
``flax.serialization.msgpack_restore`` gives, bit for bit: the same
nested keys, and leaves of the same type, dtype, shape and bytes. Cases:
the repo's three trained fixtures (pose, hand and face), and a blob made
here that holds every type the reader accepts (each integer and float
width, str/bin/array/map of each length class, nil, bools, flax's
ndarray, complex and numpy-scalar extensions, and a chunked array).
Loading the pose and hand fixtures needs neither flax nor msgpack.
"""

import subprocess
import sys
from pathlib import Path

import msgpack
import numpy as np
import pytest
from flax import serialization

from perception_tpu_torch.io import flax_msgpack

FIXTURES = Path(__file__).parent / "fixtures"
REPO = Path(__file__).resolve().parents[1]


def assert_same_tree(got, want, path="root"):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want, path


def flat_leaves(tree):
    return [x for v in tree.values() for x in (flat_leaves(v) if isinstance(v, dict) else [v])]


@pytest.mark.parametrize("name", ["posenet_mpi15_tiny", "handnet_tiny", "facenet_tiny"])
def test_fixture_trees_match_flax(name):
    data = (FIXTURES / f"{name}.msgpack").read_bytes()
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.msgpack_restore(data)
    assert_same_tree(got, want)
    leaves = flat_leaves(got)
    assert leaves and all(x.dtype == np.float16 for x in leaves)


def every_type_tree():
    rng = np.random.RandomState(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    return {
        "ints": ints,
        "floats": [0.0, -0.0, 1.5, 1e300, float("inf"), float("nan")],
        "nil": None,
        "bools": [True, False],
        "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "ünï"],
        "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
        "array16": list(range(16)),
        "map16": {f"k{i}": i for i in range(16)},
        "arrays": {
            "f16": rng.randn(3, 4).astype(np.float16),
            "f32": rng.randn(2, 3, 5).astype(np.float32),
            "f64": rng.randn(7).astype(np.float64),
            "i32": rng.randint(-9, 9, (4, 4)).astype(np.int32),
            "u8": rng.randint(0, 255, (5,)).astype(np.uint8),
            "bool": rng.rand(3, 3) > 0.5,
            "scalar_shape": np.float32(3.5) * np.ones((), np.float32),
            "empty": np.zeros((0, 3), np.float32),
        },
        "np_scalars": [np.float32(1.25), np.int64(-7), np.float16(0.5)],
        "complex": 1.5 - 2.25j,
    }


def test_every_type_matches_flax(monkeypatch):
    tree = every_type_tree()
    blob = serialization.msgpack_serialize(tree)
    # float32 scalars (msgpack's 0xca) and a chunked array: the first by
    # packing single floats, the second by flax's own chunking.
    singles = msgpack.packb({"f32": [1.5, -2.0]}, use_single_float=True)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    chunked = serialization.msgpack_serialize({"big": np.arange(100, dtype=np.float32).reshape(10, 10)})
    for data in (blob, singles, chunked):
        assert_same_tree(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))
    assert flax_msgpack.msgpack_restore(chunked)["big"].shape == (10, 10)
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_restore(blob[:-3])
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_restore(blob + b"\x00")


def test_fixtures_load_without_flax_or_msgpack():
    code = (
        "import sys\n"
        "for name in ('flax', 'msgpack', 'jax'):\n"
        "    sys.modules[name] = None\n"
        "from perception_tpu_torch.models import pose_fixture, hand_fixture\n"
        "net = pose_fixture.load_fixture('cpu')\n"
        "hand = hand_fixture.load_fixture('cpu')\n"
        "print(sum(p.numel() for p in net.parameters()), sum(p.numel() for p in hand.parameters()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    counts = [sum(leaf.size for leaf in flat_leaves(serialization.msgpack_restore((FIXTURES / f"{name}.msgpack").read_bytes())))
              for name in ("posenet_mpi15_tiny", "handnet_tiny")]
    assert list(map(int, out.stdout.split())) == counts
