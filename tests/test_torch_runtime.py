"""The port's native host runtime, on the CPU (as ``tests/test_runtime.py``
holds the JAX package's): the library builds with g++ into the
gitignored build directory; ``read_pcd_native`` equals the Python reader
(ascii within 1e-6: strtof against float64 then float32; binary
bit-equal), drops NaN rows and reads the JAX package's files like the
JAX package's native reader; the prefetcher delivers files in order
(more files than its ring, more threads than files, one file, none, an
unreadable file as b""), natively and through the Python fallback; the
PNG unfilter raises on a bad filter type.
"""

import numpy as np
import pytest

from perception_tpu import runtime as jrt
from perception_tpu_torch import runtime
from perception_tpu_torch.io.pcd import read_pcd, write_pcd


def test_native_builds_outside_the_package():
    assert runtime.native_available(), "g++ native build failed"
    lib = runtime.library_path()
    assert lib.exists() and lib.parent == runtime.BUILD_DIR
    assert "build" in lib.parts and runtime.BUILD_DIR.parts[-3:] == ("build", "perception_tpu_torch", "host")


def test_native_pcd_matches_python_ascii(tmp_path):
    pts = np.random.RandomState(0).randn(500, 3).astype(np.float32)
    p = tmp_path / "a.pcd"
    write_pcd(p, pts)
    np.testing.assert_allclose(runtime.read_pcd_native(p), read_pcd(p), atol=1e-6)


def test_native_pcd_matches_python_binary(tmp_path):
    pts = np.random.RandomState(1).randn(321, 3).astype(np.float32)
    p = tmp_path / "b.pcd"
    write_pcd(p, pts, binary=True)
    np.testing.assert_array_equal(runtime.read_pcd_native(p), pts)
    np.testing.assert_array_equal(runtime.read_pcd_native(p), jrt.read_pcd_native(p))


def test_native_pcd_drops_nans(tmp_path):
    pts = np.ones((10, 3), np.float32)
    pts[4] = np.nan
    p = tmp_path / "n.pcd"
    write_pcd(p, pts)
    assert runtime.read_pcd_native(p).shape == (9, 3)


def test_python_fallback_reads_alike(tmp_path, monkeypatch):
    pts = np.random.RandomState(2).randn(50, 3).astype(np.float32)
    write_pcd(tmp_path / "f.pcd", pts, binary=True)
    monkeypatch.setattr(runtime, "_lib", lambda: None)
    assert not runtime.native_available()
    np.testing.assert_array_equal(runtime.read_pcd_native(tmp_path / "f.pcd"), pts)


def files(tmp_path, n):
    paths = []
    for i in range(n):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * (100 + i))
        paths.append(p)
    return paths


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("n,threads,ring", [(12, 3, 4), (3, 8, 2), (1, 2, 4), (0, 2, 4)])
def test_prefetcher_ordered_delivery(tmp_path, monkeypatch, native, n, threads, ring):
    if not native:
        monkeypatch.setattr(runtime, "_lib", lambda: None)
    got = list(runtime.FramePrefetcher(files(tmp_path, n), threads=threads, ring=ring))
    assert got == [bytes([i]) * (100 + i) for i in range(n)]


@pytest.mark.parametrize("native", [True, False])
def test_prefetcher_unreadable_file_is_empty(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setattr(runtime, "_lib", lambda: None)
    paths = files(tmp_path, 3)
    paths.insert(1, tmp_path / "missing.bin")
    got = list(runtime.FramePrefetcher(paths))
    assert got[1] == b"" and got[0] == bytes([0]) * 100 and got[3] == bytes([2]) * 102


def test_prefetcher_closed_early(tmp_path):
    pf = runtime.FramePrefetcher(files(tmp_path, 10), threads=2, ring=2)
    assert next(pf) == bytes([0]) * 100
    pf.close()  # joins the workers, which are blocked on the full ring


def test_png_unfilter_rejects_bad_filter_type():
    raw = np.zeros((2, 5), np.uint8)
    raw[1, 0] = 7
    with pytest.raises(ValueError, match="filter type"):
        runtime.png_unfilter_native(raw.reshape(-1), 2, 4, 1)
