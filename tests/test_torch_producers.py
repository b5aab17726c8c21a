"""The port's ImageDirectoryReader against the JAX package's, on files
that the port's PNG codec does not read: cv2-written JPEGs and a gray +
alpha PNG. Frames and timestamps must be equal (both decode through
cv2 there). Without cv2 the port's reader and ``cli pose --image`` stop
with the file's name; they never drop a file silently.
"""

import struct
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from perception_tpu.io.producers import ImageDirectoryReader as JReader  # noqa: E402
from perception_tpu_torch import cli  # noqa: E402
from perception_tpu_torch.io.producers import ImageDirectoryReader, decode_frame  # noqa: E402


def gray_alpha_png(h=8, w=8, seed=0) -> bytes:
    """An 8-bit gray + alpha PNG (colour type 4), unfiltered rows."""
    rng = np.random.RandomState(seed)
    pix = rng.randint(0, 256, (h, w, 2), np.uint8)
    raw = b"".join(b"\x00" + row.tobytes() for row in pix)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 4, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def frames(reader):
    return [(t, f) for t, f in reader.frames()]


def assert_same(got, want):
    assert len(got) == len(want)
    for (t, f), (jt, jf) in zip(got, want):
        assert t == jt
        assert f.shape == jf.shape and f.dtype == jf.dtype
        np.testing.assert_array_equal(f, jf)


@pytest.fixture
def jpeg_dir(tmp_path):
    rng = np.random.RandomState(1)
    for i in range(3):
        img = rng.randint(0, 256, (24, 32, 3), np.uint8)
        assert cv2.imwrite(str(tmp_path / f"f{i}.jpg"), img)
    return tmp_path


@pytest.mark.parametrize("prefetch", [True, False])
def test_jpeg_directory_matches_jax(jpeg_dir, prefetch):
    got = frames(ImageDirectoryReader(jpeg_dir, "*.jpg", prefetch=prefetch))
    want = frames(JReader(jpeg_dir, "*.jpg", prefetch=prefetch))
    assert len(got) == 3
    assert_same(got, want)
    assert got[0][1].shape == (24, 32, 3)


@pytest.mark.parametrize("prefetch", [True, False])
def test_gray_alpha_png_matches_jax(tmp_path, prefetch):
    (tmp_path / "a.png").write_bytes(gray_alpha_png())
    got = frames(ImageDirectoryReader(tmp_path, prefetch=prefetch))
    want = frames(JReader(tmp_path, prefetch=prefetch))
    assert_same(got, want)
    assert got[0][1].shape == (8, 8, 4)


def test_mixed_directory_keeps_indices(tmp_path):
    rng = np.random.RandomState(2)
    cv2.imwrite(str(tmp_path / "0.png"), rng.randint(0, 256, (6, 7, 3), np.uint8))
    (tmp_path / "1.png").write_bytes(gray_alpha_png(seed=3))
    (tmp_path / "2.png").write_bytes(b"not an image")
    cv2.imwrite(str(tmp_path / "3.png"), rng.randint(0, 65535, (6, 7), np.uint16))
    with pytest.warns(UserWarning, match="2.png"):
        got = frames(ImageDirectoryReader(tmp_path, prefetch=False))
    want = frames(JReader(tmp_path, prefetch=False))
    assert [t for t, _ in got] == [0.0, 1.0, 3.0]
    assert_same(got, want)


def test_without_cv2_the_reader_names_the_file(tmp_path, monkeypatch):
    (tmp_path / "a.png").write_bytes(gray_alpha_png())
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="a.png"):
        frames(ImageDirectoryReader(tmp_path, prefetch=False))
    ok = np.zeros((4, 5), np.uint8)
    from perception_tpu_torch.io.png import encode_png

    np.testing.assert_array_equal(decode_frame(encode_png(ok), "b.png"), ok)  # the codec needs no cv2


def test_cli_pose_image_reads_or_stops(tmp_path, monkeypatch):
    path = tmp_path / "a.png"
    path.write_bytes(gray_alpha_png())
    img = cli._read_image(str(path), color=True)
    np.testing.assert_array_equal(img, cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="a.png"):
        cli._read_image(str(path), color=True)
    with pytest.raises(SystemExit, match="a.png"):
        cli.main(["pose", "--image", str(path), "--cpu"])
