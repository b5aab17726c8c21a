"""The port's PNG codec against OpenCV, on the CPU.

``io/png.read_png`` stands in for ``cv2.imread`` where the port runs
without OpenCV. It must be bit-equal to ``cv2.imread`` with
``IMREAD_UNCHANGED`` and ``IMREAD_COLOR`` (channels reversed from cv2's
BGR / BGRA) on every file of ``tests/fixtures/tum_mini``, and on files
that cv2 writes with each row filter forced (None, Sub, Up, Average,
Paeth) and with libpng's adaptive choice: 8- and 16-bit gray, 8-bit RGB
and RGBA, 16-bit RGB, odd widths. Both unfilter paths are held to it:
the native host library's and numpy's (Average and Paeth rows as an
anti-diagonal wavefront). What ``write_png`` writes with each filter
reads back equal through cv2. Interlaced, palette, gray+alpha and 4-bit files raise.
"""

import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from perception_tpu_torch import runtime
from perception_tpu_torch.io import png

TUM_MINI = Path(__file__).parent / "fixtures" / "tum_mini"
FILTERS = {
    "none": cv2.IMWRITE_PNG_FILTER_NONE,
    "sub": cv2.IMWRITE_PNG_FILTER_SUB,
    "up": cv2.IMWRITE_PNG_FILTER_UP,
    "average": cv2.IMWRITE_PNG_FILTER_AVG,
    "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
    "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS,
}
IMAGES = {  # name -> (shape, dtype)
    "gray8": ((37, 53), np.uint8),
    "gray16": ((31, 47), np.uint16),
    "rgb8": ((29, 41, 3), np.uint8),
    "rgba8": ((23, 39, 4), np.uint8),
    "rgb16": ((17, 25, 3), np.uint16),
}


def cv2_read(data: bytes, color: bool) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR if color else cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[-1]]]
    return img


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_native_library_is_used_here():
    assert runtime.native_available(), "g++ build of the host library failed"


@pytest.mark.parametrize("path", sorted(TUM_MINI.glob("*/*.png"))[::4] + sorted(TUM_MINI.glob("depth/*.png"))[-1:],
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_reads_tum_mini_like_cv2(path):
    data = path.read_bytes()
    for color in (False, True):
        want = cv2_read(data, color)
        assert_same(png.read_png(path, color=color), want)
        assert_same(png.decode_png(data, color=color, native=False), want)


def test_reads_every_tum_mini_file_like_cv2():
    for path in sorted(TUM_MINI.glob("*/*.png")):
        assert_same(png.read_png(path), cv2_read(path.read_bytes(), False))


def structured_image(shape, dtype, seed):
    """Noise on a ramp, so that every filter is worth choosing somewhere."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    ramp = np.linspace(0, top * 0.8, shape[1])[None, :] + np.linspace(0, top * 0.1, shape[0])[:, None]
    if len(shape) == 3:
        ramp = ramp[..., None] * np.linspace(0.5, 1.0, shape[2])
    noise = rng.integers(0, max(top // 16, 2), shape)
    return np.clip(ramp + noise, 0, top).astype(dtype)


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("kind", list(IMAGES))
def test_reads_cv2_files_with_each_filter(kind, filt):
    shape, dtype = IMAGES[kind]
    img = structured_image(shape, dtype, seed=len(kind) + len(filt))
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
    assert ok
    data = buf.tobytes()
    for color in (False, True):
        want = cv2_read(data, color)
        assert_same(png.decode_png(data, color=color), want)
        assert_same(png.decode_png(data, color=color, native=False), want)


def filter_types(data: bytes) -> np.ndarray:
    header, idat = None, []
    for kind, body in png._chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    return np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(header[1], -1)[:, 0]


def test_adaptive_files_mix_average_and_paeth_rows():
    """The adaptive cases above do exercise runs of Average and Paeth rows
    between the others (the wavefront's entry and exit)."""
    img = structured_image((64, 96), np.uint16, seed=1)
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    types = filter_types(buf.tobytes())
    assert {3, 4} <= set(types.tolist()) and len(set(types.tolist())) >= 3
    assert_same(png.decode_png(buf.tobytes(), native=False), img)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "rgba8"])
def test_written_files_read_back_through_cv2(tmp_path, kind, filter_type):
    shape, dtype = IMAGES[kind]
    img = structured_image(shape, dtype, seed=5)
    path = tmp_path / "out.png"
    png.write_png(path, img, filter_type=filter_type)
    assert set(filter_types(path.read_bytes()).tolist()) == {filter_type}
    assert_same(cv2_read(path.read_bytes(), False), img)
    assert_same(png.read_png(path), img)
    assert_same(png.decode_png(path.read_bytes(), native=False), img)


def test_writer_refuses_what_it_does_not_write():
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.uint8), filter_type=5)


def handmade(width, height, depth, color_type, interlace=0, payload=b"", extra=b""):
    ihdr = struct.pack(">IIBBBBB", width, height, depth, color_type, 0, 0, interlace)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr) + extra
            + png._chunk(b"IDAT", zlib.compress(payload)) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["interlaced", "palette", "gray+alpha", "4-bit", "not a png"])
def test_unsupported_files_raise(case):
    if case == "interlaced":
        data = png.encode_png(np.arange(64, dtype=np.uint8).reshape(8, 8))
        data = data[:8] + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 0, 0, 0, 1)) + data[33:]
    elif case == "palette":
        data = handmade(4, 2, 8, 3, payload=bytes(10), extra=png._chunk(b"PLTE", bytes(6)))
    elif case == "gray+alpha":
        data = handmade(4, 2, 8, 4, payload=bytes(18))
    elif case == "4-bit":
        data = handmade(4, 2, 4, 0, payload=bytes(6))
    else:
        data = b"GIF89a" + bytes(20)
    with pytest.raises(ValueError):
        png.decode_png(data)
