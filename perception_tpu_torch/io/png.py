"""PNG codec on stdlib ``zlib`` and numpy, in place of ``cv2.imread`` /
``cv2.imwrite``.

The JAX package reads depth and colour frames with OpenCV
(``perception_tpu/io/tum.py``, ``cli.py``, ``io/producers.py``), which the
port's card host does not have. This module reads what those callers
read and gives the arrays they get after their BGR -> RGB flip:

* ``read_png(path)`` is ``cv2.imread(path, IMREAD_UNCHANGED)``: 8- or
  16-bit grayscale as (H, W) uint8 / uint16, RGB and RGBA (8 or 16 bits)
  as (H, W, 3 or 4) in the file's channel order (cv2's BGR / BGRA with
  the colour channels reversed);
* ``read_png(path, color=True)`` is ``IMREAD_COLOR``: (H, W, 3) uint8 RGB,
  grayscale replicated, 16-bit samples cut to their high byte, alpha
  dropped.

Interlaced, palette, gray+alpha and sub-byte files raise ``ValueError``.
The row filters are undone by the native host library
(``runtime.png_unfilter_native``) when it is available, else in numpy:
None, Sub and Up rows as whole-row vector operations, and each run of
Average or Paeth rows (sequential along a row) as a wavefront over the
run's anti-diagonals, so one numpy step decodes a pixel of every row.

``write_png`` writes 8- and 16-bit grayscale and 8-bit RGB / RGBA, every
row with one filter (Up unless told otherwise).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from perception_tpu_torch import runtime

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # color type -> samples a pixel
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter_runs(rows: np.ndarray, types: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo Average (3) and Paeth (4) over a run of ``L`` consecutive rows.

    ``rows`` (L, W, bpp) int16 filtered bytes, ``types`` (L,), ``prior``
    (W, bpp) the decoded row above the run (zeros above the image).
    Pixel (j, i) needs its left neighbour, the pixel above and the one
    above-left, so every pixel on an anti-diagonal i + j = t depends only
    on diagonals t-1 and t-2. ``S`` holds the run skewed so that diagonal
    t is one contiguous slice: ``S[i + j + 2, j + 1]`` is pixel (j, i),
    row 0 of ``S`` is ``prior`` and column i = -1 is zero."""
    L, W, _ = rows.shape
    S = np.zeros((W + L + 1, L + 1, bpp), np.int16)
    S[np.arange(W) + 1, 0] = prior
    jj, ii = np.meshgrid(np.arange(L), np.arange(W), indexing="ij")
    R = np.zeros((W + L, L, bpp), np.int16)   # R[t, j] = rows[j, t - j]
    R[ii + jj, jj] = rows
    paeth = (types == 4)[:, None]
    for t in range(W + L - 1):
        lo, hi = max(0, t - W + 1), min(L - 1, t)
        a = S[t + 1, lo + 1:hi + 2]
        b = S[t + 1, lo:hi + 1]
        c = S[t, lo:hi + 1]
        pred = np.where(paeth[lo:hi + 1], _paeth(a, b, c), (a + b) >> 1)
        S[t + 2, lo + 1:hi + 2] = (R[t, lo:hi + 1] + pred) & 255
    return S[ii + jj + 2, jj + 1]


def _unfilter_numpy(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    raw = raw.reshape(height, stride + 1)
    types = raw[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError("PNG row with a filter type other than 0-4")
    data = raw[:, 1:].reshape(height, stride // bpp, bpp).astype(np.int16)
    out = np.empty((height, stride // bpp, bpp), np.int16)
    prior = np.zeros(out.shape[1:], np.int16)
    r = 0
    while r < height:
        kind = types[r]
        if kind == 0:
            out[r] = data[r]
        elif kind == 1:
            out[r] = np.cumsum(data[r], axis=0) & 255
        elif kind == 2:
            out[r] = (data[r] + prior) & 255
        else:
            end = r
            while end < height and types[end] >= 3:
                end += 1
            out[r:end] = _unfilter_runs(data[r:end], types[r:end], prior, bpp)
            r = end
            prior = out[r - 1]
            continue
        prior = out[r]
        r += 1
    return out.astype(np.uint8).reshape(height, stride)


def decode_png(data: bytes, color: bool = False, native: bool = True) -> np.ndarray:
    """PNG bytes -> numpy image (see the module docstring for ``color``).
    ``native=False`` undoes the row filters in numpy even where the host
    library is available."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, color_type, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if color_type not in _CHANNELS:
        raise ValueError(f"PNG color type {color_type} is not supported (gray, RGB, RGBA only)")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not supported (8 or 16 only)")
    channels = _CHANNELS[color_type]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * bpp + 1):
        raise ValueError(f"PNG data of {raw.size} bytes does not fill {width}x{height}")
    if native and runtime.native_available():
        pix = runtime.png_unfilter_native(raw, height, width * bpp, bpp)
    else:
        pix = _unfilter_numpy(raw, height, width * bpp, bpp)
    img = pix.view(">u2").astype(np.uint16) if depth == 16 else pix
    img = img.reshape((height, width, channels) if channels > 1 else (height, width))
    if not color:
        return img
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
    if channels == 1:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_png(path, color: bool = False) -> np.ndarray:
    """Read a PNG file (``cv2.imread`` with ``IMREAD_UNCHANGED``, or
    ``IMREAD_COLOR`` when ``color``, channels in RGB order)."""
    return decode_png(Path(path).read_bytes(), color=color)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(image: np.ndarray, level: int = 1, filter_type: int = 2) -> bytes:
    """(H, W) uint8 / uint16, or (H, W, 3 or 4) uint8 RGB / RGBA -> PNG
    bytes, every row filtered with ``filter_type`` (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth; the forward filters read unfiltered bytes only,
    so each is one vector operation)."""
    image = np.asarray(image)
    channels = 1 if image.ndim == 2 else image.shape[-1]
    if image.dtype not in (np.uint8, np.uint16) or channels not in _COLOR_TYPE or image.ndim not in (2, 3):
        raise ValueError(f"cannot write a {image.dtype} image of shape {image.shape} as PNG")
    if image.dtype == np.uint16 and channels != 1:
        raise ValueError("16-bit PNG is written for grayscale only")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type} is not 0-4")
    height, width = image.shape[:2]
    depth = 16 if image.dtype == np.uint16 else 8
    bpp = channels * depth // 8
    rows = np.ascontiguousarray(image.astype(">u2") if depth == 16 else image)
    x = rows.view(np.uint8).reshape(height, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                 # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                           # up
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]              # up-left
    pred = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c))[filter_type]
    body = np.concatenate([np.full((height, 1), filter_type, np.uint8), (x - pred).astype(np.uint8)], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, _COLOR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray, level: int = 1, filter_type: int = 2) -> None:
    Path(path).write_bytes(encode_png(image, level, filter_type))
