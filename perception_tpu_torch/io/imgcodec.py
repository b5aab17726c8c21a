"""Image encoding bridge: the cv_bridge capability without ROS.

Counterpart of ``perception_tpu/io/imgcodec.py``: the encoding registry
(``getCvType``, ``cv_bridge.cpp:72-113``), raw-buffer <-> array views with
explicit endianness and row padding (``matFromImage``), conversions
between encodings and ``cvtColorForDisplay``. "Messages" are plain dicts
with ``encoding``, ``height``, ``width``, ``step``, ``is_bigendian``,
``data``: the sensor_msgs/Image wire layout minus ROS.

The raw views are numpy, as in the JAX module. ``convert_color`` and
``cvt_color_for_display`` take numpy arrays or tensors and answer in kind;
a tensor is converted on its own device, to the same bytes as the numpy
function. Compressed images: PNG goes through the package's own codec
(``io/png``), JPEG through cv2, imported on use (a host may have
none). A PNG's bytes differ from cv2's (another zlib level); its pixels do
not.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perception_tpu_torch.io.colors import label_image_to_rgb8
from perception_tpu_torch.io.png import SIGNATURE, decode_png, encode_png

# encoding -> (numpy dtype, channels)
ENCODINGS: Dict[str, tuple] = {
    "mono8": (np.uint8, 1),
    "mono16": (np.uint16, 1),
    "bgr8": (np.uint8, 3),
    "rgb8": (np.uint8, 3),
    "bgra8": (np.uint8, 4),
    "rgba8": (np.uint8, 4),
    "8UC1": (np.uint8, 1),
    "8UC3": (np.uint8, 3),
    "16UC1": (np.uint16, 1),
    "16SC1": (np.int16, 1),
    "32SC1": (np.int32, 1),
    "32FC1": (np.float32, 1),
    "32FC3": (np.float32, 3),
    "64FC1": (np.float64, 1),
}


def encoding_dtype(encoding: str):
    if encoding not in ENCODINGS:
        raise ValueError(f"unsupported encoding {encoding!r}")
    return ENCODINGS[encoding]


def _numpy(arr) -> np.ndarray:
    return arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


def image_to_array(msg: dict) -> np.ndarray:
    """Image dict -> numpy array view (byteswapped if needed)."""
    dtype, ch = encoding_dtype(msg["encoding"])
    h, w, step = msg["height"], msg["width"], msg["step"]
    buf = np.frombuffer(msg["data"], np.uint8).reshape(h, step)
    row_bytes = w * ch * np.dtype(dtype).itemsize
    rows = np.ascontiguousarray(buf[:, :row_bytes])
    arr = rows.view(dtype)  # (h, w*ch) after the byte view
    arr = arr.reshape(h, w, ch) if ch > 1 else arr.reshape(h, w)
    big = bool(msg.get("is_bigendian", False))
    if big != (np.dtype(dtype).byteorder == ">") and np.dtype(dtype).itemsize > 1:
        arr = arr.byteswap()
    return arr


def array_to_image(arr, encoding: str) -> dict:
    """Array (numpy or a tensor on any device) -> little-endian image dict."""
    dtype, ch = encoding_dtype(encoding)
    arr = np.asarray(_numpy(arr), dtype)
    if ch == 1 and arr.ndim == 3:
        arr = arr[..., 0]
    if ch > 1 and (arr.ndim != 3 or arr.shape[2] != ch):
        raise ValueError(f"array shape {arr.shape} does not match {encoding}")
    h, w = arr.shape[:2]
    return {
        "encoding": encoding,
        "height": h,
        "width": w,
        "step": w * ch * np.dtype(dtype).itemsize,
        "is_bigendian": False,
        "data": np.ascontiguousarray(arr).tobytes(),
    }


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{what} needs cv2 (OpenCV), which is not installed; PNG works without it") from e
    return cv2


def array_to_compressed(arr, fmt: str = "jpg", quality: int = 95) -> dict:
    """Encode to a CompressedImage-shaped dict (``toCompressedImageMsg``,
    cv_bridge.h:111). ``fmt`` is 'jpg' or 'png'; input is RGB (or mono)
    uint8, or mono uint16 for PNG. PNG is written by ``io/png``, JPEG by
    cv2."""
    if fmt not in ("jpg", "jpeg", "png"):
        raise ValueError(f"unsupported compressed format {fmt!r}")
    arr = _numpy(arr)
    if fmt == "png":
        return {"format": fmt, "data": encode_png(np.ascontiguousarray(arr), level=3)}
    cv2 = _cv2("JPEG encoding")
    bgr = arr[..., ::-1] if arr.ndim == 3 else arr
    ok, buf = cv2.imencode("." + fmt, np.ascontiguousarray(bgr), [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise ValueError("encode failed")
    return {"format": fmt, "data": buf.tobytes()}


def compressed_to_array(msg: dict) -> np.ndarray:
    """CompressedImage dict -> numpy array (``toCvCopy`` on compressed
    messages). 3-channel output is RGB; a 4-channel image loses its alpha,
    as cv2's path gives it. PNG bytes that ``io/png`` reads are decoded
    there; anything else by cv2."""
    data = msg["data"]
    img = None
    if data[:8] == SIGNATURE:
        try:
            img = decode_png(data)
        except ValueError:
            img = None  # a PNG kind io/png refuses: cv2 below
    if img is None:
        cv2 = _cv2("decoding a non-PNG compressed image")
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError("decode failed")
        if img.ndim == 3:
            img = img[..., :3][..., ::-1]
    elif img.ndim == 3:
        img = img[..., :3]
    return np.ascontiguousarray(img)


_COLOR_PERMUTES = {
    ("bgr8", "rgb8"): [2, 1, 0],
    ("rgb8", "bgr8"): [2, 1, 0],
    ("bgra8", "rgba8"): [2, 1, 0, 3],
    ("rgba8", "bgra8"): [2, 1, 0, 3],
}

_GRAY_WEIGHTS = {"rgb8": (0.299, 0.587, 0.114), "bgr8": (0.114, 0.587, 0.299)}


def _gray(arr, weights):
    """The JAX module's ``clip(float32(rgb) @ float64(w), 0, 255)`` cast to
    uint8. A tensor goes through numpy on the host and comes back to its
    device: the matmul's summation order is numpy's BLAS's, and it decides
    the grey levels that fall within an ulp of an integer (0.015% of all
    colours), so no device sum reproduces it."""
    if isinstance(arr, torch.Tensor):
        return torch.as_tensor(_gray(_numpy(arr), weights), device=arr.device)
    return np.clip(arr[..., :3].astype(np.float32) @ np.asarray(weights), 0, 255).astype(np.uint8)


def convert_color(arr, src: str, dst: str):
    """cvtColor-equivalent conversions between the registry encodings."""
    if src == dst:
        return arr
    is_t = isinstance(arr, torch.Tensor)
    key = (src, dst)
    if key in _COLOR_PERMUTES:
        return arr[..., _COLOR_PERMUTES[key]]
    if src in _GRAY_WEIGHTS and dst == "mono8":
        return _gray(arr, _GRAY_WEIGHTS[src])
    if src == "mono8" and dst in ("rgb8", "bgr8"):
        return arr[..., None].expand(*arr.shape, 3).contiguous() if is_t else np.repeat(arr[..., None], 3, axis=-1)
    if src == "mono16" and dst == "mono8":
        return (arr.to(torch.int32) >> 8).to(torch.uint8) if is_t else (arr >> 8).astype(np.uint8)
    if src == "mono8" and dst == "mono16":
        return (arr.to(torch.int32) << 8).to(torch.uint16) if is_t else arr.astype(np.uint16) << 8
    # Drop/add alpha.
    if src in ("rgba8", "bgra8") and dst == src[:3] + "8":
        return arr[..., :3]
    if src in ("rgb8", "bgr8") and dst == src[:3] + "a8":
        if is_t:
            return torch.cat([arr, torch.full_like(arr[..., :1], 255)], dim=-1)
        a = np.full(arr.shape[:2] + (1,), 255, np.uint8)
        return np.concatenate([arr, a], axis=-1)
    raise ValueError(f"no conversion {src} -> {dst}")


_SCALED = (np.float32, np.float64, np.uint16, np.int16)
_SCALED_T = (torch.float32, torch.float64, torch.uint16, torch.int16)


def cvt_color_for_display(
    arr,
    src_encoding: str,
    dst_encoding: str = "bgr8",
    *,
    do_dynamic_scaling: bool = False,
    min_image_value: float = 0.0,
    max_image_value: float = 0.0,
):
    """Convert any registry image to a displayable 8-bit color image.

    Capability parity with ``cv_bridge::cvtColorForDisplay``
    (cv_bridge.cpp; API doc in cv_bridge.h:263-299): depth/float images
    are range-scaled to 8 bit (either a fixed [min, max] window or dynamic
    min/max scaling), 32-bit integer images are label maps colorized with
    the named-color table, and everything else goes through
    ``convert_color``. A tensor stays on its device; dynamic scaling reads
    its finite minimum and maximum to the host.
    """
    is_t = isinstance(arr, torch.Tensor)
    if not is_t:
        arr = np.asarray(arr)
    if src_encoding == "32SC1":  # label image -> distinct colors
        return convert_color(label_image_to_rgb8(arr), "rgb8", dst_encoding)
    scaled = arr.dtype in (_SCALED_T if is_t else _SCALED)
    if scaled and arr.ndim == 2:
        floating = arr.dtype in (torch.float32, torch.float64) if is_t else arr.dtype in (np.float32, np.float64)
        finite = torch.isfinite(arr) if is_t else np.isfinite(arr)
        if min_image_value != max_image_value:
            lo, hi = float(min_image_value), float(max_image_value)
        elif do_dynamic_scaling:
            if is_t:
                a = arr.to(torch.float64)
                count = int(finite.sum())
                lo = float(torch.where(finite, a, np.inf).min()) if count else 0.0
                hi = float(torch.where(finite, a, -np.inf).max()) if count else 1.0
            else:
                vals = arr[finite]
                lo = float(vals.min()) if vals.size else 0.0
                hi = float(vals.max()) if vals.size else 1.0
        else:
            # The reference errors here for float input; default depth
            # window of [0, 10] m keeps the call usable headless.
            lo, hi = 0.0, 10.0 if floating else 65535.0
        scale = 255.0 / (hi - lo) if hi > lo else 1.0
        if is_t:
            mono = ((arr.to(torch.float64) - lo) * scale).clamp(0, 255)
            mono = torch.where(finite, torch.round(mono), 0).to(torch.uint8)
        else:
            mono = np.clip((arr.astype(np.float64) - lo) * scale, 0, 255)
            mono = np.where(finite, np.round(mono), 0).astype(np.uint8)
        return convert_color(mono, "mono8", dst_encoding)
    return convert_color(arr, src_encoding, dst_encoding)
