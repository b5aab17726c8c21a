"""Pinhole camera model + depth backprojection on torch tensors.

Counterpart of ``perception_tpu/geometry/camera.py``: the intrinsics
container with its constructors (``from_K``, ``from_camera_info`` with
binning and ROI, the D435 models), ``project`` / ``pixel_to_ray``, the
plumb_bob and rational_polynomial distortion (``unrectify_point``,
``rectify_point``, ``rectify_image``, ``rectify_roi``,
``unrectify_roi``), ``backproject_depth`` and ``depth_from_u16``.

The intrinsics and distortion are kept as Python floats rounded to
float32, so the arithmetic matches the JAX package's float32 leaves;
they enter each computation as tensors on the input's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from perception_tpu_torch._tensor import const

_ZERO_DIST = (0.0,) * 5


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    """Full-resolution sensor description (sensor_msgs/CameraInfo): the
    calibrated intrinsics plus the capture-time binning/ROI state.
    ``PinholeCamera.from_camera_info`` converts this to the operational
    model."""

    K: tuple                      # 9 floats, row-major, FULL resolution
    width: int
    height: int
    D: tuple | None = None        # plumb_bob (5) / rational (8) or None
    binning_x: int = 1
    binning_y: int = 1
    roi: Tuple[int, int, int, int] = (0, 0, 0, 0)  # x_off, y_off, w, h
                                                   # (0,0,0,0) = full


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Intrinsics (float32 values), distortion and image size. ``dist`` is
    plumb_bob ``(k1, k2, p1, p2, k3)`` or rational_polynomial (8 values)."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple = _ZERO_DIST
    width: int = 640
    height: int = 480

    def __post_init__(self):
        for name in ("fx", "fy", "cx", "cy"):
            object.__setattr__(self, name, _f32(getattr(self, name)))
        dist = tuple(_f32(v) for v in np.asarray(self.dist, np.float32).reshape(-1))
        if len(dist) not in (5, 8):
            raise ValueError("dist must be plumb_bob (5) or rational_polynomial (8)")
        object.__setattr__(self, "dist", dist)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_K(cls, K, width: int = 640, height: int = 480, dist=None) -> "PinholeCamera":
        """From a 3x3 (or flat 9) intrinsic matrix."""
        K = np.asarray(K, np.float32).reshape(3, 3)
        return cls(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                   dist=_ZERO_DIST if dist is None else dist, width=width, height=height)

    @classmethod
    def from_camera_info(cls, info: CameraInfo) -> "PinholeCamera":
        """The operational model of a full-resolution CameraInfo with
        binning and ROI (``fromCameraInfo``): the ROI offsets shift the
        principal point, binning divides focal lengths, principal point
        and image size; width/height describe the delivered image."""
        bx = max(info.binning_x, 1)
        by = max(info.binning_y, 1)
        rx, ry, rw, rh = info.roi
        if rw == 0 and rh == 0:          # empty ROI = full resolution
            rw, rh = info.width, info.height
        if rx + rw > info.width or ry + rh > info.height:
            raise ValueError(f"ROI {info.roi} exceeds {info.width}x{info.height}")
        K = np.asarray(info.K, np.float64).reshape(3, 3)
        return cls(
            fx=K[0, 0] / bx, fy=K[1, 1] / by,
            cx=(K[0, 2] - rx) / bx, cy=(K[1, 2] - ry) / by,
            dist=info.D if info.D is not None else _ZERO_DIST,
            width=rw // bx, height=rh // by,
        )

    @classmethod
    def d435_color(cls) -> "PinholeCamera":
        return cls.from_K([616.8246459960938, 0.0, 321.81976318359375,
                           0.0, 616.609375, 239.91116333007812,
                           0.0, 0.0, 1.0])

    @classmethod
    def d435_depth(cls) -> "PinholeCamera":
        return cls.from_K([384.0898742675781, 0.0, 322.4656677246094,
                           0.0, 384.0898742675781, 240.64073181152344,
                           0.0, 0.0, 1.0])

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]], np.float32
        )

    def _intrinsics(self, like: torch.Tensor):
        return const([self.fx, self.fy, self.cx, self.cy], like)

    # -- projection --------------------------------------------------------
    def project(self, points: torch.Tensor) -> torch.Tensor:
        """(..., 3) camera-frame points -> (..., 2) pixels (u, v), no
        distortion; z == 0 gives NaN, so callers mask on z > 0."""
        fx, fy, cx, cy = self._intrinsics(points)
        z = points[..., 2]
        u = fx * points[..., 0] / z + cx
        v = fy * points[..., 1] / z + cy
        return torch.stack([u, v], dim=-1)

    def pixel_to_ray(self, uv: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        """(..., 2) pixels -> (..., 3) rays with z=1, or unit rays."""
        fx, fy, cx, cy = self._intrinsics(uv)
        x = (uv[..., 0] - cx) / fx
        y = (uv[..., 1] - cy) / fy
        ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        if normalize:
            ray = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
        return ray

    # -- distortion (plumb_bob / rational_polynomial) -----------------------
    def _radial(self, r2: torch.Tensor) -> torch.Tensor:
        d = const(list(self.dist), r2)
        k1, k2, k3 = d[0], d[1], d[4]
        num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        if len(self.dist) == 8:
            k4, k5, k6 = d[5], d[6], d[7]
            return num / (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6)))
        return num

    def unrectify_point(self, uv: torch.Tensor) -> torch.Tensor:
        """Apply distortion: ideal pixel -> raw pixel (R = I, P = K)."""
        fx, fy, cx, cy = self._intrinsics(uv)
        x = (uv[..., 0] - cx) / fx
        y = (uv[..., 1] - cy) / fy
        p1, p2 = const([self.dist[2], self.dist[3]], uv)
        r2 = x * x + y * y
        radial = self._radial(r2)
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)

    def rectify_point(self, uv: torch.Tensor, iters: int = 5) -> torch.Tensor:
        """Invert the distortion by ``iters`` fixed-point steps (the
        scheme of cv::undistortPoints, 5 steps as OpenCV)."""
        fx, fy, cx, cy = self._intrinsics(uv)
        x0 = (uv[..., 0] - cx) / fx
        y0 = (uv[..., 1] - cy) / fy
        p1, p2 = const([self.dist[2], self.dist[3]], uv)
        x, y = x0, y0
        for _ in range(iters):
            r2 = x * x + y * y
            radial = self._radial(r2)
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x, y = (x0 - dx) / radial, (y0 - dy) / radial
        return torch.stack([fx * x + cx, fy * y + cy], dim=-1)

    def rectify_image(self, image) -> torch.Tensor:
        """Dense undistortion remap (R = I, P = K): every rectified pixel
        bilinearly samples the raw image at its distorted source
        coordinate (``unrectify_point``); out-of-image sources give 0.
        Accepts (H, W) or (H, W, C) float/uint8; returns float32 on the
        image's device."""
        img = torch.as_tensor(image).to(torch.float32)
        squeeze = img.ndim == 2
        if squeeze:
            img = img[..., None]
        h, w = img.shape[:2]
        vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                                torch.arange(w, dtype=torch.float32, device=img.device), indexing="ij")
        src = self.unrectify_point(torch.stack([uu, vv], dim=-1))
        x, y = src[..., 0], src[..., 1]
        x0 = torch.clamp(torch.floor(x), 0, w - 2).to(torch.int32)
        y0 = torch.clamp(torch.floor(y), 0, h - 2).to(torch.int32)
        fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
        fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
        x0, y0 = x0.long(), y0.long()
        top = img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx
        bot = img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx
        out = top * (1 - fy) + bot * fy
        inb = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1))[..., None]
        out = torch.where(inb, out, torch.zeros((), dtype=out.dtype, device=out.device))
        return out[..., 0] if squeeze else out

    @staticmethod
    def _roi_border(roi, n: int = 16) -> torch.Tensor:
        """16 samples along each edge of an (x, y, w, h) ROI, as (4n, 2)."""
        x, y, w, h = roi
        ts = torch.linspace(0.0, 1.0, n)
        full = lambda v: torch.full((n,), float(v))
        return torch.cat([
            torch.stack([x + ts * w, full(y)], dim=-1),
            torch.stack([x + ts * w, full(y + h)], dim=-1),
            torch.stack([full(x), y + ts * h], dim=-1),
            torch.stack([full(x + w), y + ts * h], dim=-1),
        ], dim=0)

    @staticmethod
    def _bounding_roi(pts: torch.Tensor) -> Tuple[int, int, int, int]:
        x0 = int(torch.floor(pts[:, 0].min()))
        y0 = int(torch.floor(pts[:, 1].min()))
        x1 = int(torch.ceil(pts[:, 0].max()))
        y1 = int(torch.ceil(pts[:, 1].max()))
        return (x0, y0, x1 - x0, y1 - y0)

    def rectify_roi(self, roi) -> Tuple[int, int, int, int]:
        """Raw-image ROI -> the bounding ROI of its rectified border (the
        four edges sampled, since corners alone under-cover barrel
        distortion). Computed on the CPU."""
        return self._bounding_roi(self.rectify_point(self._roi_border(roi)))

    def unrectify_roi(self, roi) -> Tuple[int, int, int, int]:
        """Rectified-image ROI -> bounding raw-image ROI (the inverse walk,
        by the forward distortion)."""
        return self._bounding_roi(self.unrectify_point(self._roi_border(roi)))

    # -- depth backprojection ---------------------------------------------
    def backproject_depth(
        self,
        depth: torch.Tensor,
        min_depth: float = 0.05,
        max_depth: float = 10.0,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Depth image (..., H, W) meters -> (..., H*W, 3) points + (..., H*W) mask.

        Invalid pixels are parked at the origin, as in the JAX package.
        The intrinsics enter as tensors on the depth's device so the
        division is a true float32 division there too."""
        h, w = depth.shape[-2:]
        dev, dt = depth.device, depth.dtype
        vv, uu = torch.meshgrid(
            torch.arange(h, dtype=dt, device=dev),
            torch.arange(w, dtype=dt, device=dev),
            indexing="ij",
        )
        z = depth.reshape(depth.shape[:-2] + (h * w,))
        u = uu.reshape(-1)
        v = vv.reshape(-1)
        valid = torch.isfinite(z) & (z > min_depth) & (z < max_depth)
        z = torch.where(valid, z, torch.zeros((), dtype=dt, device=dev))
        fx, fy, cx, cy = self._intrinsics(depth)
        x = (u - cx) / fx * z
        y = (v - cy) / fy * z
        return torch.stack([x, y, z], dim=-1), valid


def depth_from_u16(depth_u16: np.ndarray, scale: float = 1.0 / 5000.0) -> np.ndarray:
    """TUM-convention uint16 PNG depth -> float32 meters (0 = invalid, NaN).

    TUM RGB-D uses 5000 counts/meter; RealSense uses 1000 (mm). The
    product is float32 × scale, as the JAX package's."""
    d = depth_u16.astype(np.float32) * scale
    d[depth_u16 == 0] = np.nan
    return d
