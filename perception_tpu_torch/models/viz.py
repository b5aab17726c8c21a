"""Debug visualization: overlays, depth colouring and the 3-D viewer.

Counterpart of ``perception_tpu/models/viz.py`` (the reference renders on
the GPU in ``renderPose.cu`` and in rviz; these are headless equivalents
that draw into RGB images for savers and video output).

* ``depth_to_vis`` colours depth with OpenCV's TURBO map, stored here as a
  256 x 3 table (``TURBO_RGB``, equal to ``cv2.applyColorMap(...,
  COLORMAP_TURBO)`` on every grey level), gathered on the depth's device.
* ``render_points_3d`` is the z-buffered point splatter on tensors, on the
  points' device: a ``scatter_reduce(amin)`` z-buffer over each point's
  patch in place of the JAX function's Python loop over points.
  ``render_points_3d_reference`` is the JAX function copied as it is
  (numpy, the loop), the plain version it is held against.
* The line and circle overlays (``draw_skeletons``, ``draw_bbox_2d``,
  ``draw_cuboid_bbox``, ``landmarks_overlay``, the viewer's ``edges``,
  ``render_body_model``'s skeleton) draw through cv2, imported on use, as
  the JAX functions do; they take numpy arrays or tensors and return numpy
  images.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

# A simple color cycle for person ids.
_COLORS = np.array(
    [
        (255, 80, 80), (80, 255, 80), (80, 120, 255), (255, 200, 60),
        (200, 80, 255), (60, 220, 220), (255, 140, 40), (150, 255, 100),
    ],
    np.uint8,
)

# cv2.COLORMAP_TURBO at grey levels 0..255, as RGB (OpenCV's colormap.cpp table).
_TURBO_HEX = """
    30123B 321543 33184A 341B51 351E58 36215F 372466 38276D 392A73 3A2D79 3B2F80 3C3286
    3D358B 3E3891 3F3B97 3F3E9C 4040A2 4143A7 4146AC 4249B1 424BB5 434EBA 4451BF 4454C3
    4456C7 4559CB 455CCF 455ED3 4661D6 4664DA 4666DD 4669E0 466BE3 476EE6 4771E9 4773EB
    4776EE 4778F0 477BF2 467DF4 4680F6 4682F8 4685FA 4687FB 458AFC 458CFD 448FFE 4391FE
    4294FF 4196FF 4099FF 3E9BFE 3D9EFE 3BA0FD 3AA3FC 38A5FB 37A8FA 35ABF8 33ADF7 31AFF5
    2FB2F4 2EB4F2 2CB7F0 2AB9EE 28BCEB 27BEE9 25C0E7 23C3E4 22C5E2 20C7DF 1FC9DD 1ECBDA
    1CCDD8 1BD0D5 1AD2D2 1AD4D0 19D5CD 18D7CA 18D9C8 18DBC5 18DDC2 18DEC0 18E0BD 19E2BB
    19E3B9 1AE4B6 1CE6B4 1DE7B2 1FE9AF 20EAAC 22EBAA 25ECA7 27EEA4 2AEFA1 2CF09E 2FF19B
    32F298 35F394 38F491 3CF58E 3FF68A 43F787 46F884 4AF880 4EF97D 52FA7A 55FA76 59FB73
    5DFC6F 61FC6C 65FD69 69FD66 6DFE62 71FE5F 75FE5C 79FE59 7DFF56 80FF53 84FF51 88FF4E
    8BFF4B 8FFF49 92FF47 96FE44 99FE42 9CFE40 9FFD3F A1FD3D A4FC3C A7FC3A A9FB39 ACFB38
    AFFA37 B1F936 B4F836 B7F735 B9F635 BCF534 BEF434 C1F334 C3F134 C6F034 C8EF34 CBED34
    CDEC34 D0EA34 D2E935 D4E735 D7E535 D9E436 DBE236 DDE037 DFDF37 E1DD37 E3DB38 E5D938
    E7D739 E9D539 EBD339 ECD13A EECF3A EFCD3A F1CB3A F2C93A F4C73A F5C53A F6C33A F7C13A
    F8BE39 F9BC39 FABA39 FBB838 FBB637 FCB336 FCB136 FDAE35 FDAC34 FEA933 FEA732 FEA431
    FEA130 FE9E2F FE9B2D FE992C FE962B FE932A FE9029 FD8D27 FD8A26 FC8725 FC8423 FB8122
    FB7E21 FA7B1F F9781E F9751D F8721C F76F1A F66C19 F56918 F46617 F36315 F26014 F15D13
    F05B12 EF5811 ED5510 EC530F EB500E EA4E0D E84B0C E7490C E5470B E4450A E2430A E14109
    DF3F08 DD3D08 DC3B07 DA3907 D83706 D63506 D43305 D23105 D02F05 CE2D04 CC2B04 CA2A04
    C82803 C52603 C32503 C12302 BE2102 BC2002 B91E02 B71D02 B41B01 B21A01 AF1801 AC1701
    A91601 A71401 A41301 A11201 9E1001 9B0F01 980E01 950D01 920B01 8E0A01 8B0902 880802
    850702 810602 7E0502 7A0403
"""
TURBO_RGB = np.array([[int(h[i : i + 2], 16) for i in (0, 2, 4)] for h in _TURBO_HEX.split()], np.uint8)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _draw_line(img, p0, p1, color, thickness=2):
    import cv2

    cv2.line(img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])),
             tuple(int(c) for c in color), thickness, cv2.LINE_AA)


def draw_skeletons(
    image,
    keypoints,   # (P_people, P_parts, 3)
    mask,        # (P_people,)
    limb_pairs,  # (L, 2)
    ids=None,
) -> np.ndarray:
    """Render skeletons onto a copy of ``image`` (renderPose analog)."""
    import cv2

    out = np.ascontiguousarray(_numpy(image).copy())
    keypoints, mask, limb_pairs = _numpy(keypoints), _numpy(mask), _numpy(limb_pairs)
    ids = None if ids is None else _numpy(ids)
    for pi in range(len(keypoints)):
        if not bool(mask[pi]):
            continue
        color = _COLORS[(int(ids[pi]) if ids is not None else pi) % len(_COLORS)]
        kp = keypoints[pi]
        for a, b in limb_pairs:
            if kp[a, 2] > 0 and kp[b, 2] > 0:
                _draw_line(out, kp[a], kp[b], color)
        for p in range(kp.shape[0]):
            if kp[p, 2] > 0:
                cv2.circle(out, (int(kp[p, 0]), int(kp[p, 1])), 3,
                           tuple(int(c) for c in color), -1, cv2.LINE_AA)
    return out


def draw_bbox_2d(image, rect, color=(0, 255, 0)) -> np.ndarray:
    import cv2

    out = np.ascontiguousarray(_numpy(image).copy())
    rect = _numpy(rect)
    cv2.rectangle(out, (int(rect[0]), int(rect[1])), (int(rect[2]), int(rect[3])),
                  color, 2)
    return out


def draw_cuboid_bbox(
    image,
    bbox_uv,   # (8, 2) projected cuboid vertices
    edges,     # (12, 2) vertex index pairs
    color=(0, 255, 0),
) -> np.ndarray:
    """The draw_bbox.py overlay: 12 cuboid edges in image space."""
    out = np.ascontiguousarray(_numpy(image).copy())
    bbox_uv = _numpy(bbox_uv)
    for a, b in _numpy(edges):
        _draw_line(out, bbox_uv[a], bbox_uv[b], color)
    return out


def depth_to_vis(depth, max_depth: float = 5.0):
    """Depth (H, W) -> TURBO color visualization (H, W, 3) uint8 RGB.

    A tensor stays on its device (the table is gathered there) and a numpy
    array gives a numpy image; both give the JAX function's bytes. The
    division is by a tensor on the depth's device: PyTorch's CUDA division
    by a host scalar multiplies by its reciprocal, which rounds
    differently."""
    if not isinstance(depth, torch.Tensor):
        d = np.nan_to_num(np.asarray(depth), nan=0.0)
        gray = (np.clip(d / max_depth, 0, 1) * 255).astype(np.uint8)
        return TURBO_RGB[gray]
    d = torch.nan_to_num(depth, nan=0.0)
    norm = (d / torch.full((), max_depth, dtype=d.dtype, device=d.device)).clamp(0, 1)
    gray = (norm * 255).to(torch.uint8)
    return torch.as_tensor(TURBO_RGB, device=d.device)[gray.long()]


def _look_at(eye, target) -> np.ndarray:
    """The viewer's world -> camera rotation rows (right, up, forward):
    camera z toward ``target``, y-ish down like optical frames. float64
    numpy, as the JAX function computes it."""
    eye_v = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye_v
    fwd /= np.linalg.norm(fwd) + 1e-12
    up_hint = np.array([0.0, 1.0, 0.0]) if abs(fwd[1]) < 0.95 else np.array([0.0, 0.0, 1.0])
    right = np.cross(up_hint, fwd)
    right /= np.linalg.norm(right) + 1e-12
    up = np.cross(fwd, right)
    return np.stack([right, up, fwd])


def render_points_3d(
    points,                        # (N, 3) tensor or array
    colors=None,                   # (N, 3) uint8 or None
    mask=None,
    size: Tuple[int, int] = (480, 640),
    eye: Tuple[float, float, float] = (0.0, -0.4, -0.8),
    target: Tuple[float, float, float] = (0.0, 0.0, 0.8),
    fov_deg: float = 60.0,
    point_px: int = 2,
    edges=None,                    # (E, 2) index pairs drawn as lines
    background: int = 16,
):
    """Offscreen 3-D point/edge renderer, the headless stand-in for the
    reference's OpenGL viewer (``gui/gui3D.cpp``) and rviz cloud display:
    a look-at camera and z-buffered point splatting. Returns an (H, W, 3)
    uint8 RGB image: a tensor on the points' device for tensor points, a
    numpy image for numpy points.

    The view transform and projection are float64 as in the JAX function,
    so ``torch.round`` and ``np.round`` (both half to even) pick the same
    pixels. Each kept point covers the ``(2r+1)^2`` patch around its pixel
    (r = point_px // 2); a ``scatter_reduce(amin)`` over all patches builds
    the z-buffer, and each pixel takes the colour of the point whose z
    equals its minimum. Where two points tie exactly on the minimum, the
    lowest point index wins; the JAX function paints in numpy's unstable
    ``argsort(-z)`` order, so the two differ only where tied points have
    different colours.
    """
    is_t = isinstance(points, torch.Tensor)
    dev = points.device if is_t else torch.device("cpu")
    h, w = size
    pts = torch.as_tensor(points, device=dev).to(torch.float64).reshape(-1, 3)
    n = pts.shape[0]
    keep = torch.as_tensor(mask, device=dev).to(torch.bool) if mask is not None else torch.isfinite(pts).all(dim=1)
    if colors is None:
        # Color by depth (z) for shape cues.
        zc = pts[:, 2]
        nan = torch.isnan(zc)
        lo = torch.where(nan, math.inf, zc).min()
        hi = torch.where(nan, -math.inf, zc).max()
        zn = (zc - lo) / torch.clamp(hi - lo, min=1e-9)
        colors = torch.stack([255 * (1 - zn), 80 + 0 * zn, 255 * zn], dim=-1).to(torch.uint8)
    else:
        colors = torch.as_tensor(colors, device=dev).to(torch.uint8)

    eye_v = torch.as_tensor(np.asarray(eye, np.float64), device=dev)
    R = _look_at(eye, target)
    d = pts - eye_v
    # (pts - eye) @ R.T as three products summed left to right. numpy's BLAS
    # may sum in another order and move a coordinate by an ulp; that changes
    # a pixel only at an exact .5 or a z-tie within an ulp.
    cam = [(d[:, 0] * float(r[0]) + d[:, 1] * float(r[1])) + d[:, 2] * float(r[2]) for r in R]

    f = 0.5 * w / np.tan(np.deg2rad(fov_deg) / 2)
    z = cam[2]
    keep = keep & (z > 1e-6)
    zs = torch.where(keep, z, 1.0)
    u = torch.where(keep, f * cam[0] / zs + w / 2, -1.0)
    v = torch.where(keep, f * cam[1] / zs + h / 2, -1.0)
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    inb = keep & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)

    r = max(int(point_px) // 2, 0)
    off = torch.arange(-r, r + 1, device=dev)
    px = ui[:, None, None] + off[None, None, :]          # (N, 1, 2r+1)
    py = vi[:, None, None] + off[None, :, None]          # (N, 2r+1, 1)
    ok = inb[:, None, None] & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    dump = h * w                                         # patches off the image land here
    pix = torch.where(ok, py * w + px, dump).reshape(-1)
    zp = z[:, None, None].expand(ok.shape).reshape(-1)
    zbuf = torch.full((dump + 1,), math.inf, dtype=torch.float64, device=dev)
    zbuf.scatter_reduce_(0, pix, zp, "amin")
    hit = (pix != dump) & (zp == zbuf[pix])
    ids = torch.arange(n, device=dev)[:, None, None].expand(ok.shape).reshape(-1)
    winner = torch.full((dump + 1,), n, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, torch.where(hit, pix, dump), ids, "amin")
    winner = winner[:dump]
    palette = torch.cat([colors, torch.full((1, 3), background, dtype=torch.uint8, device=dev)])
    img = palette[winner].reshape(h, w, 3)

    if edges is not None:
        host = np.ascontiguousarray(img.cpu().numpy())
        uh, vh, bh = ui.cpu().numpy(), vi.cpu().numpy(), inb.cpu().numpy()
        for a, b in _numpy(edges):
            if bh[a] and bh[b]:
                _draw_line(host, (uh[a], vh[a]), (uh[b], vh[b]), (255, 255, 255), 1)
        img = torch.as_tensor(host, device=dev)
    return img if is_t else img.numpy()


def render_points_3d_reference(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
    size: Tuple[int, int] = (480, 640),
    eye: Tuple[float, float, float] = (0.0, -0.4, -0.8),
    target: Tuple[float, float, float] = (0.0, 0.0, 0.8),
    fov_deg: float = 60.0,
    point_px: int = 2,
    edges: Optional[np.ndarray] = None,
    background: int = 16,
) -> np.ndarray:
    """The JAX package's ``render_points_3d`` as it is (numpy, a Python
    loop over the points far to near): the plain version of
    ``render_points_3d``."""
    h, w = size
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if mask is not None:
        keep = np.asarray(mask, bool)
    else:
        keep = np.isfinite(pts).all(axis=1)
    if colors is None:
        zc = pts[:, 2]
        zn = (zc - np.nanmin(zc)) / max(np.nanmax(zc) - np.nanmin(zc), 1e-9)
        colors = np.stack([255 * (1 - zn), 80 + 0 * zn, 255 * zn], axis=-1).astype(np.uint8)

    eye_v = np.asarray(eye, np.float64)
    cam = (pts - eye_v) @ _look_at(eye, target).T

    f = 0.5 * w / np.tan(np.deg2rad(fov_deg) / 2)
    z = cam[:, 2]
    keep = keep & (z > 1e-6)
    u = np.where(keep, f * cam[:, 0] / np.where(keep, z, 1.0) + w / 2, -1)
    v = np.where(keep, f * cam[:, 1] / np.where(keep, z, 1.0) + h / 2, -1)

    img = np.full((h, w, 3), background, np.uint8)
    zbuf = np.full((h, w), np.inf, np.float64)

    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    inb = keep & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    idx = np.flatnonzero(inb)
    # Far-to-near painter order, then z-test for exactness on ties.
    order = idx[np.argsort(-z[idx])]
    r = max(int(point_px) // 2, 0)
    for i in order:
        y0, y1 = max(vi[i] - r, 0), min(vi[i] + r + 1, h)
        x0, x1 = max(ui[i] - r, 0), min(ui[i] + r + 1, w)
        patch = zbuf[y0:y1, x0:x1]
        m = z[i] < patch
        patch[m] = z[i]
        img[y0:y1, x0:x1][m] = colors[i]

    if edges is not None:
        for a, b in np.asarray(edges):
            if inb[a] and inb[b]:
                _draw_line(img, (ui[a], vi[a]), (ui[b], vi[b]), (255, 255, 255), 1)
    return img


def landmarks_overlay(image, landmarks, mask, color=(60, 220, 60)) -> np.ndarray:
    import cv2

    out = np.ascontiguousarray(_numpy(image).copy())
    landmarks, mask = _numpy(landmarks), _numpy(mask)
    for i in range(len(landmarks)):
        if bool(mask[i]):
            cv2.circle(out, (int(landmarks[i, 0]), int(landmarks[i, 1])), 2, color, -1)
    return out


def render_body_model(
    joints,                           # (J, 3) posed joint positions (m)
    parents,                          # (J,) kinematic-tree parents (-1 root)
    size: Tuple[int, int] = (480, 640),
    bone_radius: float = 0.045,       # capsule radius (m)
    samples_per_bone: int = 96,
    eye: Tuple[float, float, float] = (0.0, -0.5, -1.2),
    target: Optional[Tuple[float, float, float]] = None,
):
    """Render a fitted kinematic body model as capsule limbs, the headless
    equivalent of the reference's Adam body-model viewer
    (``gui/guiAdam.cpp``). Consumes ``models/body_fit.BodyFitResult.joints``
    and the ``BodyModel.parents`` tree: each bone becomes a ring-sampled
    capsule cloud (``np.random.RandomState(0)``, the JAX function's own
    stream, so both sample the same cloud), z-buffered through
    :func:`render_points_3d` on the joints' device, with the skeleton edges
    overlaid by cv2. Returns a tensor for tensor joints, else numpy."""
    dev = joints.device if isinstance(joints, torch.Tensor) else None
    joints = _numpy(joints).astype(np.float64)
    parents = _numpy(parents)
    if target is None:
        target = tuple(joints.mean(axis=0))

    rng = np.random.RandomState(0)
    pts, cols = [], []
    palette = np.asarray(_COLORS, np.uint8)
    for j in range(1, len(parents)):
        a, b = joints[parents[j]], joints[j]
        t = np.linspace(0.0, 1.0, samples_per_bone)[:, None]
        axis = b - a
        # Ring offsets perpendicular to the bone: capsule surface dots.
        n = axis / (np.linalg.norm(axis) + 1e-9)
        u = np.cross(n, [0.0, 0.0, 1.0])
        if np.linalg.norm(u) < 1e-6:
            u = np.cross(n, [0.0, 1.0, 0.0])
        u /= np.linalg.norm(u) + 1e-9
        v = np.cross(n, u)
        phi = rng.rand(samples_per_bone) * 2 * np.pi
        rad = bone_radius * np.sqrt(rng.rand(samples_per_bone))
        ring = (np.cos(phi)[:, None] * u + np.sin(phi)[:, None] * v) * rad[:, None]
        pts.append(a + t * axis + ring)
        cols.append(np.repeat(palette[j % len(palette)][None], samples_per_bone, 0))
    cloud = np.concatenate(pts, axis=0)
    colors = np.concatenate(cols, axis=0)

    # Append the joints themselves so skeleton edges index them directly.
    base = len(cloud)
    cloud = np.concatenate([cloud, joints], axis=0)
    colors = np.concatenate([colors, np.full((len(joints), 3), 255, np.uint8)], axis=0)
    edges = np.asarray([[base + parents[j], base + j] for j in range(1, len(parents))])
    if dev is not None:
        cloud, colors = torch.as_tensor(cloud, device=dev), torch.as_tensor(colors, device=dev)
    return render_points_3d(cloud, colors=colors, size=size, eye=eye, target=target, point_px=3, edges=edges)
