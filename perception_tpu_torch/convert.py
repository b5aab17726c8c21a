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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


def posenet_from_flax(params: dict, net: PoseNet, device="cuda") -> dict:
    """A flax ``PoseNet`` variable tree -> ``net``'s state dict on ``device``.

    ``ConvBlock_i`` is ``backbone[i]`` and the last one ``features``;
    ``Stage_s/Conv_j`` is ``stages[s].convs[j]`` for j below the stage
    depth, then ``mix``, ``paf`` and ``hm``.
    """
    tree = params["params"]
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
    flat = {f"{outer}/{inner}": leaf for outer, sub in tree.items() for inner, leaf in sub.items()}
    return _conv_state(flat, names, device)


def facenet_from_flax(params: dict, net: FaceLandmarkNet, device="cuda") -> dict:
    """A flax ``FaceLandmarkNet`` (or ``HandLandmarkNet``) variable tree ->
    ``net``'s state dict: ``Conv_0`` to ``Conv_4`` are ``convs``, ``Conv_5``
    the ``head``."""
    n = len(net.convs)
    names = {f"convs.{j}": f"Conv_{j}" for j in range(n)}
    names["head"] = f"Conv_{n}"
    return _conv_state(params["params"], names, device)


def handnet_from_flax(params: dict, net: HandLandmarkNet, device="cuda") -> dict:
    """A flax ``HandLandmarkNet`` variable tree -> ``net``'s state dict (the
    face landmark net's layout)."""
    return facenet_from_flax(params, net, device)


def face_detector_from_flax(params: dict, net: FaceDetectorNet, device="cuda") -> dict:
    """A flax ``FaceDetectorNet`` variable tree -> ``net``'s state dict:
    ``Conv_0`` to ``Conv_3`` are ``convs``, ``Conv_4`` ``heat``, ``Conv_5``
    ``size``."""
    n = len(net.convs)
    names = {f"convs.{j}": f"Conv_{j}" for j in range(n)}
    names.update(heat=f"Conv_{n}", size=f"Conv_{n + 1}")
    return _conv_state(params["params"], names, device)


def au_head_from_flax(params: dict, net: ActionUnitHead, device="cuda") -> dict:
    """A flax ``ActionUnitHead`` variable tree -> ``net``'s state dict:
    ``Dense_0`` is ``hidden``, ``Dense_1`` ``intensity``, ``Dense_2``
    ``presence``."""
    names = {"hidden": "Dense_0", "intensity": "Dense_1", "presence": "Dense_2"}
    return _conv_state(params["params"], names, device)
