"""Output savers and senders (the reference's filestream module).

Counterpart of ``perception_tpu/io/savers.py`` (numpy + stdlib, ``cv2``
imported where a video is written): the OpenPose-style people JSON
(``PeopleJsonSaver``), COCO-format keypoint results and their read side
(``CocoJsonSaver``), raw keypoint dumps (``KeypointSaver``), heatmap float
storage (``HeatMapSaver``), the UDP keypoint sender (``udpSender.cpp``)
and the video writer (``VideoSaver``). The COCO, keypoint and heatmap
helpers take tensors on any device; the files are the JAX functions'
bytes.
"""

from __future__ import annotations

import json
import socket
import struct
from pathlib import Path
from typing import Sequence

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_people_json(path, keypoints: np.ndarray, mask: np.ndarray, part_names=None) -> None:
    """OpenPose-style people JSON: pose_keypoints_2d flat [x, y, score] * P."""
    people = []
    for i in range(len(keypoints)):
        if not bool(mask[i]):
            continue
        people.append({
            "person_id": i,
            "pose_keypoints_2d": np.asarray(keypoints[i]).reshape(-1).astype(float).tolist(),
        })
    doc = {"version": 1.3, "people": people}
    if part_names:
        doc["part_names"] = list(part_names)
    Path(path).write_text(json.dumps(doc))


# BODY_135 block offsets (topologies.BODY_135_PARTS layout = reference
# poseParametersRender.hpp:186-187): 25 body, 2x20 hands, 70 face.
_H135, _F135 = 25, 65


# Model-part -> COCO-order index maps, by (format, number of body
# parts), transcribed from the reference's CocoJsonSaver
# (cocoJsonSaver.cpp:98-181). "body" emits the 17 COCO keypoints,
# "foot" the 6 foot keypoints, "face" 68, "hand21"/"hand42" the
# right / left+right hand sets (BODY_135 only), "car" the car-dataset
# variants (CAR_12 / CAR_22).
def coco_order_indexes(num_parts: int, fmt: str = "body", variant: int = 0) -> list:
    if fmt == "body":
        if num_parts == 23:
            return [0, 14, 13, 16, 15, 4, 1, 5, 2, 6, 3, 10, 7, 11, 8, 12, 9]
        if num_parts == 18:
            return [0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10]
        if num_parts in (19, 25, 59):
            return [0, 16, 15, 18, 17, 5, 2, 6, 3, 7, 4, 12, 9, 13, 10, 14, 11]
        if num_parts == 135 or num_parts == 17:  # BODY_25B/BODY_135 lead with COCO-17
            return list(range(17))
        # Models without a COCO-17 mapping (e.g. the MPI-15 fixture)
        # emit all parts in model order, round-trippable via
        # coco_results_to_keypoints.
        return list(range(num_parts))
    elif fmt == "foot":
        if num_parts == 25 or num_parts > 60:
            return [19, 20, 21, 22, 23, 24]
        if num_parts == 23:
            return [17, 18, 19, 20, 21, 22]
    elif fmt == "face":
        if num_parts == 135:
            return list(range(_F135, _F135 + 68))
    elif fmt == "hand21":
        if num_parts == 135:
            return [10] + list(range(_H135 + 20, _H135 + 40))
    elif fmt == "hand42":
        if num_parts == 135:
            return ([9] + list(range(_H135, _H135 + 20))
                    + [10] + list(range(_H135 + 20, _H135 + 40)))
    elif fmt == "car":
        if num_parts == 12:
            return [0, 1, 2, 3, 4, 5, 6, 7, 8, 8, 9, 10, 11, 11]
        if num_parts == 22:
            if variant == 0:
                return [0, 1, 2, 3, 6, 7, 12, 13, 14, 15, 16, 17]
            if variant == 1:
                return [0, 1, 2, 3, 6, 7, 12, 13, 14, 15, 20, 21]
            if variant == 2:
                return list(range(20))
    raise ValueError(f"no COCO {fmt!r} mapping for {num_parts} parts")


def coco_keypoint_results(
    image_ids: Sequence[int],
    keypoints_batch,
    masks_batch,
    scores_batch,
    category_id: int = 1,
    fmt: str = "body",
    variant: int = 0,
) -> list:
    """COCO results-format list: one entry per detected person with
    keypoints [x1, y1, v1, ...] and a detection score (CocoJsonSaver).

    ``fmt``/``variant`` select the reference's foot/face/hand/car
    output variants (cocoJsonSaver.cpp:98-181): model keypoints are
    subset/reordered into the target dataset's keypoint order. Each
    batch is read to the host once."""
    out = []
    for img_id, kps, mask, scores in zip(image_ids, keypoints_batch, masks_batch, scores_batch):
        kps, mask, scores = _numpy(kps), _numpy(mask), _numpy(scores)
        for i in range(len(kps)):
            if not bool(mask[i]):
                continue
            kp = kps[i]  # (P, 3)
            order = coco_order_indexes(kp.shape[0], fmt, variant)
            coco_kp = []
            for p in order:
                v = 2 if kp[p, 2] > 0 else 0
                coco_kp.extend([float(kp[p, 0]), float(kp[p, 1]), v])
            out.append({
                "image_id": int(img_id),
                "category_id": category_id,
                "keypoints": coco_kp,
                "score": float(scores[i]),
            })
    return out


def save_coco_json(path, results: list) -> None:
    Path(path).write_text(json.dumps(results))


def load_coco_json(path) -> list:
    return json.loads(Path(path).read_text())


def coco_results_to_keypoints(results: list):
    """Inverse of ``coco_keypoint_results``: official COCO keypoint
    results -> {image_id: (keypoints (N, P, 2), visible (N, P) bool,
    scores (N,))}, numpy: the read side of the eval round trip."""
    by_image: dict = {}
    for r in results:
        kp = np.asarray(r["keypoints"], np.float32).reshape(-1, 3)
        by_image.setdefault(int(r["image_id"]), []).append(
            (kp[:, :2], kp[:, 2] > 0, float(r["score"]))
        )
    out = {}
    for img_id, people in by_image.items():
        out[img_id] = (
            np.stack([p[0] for p in people]),
            np.stack([p[1] for p in people]),
            np.asarray([p[2] for p in people], np.float32),
        )
    return out


def save_keypoints_npy(path, keypoints) -> None:
    np.save(path, _numpy(keypoints))


def save_heatmaps(path, heatmaps) -> None:
    """Float heatmap storage (the reference writes float PNGs; npz is
    the lossless equivalent)."""
    np.savez_compressed(path, heatmaps=np.asarray(_numpy(heatmaps), np.float32))


def load_heatmaps(path) -> np.ndarray:
    return np.load(path)["heatmaps"]


class UdpSender:
    """Joint/pose UDP sender (udpSender.cpp semantics): datagrams of
    float32 payloads with a small header, fire-and-forget."""

    MAGIC = b"PTPU"

    def __init__(self, host: str = "127.0.0.1", port: int = 5005):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.seq = 0

    def send_array(self, arr: np.ndarray, tag: int = 0) -> int:
        payload = np.asarray(arr, np.float32).tobytes()
        header = self.MAGIC + struct.pack("<IIH", self.seq, len(payload), tag)
        n = self.sock.sendto(header + payload, self.addr)
        self.seq += 1
        return n

    @staticmethod
    def parse(datagram: bytes):
        magic = datagram[:4]
        if magic != UdpSender.MAGIC:
            raise ValueError("bad magic")
        seq, length, tag = struct.unpack("<IIH", datagram[4:14])
        arr = np.frombuffer(datagram[14 : 14 + length], np.float32)
        return seq, tag, arr

    def close(self) -> None:
        self.sock.close()


class VideoWriter:
    """cv2-backed video sink (VideoSaver equivalent)."""

    def __init__(self, path, fps: float = 30.0, fourcc: str = "mp4v"):
        import cv2

        self.path = str(path)
        self.fps = fps
        self.fourcc = cv2.VideoWriter_fourcc(*fourcc)
        self.writer = None

    def write(self, frame_rgb: np.ndarray) -> None:
        import cv2

        if self.writer is None:
            h, w = frame_rgb.shape[:2]
            self.writer = cv2.VideoWriter(self.path, self.fourcc, self.fps, (w, h))
        self.writer.write(frame_rgb[..., ::-1])  # RGB -> BGR

    def close(self) -> None:
        if self.writer is not None:
            self.writer.release()
