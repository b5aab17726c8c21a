"""Output savers and senders: only what ``wrapper.Perception`` uses.

Counterpart of part of ``perception_tpu/io/savers.py`` (numpy + stdlib,
``cv2`` imported where a video is written): the OpenPose-style people
JSON, the UDP keypoint sender and the video writer. The COCO helpers,
raw keypoint dumps and heatmap storage are not ported yet.
"""

from __future__ import annotations

import json
import socket
import struct
from pathlib import Path

import numpy as np


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
