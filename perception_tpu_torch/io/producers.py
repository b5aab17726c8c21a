"""Frame producers: only what ``wrapper.Perception`` uses.

Counterpart of part of ``perception_tpu/io/producers.py``: the video
file reader (``cv2``, imported on use), the sorted image-directory
reader and ``paced``, the fps-keeping wrapper. Each yields (timestamp,
RGB uint8 frame).
"""

from __future__ import annotations

import glob
import time
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np


class VideoReader:
    """cv2-backed video file reader (VideoReader equivalent)."""

    def __init__(self, path, rotation: int = 0):
        import cv2

        self.cap = cv2.VideoCapture(str(path))
        if not self.cap.isOpened():
            raise FileNotFoundError(path)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.rotation = rotation

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        import cv2

        t = 0.0
        while True:
            ok, bgr = self.cap.read()
            if not ok:
                break
            rgb = bgr[..., ::-1]
            if self.rotation:
                rgb = np.rot90(rgb, self.rotation // 90)
            yield t, np.ascontiguousarray(rgb)
            t += 1.0 / self.fps

    def close(self) -> None:
        self.cap.release()


class ImageDirectoryReader:
    """Sorted image-directory stream (OpenPose's ImageDirectoryReader).

    The JAX package reads ahead through its native prefetch ring
    (``runtime.FramePrefetcher``), which is not ported; this reader
    decodes the files one after another and yields the same frames, with
    the same indices as timestamps (an unreadable file is skipped)."""

    def __init__(self, directory, pattern: str = "*.png"):
        self.paths = sorted(glob.glob(str(Path(directory) / pattern)))

    def __len__(self) -> int:
        return len(self.paths)

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        import cv2

        for i, p in enumerate(self.paths):
            img = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            if img is None:
                continue
            if img.ndim == 3:
                img = img[..., ::-1]
            yield float(i), np.ascontiguousarray(img)


def paced(frames, target_fps: float, drop: bool = True):
    """fps-keeping wrapper over a (timestamp, frame) iterator.

    The reference ``Producer`` paces reads to the source fps and drops
    frames when the consumer lags (producer.cpp fps-keeping). For
    faster-than-real-time sources (directory/video decode) this sleeps
    to hold ``target_fps``; when the consumer is slower than the
    target and ``drop`` is set, backlogged frames are skipped so the
    stream stays live instead of drifting behind.
    """
    period = 1.0 / float(target_fps)
    t_next = None
    for t, frame in frames:
        now = time.monotonic()
        if t_next is None:
            t_next = now
        if now < t_next:
            time.sleep(t_next - now)
        elif drop and now - t_next > period:
            # Consumer lagged more than one period: drop this frame to
            # catch up (count full periods missed).
            missed = int((now - t_next) / period)
            t_next += period * missed
            if missed > 0:
                continue
        t_next += period
        yield t, frame
