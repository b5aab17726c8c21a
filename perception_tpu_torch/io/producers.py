"""Frame producers: video, webcam, IP camera, FLIR rig, image directory.

Counterpart of ``perception_tpu/io/producers.py``: the video file, webcam
and IP-camera readers (``cv2``, imported on use), the FLIR / Point Grey
rig reader (the Spinnaker SDK's ``PySpin``, imported on use), the sorted
image-directory reader (PNG through the port's own codec, any other file
through cv2, read ahead by the native prefetcher) and ``paced``, the
fps-keeping wrapper. Each yields (timestamp, frame) with RGB uint8
frames; importing this module needs neither cv2 nor PySpin.
"""

from __future__ import annotations

import glob
import time
import warnings
import zlib
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


class WebcamReader(VideoReader):
    """Live camera (WebcamReader equivalent; index instead of path)."""

    def __init__(self, index: int = 0, width: int = 640, height: int = 480):
        import cv2

        self.cap = cv2.VideoCapture(index)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open camera {index}")
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.rotation = 0

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        while True:
            ok, bgr = self.cap.read()
            if not ok:
                break
            yield time.time(), np.ascontiguousarray(bgr[..., ::-1])


class IpCameraReader(VideoReader):
    """RTSP/HTTP stream reader (IpCameraReader equivalent,
    ``producer/ipCameraReader.cpp``). cv2 speaks both protocols; frames
    are timestamped with wall clock like the webcam path."""

    def __init__(self, url: str, rotation: int = 0):
        import cv2

        self.cap = cv2.VideoCapture(url)
        if not self.cap.isOpened():
            raise ConnectionError(f"cannot open stream {url}")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.rotation = rotation

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        while True:
            ok, bgr = self.cap.read()
            if not ok:
                break
            rgb = bgr[..., ::-1]
            if self.rotation:
                rgb = np.rot90(rgb, self.rotation // 90)
            yield time.time(), np.ascontiguousarray(rgb)


class FlirReader:
    """Point Grey / FLIR stereo rig capture (FlirReader +
    SpinnakerWrapper equivalent, ``producer/spinnakerWrapper.cpp``).

    The Spinnaker SDK ships as the vendor package ``PySpin``; without it
    construction raises a RuntimeError naming it (the reference likewise
    compiles the wrapper out unless ``WITH_FLIR_CAMERA`` is set). With
    PySpin, frames from all cameras on the bus come back together
    (hardware trigger assumed configured)."""

    def __init__(self, camera_params=None, undistort: bool = True):
        try:
            import PySpin  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "FlirReader requires the Spinnaker SDK (PySpin); "
                "not available in this environment"
            ) from e
        self._system = PySpin.System.GetInstance()
        self._cams = self._system.GetCameras()
        if self._cams.GetSize() == 0:
            raise RuntimeError("no FLIR cameras on the bus")
        for cam in self._cams:
            cam.Init()
            cam.BeginAcquisition()
        self.camera_params = camera_params
        self.undistort = undistort

    def frames(self) -> Iterator[Tuple[float, list]]:
        while True:
            views = []
            for cam in self._cams:
                img = cam.GetNextImage()
                arr = np.asarray(img.GetNDArray())
                img.Release()
                views.append(arr)
            yield time.time(), views

    def close(self) -> None:
        for cam in self._cams:
            cam.EndAcquisition()
            cam.DeInit()
        self._cams.Clear()
        self._system.ReleaseInstance()


def decode_frame(raw: bytes, path) -> np.ndarray | None:
    """One file's bytes as the JAX reader decodes them
    (``cv2.imdecode(IMREAD_UNCHANGED)``, channels reversed: RGB for colour
    files, cv2's BGRA -> ARGB for four channels). A PNG that ``io/png``
    reads goes through it; any other file, and the PNG kinds it refuses
    (interlaced, palette, gray+alpha, sub-byte), through cv2, imported on
    use. None where cv2 cannot decode the bytes either; a RuntimeError
    naming ``path`` where cv2 is needed and not installed."""
    from perception_tpu_torch.io.png import decode_png

    try:
        img = decode_png(raw)
    except (ValueError, zlib.error):
        img = None
    if img is not None:
        return img[..., [3, 0, 1, 2]] if img.ndim == 3 and img.shape[-1] == 4 else img
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"cannot decode {path}: io/png does not read it and cv2 is not installed") from e
    img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_UNCHANGED) if raw else None
    if img is None:
        return None
    return img[..., ::-1] if img.ndim == 3 else img


class ImageDirectoryReader:
    """Sorted image-directory stream (OpenPose's ImageDirectoryReader) with
    the JAX reader's frames (``decode_frame``) and the file's index as its
    timestamp. With ``prefetch`` the native prefetcher
    (``runtime.FramePrefetcher``) reads the files ahead on its threads;
    decoding stays on the caller's thread. A file that neither io/png nor
    cv2 can decode is skipped with a warning, as the JAX reader skips it;
    where cv2 is needed and missing, the reader raises."""

    def __init__(self, directory, pattern: str = "*.png", prefetch: bool = True):
        self.paths = sorted(glob.glob(str(Path(directory) / pattern)))
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.paths)

    def frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        from perception_tpu_torch.runtime import FramePrefetcher

        if self.prefetch and self.paths:
            files = FramePrefetcher(self.paths, threads=2, ring=4)
        else:
            files = map(_read_bytes, self.paths)
        for i, (path, raw) in enumerate(zip(self.paths, files)):
            img = decode_frame(raw, path)
            if img is None:
                warnings.warn(f"ImageDirectoryReader: skipped {path}: it cannot be read or decoded")
                continue
            yield float(i), np.ascontiguousarray(img)


def _read_bytes(path) -> bytes:
    """A file's bytes, or b"" where it cannot be read (the prefetcher's rule)."""
    try:
        return Path(path).read_bytes()
    except OSError:
        return b""


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
