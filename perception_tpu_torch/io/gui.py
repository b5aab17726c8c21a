"""GUI layer: frame display, info overlay and the interactive loop.

Counterpart of ``perception_tpu/io/gui.py`` without the 3-D viewer:
``GuiInfoAdder`` (an FPS / frame / people overlay, numpy when ``cv2`` is
missing), ``FrameDisplayer`` (a ``cv2`` window when a display exists,
else a frame sink) and ``Gui`` (show, poll keys: space pauses, 'q' or
Esc quits).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np


def display_available() -> bool:
    """True when an interactive window can be opened."""
    if os.environ.get("PERCEPTION_TPU_FORCE_HEADLESS"):
        return False
    return bool(os.environ.get("DISPLAY") or os.name == "nt")


class GuiInfoAdder:
    """FPS / frame-id / people-count overlay (guiInfoAdder.cpp role)."""

    def __init__(self, smoothing: float = 0.9):
        self._last = None
        self._fps = 0.0
        self._smoothing = smoothing

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = max(now - self._last, 1e-6)
            inst = 1.0 / dt
            self._fps = (
                self._smoothing * self._fps + (1 - self._smoothing) * inst
                if self._fps > 0 else inst
            )
        self._last = now
        return self._fps

    def add_info(
        self,
        frame: np.ndarray,
        frame_id: Optional[int] = None,
        num_people: Optional[int] = None,
        extra: str = "",
    ) -> np.ndarray:
        fps = self.tick()
        parts = [f"{fps:5.1f} fps"]
        if frame_id is not None:
            parts.append(f"#{frame_id}")
        if num_people is not None:
            parts.append(f"people: {num_people}")
        if extra:
            parts.append(extra)
        text = "  ".join(parts)
        out = np.ascontiguousarray(frame)
        try:
            import cv2

            cv2.putText(out, text, (8, 22), cv2.FONT_HERSHEY_SIMPLEX,
                        0.6, (0, 0, 0), 3, cv2.LINE_AA)
            cv2.putText(out, text, (8, 22), cv2.FONT_HERSHEY_SIMPLEX,
                        0.6, (255, 255, 255), 1, cv2.LINE_AA)
        except ImportError:
            # Minimal fallback: brighten a banner strip so the overlay
            # is still visible without cv2.
            out[:28] = np.minimum(out[:28].astype(np.int32) + 60, 255).astype(
                out.dtype
            )
        return out


class FrameDisplayer:
    """Window when a display exists; sink fallback when headless.

    ``sink``: optional callable(frame) used headless (e.g.
    ``savers.VideoWriter(...).write``). Without a sink, headless frames
    are counted and dropped — the display is then pure observability.
    """

    def __init__(self, title: str = "perception_tpu_torch",
                 sink: Optional[Callable[[np.ndarray], None]] = None):
        self.title = title
        self.sink = sink
        self.frames_shown = 0
        self._window = display_available()

    def display(self, frame_rgb: np.ndarray) -> None:
        self.frames_shown += 1
        if self._window:
            import cv2

            cv2.imshow(self.title, frame_rgb[..., ::-1])  # RGB -> BGR
            cv2.waitKey(1)
        elif self.sink is not None:
            self.sink(frame_rgb)

    def close(self) -> None:
        if self._window:
            import cv2

            cv2.destroyWindow(self.title)


class Gui:
    """The interactive loop: display + key handling (gui.cpp semantics:
    space toggles pause, 'q'/Esc quits)."""

    def __init__(self, displayer: Optional[FrameDisplayer] = None,
                 info: Optional[GuiInfoAdder] = None):
        self.displayer = displayer or FrameDisplayer()
        self.info = info or GuiInfoAdder()
        self.paused = False
        self.quit = False
        self._frame_id = 0

    def handle_key(self, key: int) -> None:
        if key in (ord("q"), 27):  # q / Esc
            self.quit = True
        elif key == ord(" "):
            self.paused = not self.paused

    def update(self, frame_rgb: np.ndarray, num_people=None,
               extra: str = "") -> bool:
        """Show one frame; returns False when the user asked to quit."""
        if self.quit:
            return False
        shown = self.info.add_info(
            frame_rgb, frame_id=self._frame_id, num_people=num_people,
            extra=extra,
        )
        self._frame_id += 1
        self.displayer.display(shown)
        if self.displayer._window:
            import cv2

            self.handle_key(cv2.waitKey(1) & 0xFF)
        return not self.quit

    def close(self) -> None:
        self.displayer.close()
