"""Example 10 — GUI layer: info overlay, display loop, orbiting 3-D viewer.

The reference's gui module (FrameDisplayer / GuiInfoAdder / Gui / Gui3D,
``openpose/src/openpose/gui/``). Headless-safe: with no DISPLAY the
frames route to a sink, so the same code runs interactive on a
workstation and silent in production. The sink is a video file through
``io/savers.VideoWriter`` where cv2 imports; on a host without cv2 the
2-D loop writes one PNG a frame through ``io/png.write_png`` instead, and
says which sink it used. The depth colouring
(``models/viz.depth_to_vis``) and the 3-D viewer
(``models/viz.render_points_3d``) run on the example's device.
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples_torch._common import device, host  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perception_tpu_torch.bench.scene import render_depth_tabletop  # noqa: E402
from perception_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from perception_tpu_torch.io.gui import FrameDisplayer, Gui, Gui3D  # noqa: E402
from perception_tpu_torch.models.viz import depth_to_vis  # noqa: E402


class PngSink:
    """One PNG a frame (``io/png.write_png``): the sink where cv2, and with
    it ``VideoWriter``, is missing."""

    def __init__(self, directory):
        self.directory = Path(directory)
        self.count = 0

    def write(self, frame_rgb: np.ndarray) -> None:
        from perception_tpu_torch.io.png import write_png

        write_png(self.directory / f"frame_{self.count:04d}.png", np.ascontiguousarray(frame_rgb))
        self.count += 1

    def close(self) -> None:
        pass


def open_sink(directory):
    """(sink, path it writes, name): the video writer where cv2 imports,
    else the PNG frame sink."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return PngSink(directory), Path(directory), "png frames (io/png; no cv2 on this host)"
    from perception_tpu_torch.io.savers import VideoWriter

    path = Path(directory) / "session.mp4"
    return VideoWriter(path, fps=15.0), path, "video (io/savers.VideoWriter)"


def main(dev=None) -> dict:
    dev = device(dev)
    cam = PinholeCamera.d435_depth()

    with tempfile.TemporaryDirectory() as d:
        writer, out_path, sink_name = open_sink(d)
        gui = Gui(displayer=FrameDisplayer(sink=writer.write))

        # 2-D loop: depth visualization frames with the FPS/info overlay.
        for i in range(6):
            depth = render_depth_tabletop(
                cam, seed=i,
                cuboid_pose_twist=(0.05, 0.03, 0.80, 0.0, 0.0, 0.3 + 0.1 * i),
            )
            frame = depth_to_vis(torch.as_tensor(depth, device=dev), max_depth=1.2)
            alive = gui.update(host(frame), num_people=0, extra=f"seed {i}")
            assert alive
        gui.close()
        writer.close()
        size = sum(p.stat().st_size for p in ([out_path] if out_path.is_file() else out_path.glob("*.png")))
        print(f"2-D GUI: 6 frames -> {sink_name} at {out_path.name} ({size} bytes)")
        assert size > 1000

    # 3-D loop: orbiting offscreen viewer over a backprojected cloud.
    depth = render_depth_tabletop(cam, seed=0)
    pts, mask = cam.backproject_depth(torch.as_tensor(depth, device=dev))
    cloud = pts[mask][::50]
    frames = []
    g3 = Gui3D(hw=(120, 160), orbit_step_deg=30.0,
               displayer=FrameDisplayer(sink=frames.append))
    for _ in range(4):
        g3.update(cloud)
    assert len(frames) == 4
    assert not np.array_equal(frames[0], frames[1]), "orbit static"
    print(f"3-D viewer: {len(frames)} orbit frames rendered "
          f"({frames[0].shape[1]}x{frames[0].shape[0]})")

    # Key handling (the reference's space-pause / q-quit bindings).
    gui2 = Gui(displayer=FrameDisplayer())
    gui2.handle_key(ord(" "))
    assert gui2.paused
    gui2.handle_key(ord("q"))
    assert gui2.quit
    print("key bindings: space=pause, q=quit OK")
    return {"sink": sink_name, "bytes": size, "orbit_frames": frames, "cloud": host(cloud)}


def main_facade(dev=None) -> dict:
    """GUI sinks driven through the Perception facade: the Wrapper's
    producer -> extractor -> displayer flow in a few lines."""
    from perception_tpu_torch.wrapper import (
        Perception,
        WrapperStructGui,
        WrapperStructInput,
        WrapperStructPose,
    )

    dev = device(dev)
    frames = [np.random.RandomState(i).rand(96, 96, 3).astype(np.float32)
              for i in range(2)]
    engine = Perception(
        pose=WrapperStructPose(topology="COCO_18", net_hw=(64, 64)),
        input=WrapperStructInput(source=frames),
        gui=WrapperStructGui(display=True),  # headless sink off-display
        device=dev,
    )
    counts = []
    for datum in engine.exec():
        counts.append(int(host(datum.people.mask).sum()))
        print(f"facade+gui frame {datum.frame_index}: {counts[-1]} people")
    engine.stop()
    return {"facade_people": counts}


if __name__ == "__main__":
    main()
    main_facade()
