"""The orchestration facade: one typed entry point assembling
producers -> extractors (pose / face / hand) -> savers / GUI.

Counterpart of ``perception_tpu/wrapper.py`` (OpenPose's ``Wrapper``:
configure with ``WrapperStruct*``, then ``exec`` / ``start`` + pop /
``emplace_and_pop``): the same structs, fields, defaults and
construction-time checks. The JAX package's one jitted step per frame is
a sequence of eager calls here, all on ``device`` (the card unless the
caller passes ``device="cpu"``): the pose step is ``extract_people`` and
``keep_top_n_people``, the face step ``face_multi.multi_face_step`` and
the hand step ``hand_fixture.hands_from_pose``. The input's scale test
and channel mean stay on the device, so ``emplace_and_pop`` on a frame
already on the card reads nothing back.

Typical use:

    from perception_tpu_torch.wrapper import Perception, WrapperStructInput
    p = Perception(input=WrapperStructInput(source="frames_dir/"))
    for datum in p.exec():
        print(datum.frame_index, int(datum.people.mask.sum()))

or the async form: ``p.start()``, ``p.wait_and_pop()``, ``p.stop()``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------
# Typed configuration structs (WrapperStructPose/Face/Hand/Input/
# Output/Gui, flags.hpp -> wrapperStructPose.hpp layering).
# --------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WrapperStructPose:
    enabled: bool = True
    topology: str = "MPI_15"
    net_hw: Tuple[int, int] = (128, 128)
    scales: Tuple[float, ...] = (1.0,)
    params: Any = None          # a PoseNet; None -> the trained fixture
                                # at its topology, else init_posenet's
                                # seeded net
    top_n: int = 0              # KeepTopNPeople (0 = keep all)


@dataclasses.dataclass(frozen=True)
class WrapperStructFace:
    enabled: bool = False
    params: Any = None          # face_fixture.load_fixture's dict of
                                # nets; None -> the trained fixture
    max_faces: int = 4          # tracker slots (model replication,
                                # openface2_ros.cpp:174-183)
    detect_every: int = 1       # detector cadence in frames
                                # (round(30/rate), openface2_ros.cpp:236)


@dataclasses.dataclass(frozen=True)
class WrapperStructHand:
    enabled: bool = False
    params: Any = None          # a HandLandmarkNet; None -> the
                                # trained hand fixture
    top_n_people: int = 1       # run left+right hands for the first N
                                # people (handDetector.cpp runs both
                                # wrists of every person)


@dataclasses.dataclass(frozen=True)
class WrapperStructInput:
    source: Any = None          # reader with .frames(), directory str,
                                # video path, or sequence of arrays
    frame_limit: Optional[int] = None
    fps_keep: Optional[float] = None  # producer pacing (producer.cpp
                                      # fps-keeping; io/producers.paced)


@dataclasses.dataclass(frozen=True)
class WrapperStructOutput:
    json_dir: Optional[str] = None     # per-frame people JSON
    video_path: Optional[str] = None   # rendered frames (requires gui
                                       # overlay or raw frames)
    udp: Optional[Tuple[str, int]] = None  # keypoint datagrams


@dataclasses.dataclass(frozen=True)
class WrapperStructGui:
    display: bool = False       # FrameDisplayer window (falls back to
                                # the headless sink off-display)
    info_overlay: bool = True   # FPS/people counter overlay


class PerceptionDatum(NamedTuple):
    """The pipeline's unit of work (core/datum.hpp:41-160 analog)."""
    frame_index: int
    timestamp: float
    image: Any                  # the frame as given: numpy, or a tensor
    people: Any                 # ops.paf.People (keypoints/score/mask)
    faces: Any                  # dict of face outputs or None
    hands: Any                  # dict of hand outputs or None


class Perception:
    """Facade: configure once, then ``exec()`` / ``start()``+``pop`` /
    ``emplace_and_pop()``."""

    def __init__(
        self,
        pose: WrapperStructPose = WrapperStructPose(),
        face: WrapperStructFace = WrapperStructFace(),
        hand: WrapperStructHand = WrapperStructHand(),
        input: Optional[WrapperStructInput] = None,
        output: Optional[WrapperStructOutput] = None,
        gui: Optional[WrapperStructGui] = None,
        device="cuda",
    ):
        self.pose_cfg = pose
        self.face_cfg = face
        self.hand_cfg = hand
        self.input_cfg = input or WrapperStructInput()
        self.output_cfg = output or WrapperStructOutput()
        self.gui_cfg = gui or WrapperStructGui()
        self.device = torch.device(device)
        self._sanity_checks()
        self._build()
        self._thread: Optional[threading.Thread] = None
        self._out_q: "queue.Queue[Optional[PerceptionDatum]]" = queue.Queue(maxsize=8)
        self._stop = threading.Event()

    # -- sanity checks (wrapperConfigureSanityChecks) -----------------
    def _sanity_checks(self) -> None:
        p, f, h = self.pose_cfg, self.face_cfg, self.hand_cfg
        if not (p.enabled or f.enabled or h.enabled):
            raise ValueError("no extractor enabled: set pose/face/hand")
        if h.enabled and not p.enabled:
            raise ValueError(
                "hand extraction needs pose keypoints for the hand ROI "
                "(reference: HandDetector from wrist/elbow keypoints)"
            )
        if p.enabled:
            if p.net_hw[0] % 8 or p.net_hw[1] % 8:
                raise ValueError(f"pose net_hw must be multiples of 8, got {p.net_hw}")
            if not p.scales or any(s <= 0 for s in p.scales):
                raise ValueError(f"bad scale pyramid {p.scales}")
            if p.top_n < 0:
                raise ValueError("top_n must be >= 0")
        if f.enabled and f.max_faces < 1:
            raise ValueError("max_faces must be >= 1")
        if f.enabled and f.detect_every < 1:
            raise ValueError("detect_every must be >= 1")
        if h.enabled and h.top_n_people < 1:
            raise ValueError("top_n_people must be >= 1")
        o = self.output_cfg
        if o.video_path is not None and not str(o.video_path).endswith(
            (".mp4", ".avi", ".mkv")
        ):
            raise ValueError(f"unsupported video container: {o.video_path}")
        i = self.input_cfg
        if i.fps_keep is not None and i.fps_keep <= 0:
            raise ValueError("fps_keep must be positive")
        if i.frame_limit is not None and i.frame_limit < 1:
            raise ValueError("frame_limit must be >= 1")

    # -- graph assembly ----------------------------------------------
    def _build(self) -> None:
        dev = self.device
        self._pose_net = self._face_nets = self._hand_net = None

        if self.pose_cfg.enabled:
            from perception_tpu_torch.models import pose_fixture as PF
            from perception_tpu_torch.models.pose import init_posenet

            cfg = self.pose_cfg
            self._pose_net, self._net_hw = cfg.params, cfg.net_hw
            if cfg.params is None and PF.fixture_available() and cfg.topology == PF.FIXTURE_TOPOLOGY:
                self._pose_net, self._net_hw = PF.load_fixture(dev), PF.FIXTURE_HW
            elif cfg.params is None:
                self._pose_net = init_posenet(torch.Generator().manual_seed(0), cfg.topology, dev)

        if self.face_cfg.enabled:
            from perception_tpu_torch.models import face_fixture as FF
            from perception_tpu_torch.models import face_multi as FM

            self._face_nets = self.face_cfg.params
            if self._face_nets is None:
                if not FF.fixture_available():
                    raise ValueError(
                        "face enabled but no params given and the trained "
                        "face fixture is absent (tools/train_face_fixture.py)"
                    )
                self._face_nets = FF.load_fixture(dev)
            self._face_state = FM.init_tracks(self.face_cfg.max_faces, dev)
            self._frame_count = 0

        if self.hand_cfg.enabled:
            from perception_tpu_torch.models import hand_fixture as HF

            self._hand_net = self.hand_cfg.params
            if self._hand_net is None:
                if not HF.fixture_available():
                    raise ValueError(
                        "hand enabled but no params given and the trained "
                        "hand fixture is absent (tools/train_hand_fixture.py)"
                    )
                self._hand_net = HF.load_fixture(dev)

        # Output sinks.
        o = self.output_cfg
        self._udp = self._video = self._gui = None
        if o.udp is not None:
            from perception_tpu_torch.io.savers import UdpSender

            self._udp = UdpSender(*o.udp)
        if o.video_path is not None:
            from perception_tpu_torch.io.savers import VideoWriter

            self._video = VideoWriter(o.video_path)
        if self.gui_cfg.display:
            from perception_tpu_torch.io.gui import Gui

            self._gui = Gui()

    # -- the per-frame extractors --------------------------------------
    def _pose(self, img_unit):
        from perception_tpu_torch.models.pose import extract_people
        from perception_tpu_torch.utils.keypoints import keep_top_n_people

        cfg = self.pose_cfg
        ppl = extract_people(self._pose_net, img_unit, cfg.topology, scales=cfg.scales, net_hw=self._net_hw)
        if cfg.top_n:
            kp, sc, m = keep_top_n_people(ppl.keypoints, ppl.score, ppl.mask, n=cfg.top_n)
            ppl = ppl._replace(keypoints=kp, score=sc, mask=m)
        return ppl

    def _face(self, gray8, detect: bool):
        """Native-resolution multi-face chain: the focal length scales with
        the image size over the fixture's training resolution."""
        from perception_tpu_torch.models import face_fixture as FF
        from perception_tpu_torch.models import face_multi as FM

        H, W = gray8.shape
        fx = FF.FIXTURE_FX * (max(H, W) / max(FF.FIXTURE_HW))
        self._face_state, faces = FM.multi_face_step(
            self._face_nets, gray8, self._face_state, fx, fx, W / 2.0, H / 2.0, detect, crop=FF.FIXTURE_CROP)
        return faces

    # -- synchronous single-frame API (emplaceAndPop) -----------------
    @torch.no_grad()
    def emplace_and_pop(self, image, frame_index: int = 0,
                        timestamp: Optional[float] = None) -> PerceptionDatum:
        """Run every enabled extractor on one (H, W[, 3]) frame, numpy or a
        tensor (a frame already on the card is not copied)."""
        img = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.asarray(image))
        img = img.to(self.device, torch.float32)
        if img.dim() == 2:
            img = img[..., None].expand(img.shape + (3,))
        # The input's scale, tested on the device: [0, 1] for the pose
        # net, gray [0, 255] for the face and hand nets, whatever scale
        # the caller fed. Divisions by constants are multiplies by their
        # reciprocals and the channel mean is an ordered sum times 1/3,
        # as XLA compiles the JAX step.
        img_unit = torch.where(img.amax() > 1.5, img * (1.0 / 255.0), img)
        gray8 = (img_unit[..., 0] + img_unit[..., 1] + img_unit[..., 2]) * (1.0 / 3.0) * 255.0

        people = faces = hands = None
        if self._pose_net is not None:
            people = self._pose(img_unit)
        if self._face_nets is not None:
            detect = (self._frame_count % self.face_cfg.detect_every) == 0
            self._frame_count += 1
            faces = self._face(gray8, detect)
        if self._hand_net is not None and people is not None:
            from perception_tpu_torch.models.hand_fixture import hands_from_pose

            hands = hands_from_pose(self._hand_net, gray8, people.keypoints, people.mask,
                                    n_people=self.hand_cfg.top_n_people)
        datum = PerceptionDatum(
            frame_index=frame_index,
            timestamp=time.time() if timestamp is None else timestamp,
            image=image if isinstance(image, torch.Tensor) else np.asarray(image),
            people=people,
            faces=faces,
            hands=hands,
        )
        self._route_outputs(datum)
        return datum

    def _route_outputs(self, datum: PerceptionDatum) -> None:
        o = self.output_cfg
        if o.json_dir is not None and datum.people is not None:
            from pathlib import Path

            from perception_tpu_torch.io.savers import save_people_json

            Path(o.json_dir).mkdir(parents=True, exist_ok=True)
            save_people_json(
                Path(o.json_dir) / f"people_{datum.frame_index:06d}.json",
                _host(datum.people.keypoints),
                _host(datum.people.mask),
            )
        if self._udp is not None and datum.people is not None:
            self._udp.send_array(_host(datum.people.keypoints))
        if self._video is not None:
            frame = _host(datum.image)
            if frame.ndim == 2:
                frame = np.stack([frame] * 3, -1)
            self._video.write(frame.astype(np.uint8))
        if self._gui is not None:
            n = int(_host(datum.people.mask).sum()) if datum.people is not None else None
            self._gui.update(_host(datum.image).astype(np.uint8), num_people=n)

    # -- producer plumbing --------------------------------------------
    def _frames(self) -> Iterator[Tuple[float, np.ndarray]]:
        from perception_tpu_torch.io import producers as prod

        src = self.input_cfg.source
        if src is None:
            raise ValueError("exec()/start() need WrapperStructInput.source")
        if hasattr(src, "frames"):
            it = src.frames()
        elif isinstance(src, (list, tuple)) or (
            isinstance(src, (np.ndarray, torch.Tensor)) and src.ndim == 4
        ):
            it = ((float(i), f if isinstance(f, torch.Tensor) else np.asarray(f)) for i, f in enumerate(src))
        else:
            s = str(src)
            if s.endswith((".mp4", ".avi", ".mkv", ".mov")):
                it = prod.VideoReader(s).frames()
            else:
                it = prod.ImageDirectoryReader(s).frames()
        if self.input_cfg.fps_keep is not None:
            it = prod.paced(it, self.input_cfg.fps_keep)
        return it

    # -- synchronous run (Wrapper::exec) ------------------------------
    def exec(self) -> Iterator[PerceptionDatum]:
        limit = self.input_cfg.frame_limit
        for i, (t, frame) in enumerate(self._frames()):
            if limit is not None and i >= limit:
                break
            yield self.emplace_and_pop(frame, frame_index=i, timestamp=t)

    # -- async run (Wrapper::start/stop + waitAndPop) -----------------
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("already started")
        self._stop.clear()

        def put_observing_stop(item) -> bool:
            """Bounded put that re-checks _stop so a consumer that quits
            without draining can't wedge the pump thread forever."""
            while not self._stop.is_set():
                try:
                    self._out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def pump():
            try:
                for datum in self.exec():
                    if self._stop.is_set():
                        break
                    if not put_observing_stop(datum):
                        break
            finally:
                put_observing_stop(None)  # end-of-stream sentinel

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def try_pop(self) -> Optional[PerceptionDatum]:
        try:
            return self._out_q.get_nowait()
        except queue.Empty:
            return None

    def wait_and_pop(self, timeout: Optional[float] = None) -> Optional[PerceptionDatum]:
        """Next datum, or None at end-of-stream."""
        return self._out_q.get(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            # Drain the queue while joining so a pump blocked on a full
            # queue exits promptly; only close sinks once the thread has
            # actually stopped (no write-after-close races).
            deadline = time.monotonic() + 10.0
            while thread.is_alive() and time.monotonic() < deadline:
                try:
                    self._out_q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.1)
            self._thread = None
        if thread is None or not thread.is_alive():
            if self._video is not None:
                self._video.close()
            if self._udp is not None:
                self._udp.close()
            if self._gui is not None:
                self._gui.close()


def _host(x) -> np.ndarray:
    """A sink's numpy view of a tensor (read back from the card) or array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
