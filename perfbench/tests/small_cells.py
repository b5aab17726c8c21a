"""The benchmark's cells cut small enough for the CPU, for its tests."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CUBOID = "cuboid.replay_b64"
ODOM = "odom.live_kf32k"
SEED = 2**31 + 77  # past 32 signed bits, as the driver's seeds may be


def _small_camera(config):
    cam = config["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] = cam[k] / 4
    cam["width"], cam["height"] = 160, 120


def small_cuboid(config, traffic):
    """The cuboid cell at 160x120, two frames a call."""
    _small_camera(config)
    traffic.update(batch=2, pool=4, orders=1, check_calls=2, warmup_calls=1)


def small_odom(config, traffic):
    """The odometry cell at 160x120 with 512 / 2048 points over a 60-frame sweep."""
    _small_camera(config)
    config["settings"].update(point_budget=512, keyframe_budget=2048)
    traffic.update(check_steps=4, check_promotions=2, warmup_steps=1)
    traffic["scene"]["frames"] = 60


SMALL = {CUBOID: small_cuboid, ODOM: small_odom}
