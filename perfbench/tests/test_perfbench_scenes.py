"""The scene generators render the same frames from the same seed."""

import torch

from small_cells import SMALL, CUBOID, ODOM
from perfbench import harness
from perfbench.scenes import room, tabletop


def _spec(cell):
    _, _, config, traffic = harness.cell_spec(cell)
    SMALL[cell](config, traffic)
    return config, traffic


def test_tabletop_is_deterministic_by_seed():
    config, traffic = _spec(CUBOID)
    a = tabletop.render(config["camera"], traffic["scene"], 3, 2**31 + 9, "cpu")
    b = tabletop.render(config["camera"], traffic["scene"], 3, 2**31 + 9, "cpu")
    c = tabletop.render(config["camera"], traffic["scene"], 3, 2**31 + 10, "cpu")
    assert a.shape == (3, 120, 160) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    # The table sits at 0.85 m; the cuboid is nearer, in every frame.
    assert ((a - 0.85).abs() < 0.02).float().mean() > 0.5
    assert bool((a < 0.83).flatten(1).any(1).all())


def test_tabletop_frames_share_sizes_across_seeds():
    config, traffic = _spec(CUBOID)
    tw1 = tabletop.twists(traffic["scene"], 5, 1)
    tw2 = tabletop.twists(traffic["scene"], 5, 2)
    assert torch.equal(tw1[:, :5], tw2[:, :5])
    assert torch.allclose(tw1[1:, 5] - tw1[:-1, 5], torch.full((4,), 0.05, dtype=torch.float64))
    assert not torch.equal(tw1[:, 5], tw2[:, 5])


def test_room_sweep_is_deterministic_and_periodic():
    config, traffic = _spec(ODOM)
    a = room.render(config["camera"], traffic["scene"], 5, "cpu")
    b = room.render(config["camera"], traffic["scene"], 5, "cpu")
    assert a.shape == (59, 120, 160) and torch.equal(a, b)
    poses = room.trajectory(traffic["scene"], "cpu")
    assert torch.allclose(poses[0], poses[-1], atol=1e-12)
    # One step of the sweep moves the camera by at most about 2 cm at 300 frames.
    full = dict(traffic["scene"], frames=300)
    p = room.trajectory(full, "cpu")
    assert float((p[1:, :3, 3] - p[:-1, :3, 3]).norm(dim=-1).max()) < 0.022
