"""Depth scenes rendered on the device from a seed (frozen copies of the
port's numpy generators, rewritten in torch)."""
