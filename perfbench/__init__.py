"""The benchmark of perception_tpu_torch on one H100: cells, traffic,
metric readers, the plain reference and the yardstick's counts."""
