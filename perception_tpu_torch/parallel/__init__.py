"""Multi-device and multi-process layer on ``torch.distributed`` (counterpart of ``perception_tpu/parallel``)."""
