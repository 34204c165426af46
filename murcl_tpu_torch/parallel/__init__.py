"""Data-parallel training over ``torch.distributed`` (counterpart of
``murcl_tpu/parallel``): the rank launcher, the device and backend rule, and
the few collectives the engines call."""

from murcl_tpu_torch.parallel.dist import SINGLE, Ranks, launch, rank_devices

__all__ = ["SINGLE", "Ranks", "launch", "rank_devices"]
