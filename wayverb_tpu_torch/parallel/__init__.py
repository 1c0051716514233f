"""Sharded waveguide runs and data-parallel rays over a ``DeviceMesh``."""

from wayverb_tpu_torch.parallel import sharding

__all__ = ["sharding"]
