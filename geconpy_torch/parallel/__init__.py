"""Device meshes: the batch axis split over several devices (mirrors
``geconpy_tpu/parallel``; see :mod:`.mesh`)."""

from .mesh import (Mesh, functions_per_device, make_mesh, pvmap, shard_batch,
                   sharded_prior_sweep)

__all__ = ["Mesh", "functions_per_device", "make_mesh", "pvmap",
           "shard_batch", "sharded_prior_sweep"]
