"""Device-mesh sharding of codec batches and placement seeds: the port of
``ceph_tpu.parallel`` (see :mod:`.mesh`)."""
from .mesh import (Mesh, Sharded, make_mesh, sharded_batch_encode_step,
                   sharded_decode_step, sharded_encode_step,
                   sharded_placement_step)

__all__ = ["Mesh", "Sharded", "make_mesh", "sharded_batch_encode_step",
           "sharded_decode_step", "sharded_encode_step",
           "sharded_placement_step"]
