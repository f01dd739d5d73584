"""Scale-out: device meshes, batched pair registration, canvas sharding and
the multi-process path."""

from .mesh import make_mesh, Mesh, NamedSharding, P
from .batched import make_batched_register, register_pairs_batched
from .canvas import make_sharded_composite, make_sharded_multiband
from .distributed import (init_distributed, make_global_mesh,
                          shard_local_batch, batched_register_distributed)
