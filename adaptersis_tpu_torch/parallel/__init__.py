"""Data parallelism over W processes, one per GPU (counterpart of the JAX
package's `parallel/`): process management, the ("data", "fsdp") mesh and
FSDP2 sharding, and the SLURM launcher."""

from .dist import (all_reduce_mean, all_reduce_sum, barrier, get_local_rank, get_rank,
                   get_world_size, init_distributed, is_main_process)
from .mesh import broadcast_module, fsdp_shard, get_mesh
