"""Process groups, collectives and sharding: the distributed substrate.

Port of `gnerf_tpu/parallel` over torch.distributed (NCCL on cards, gloo on
the CPU): data parallelism and ray (sequence) parallelism of the training
step, held to the JAX package's global-batch step."""

from .collectives import (all_gather, all_reduce, check_replica_consistency, pmean_grads,
                          psum_moments)
from .mesh import (DATA_AXIS, RAY_AXIS, Mesh, active_mesh, init_distributed, make_mesh,
                   process_info, use_mesh)
from .sharding import (data_mean, data_sum, draw, global_rows, local_rows, mean_stats,
                       put_replicated)

__all__ = [
    "DATA_AXIS", "Mesh", "RAY_AXIS", "active_mesh", "all_gather", "all_reduce",
    "check_replica_consistency", "data_mean", "data_sum", "draw", "global_rows",
    "init_distributed", "local_rows", "make_mesh", "mean_stats", "pmean_grads",
    "process_info", "psum_moments", "put_replicated", "use_mesh",
]
