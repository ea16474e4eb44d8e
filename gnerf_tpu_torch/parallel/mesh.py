"""Process groups for data and ray parallelism over torch.distributed.

Port of `gnerf_tpu/parallel/mesh.py`. The JAX package lays one program over
a ('data', 'rays') device mesh; here every rank is one process (one card
under `torchrun`, the reference implementation's process-per-GPU layout,
`g_nerf/train.py:36-47`) and the mesh is a pair of process groups:

  'data'  the ranks that hold different rows of the global batch;
  'rays'  the ranks that hold the same rows and split the render's rays
          between them (sequence parallelism of the renderer).

Ranks are laid out as JAX lays out devices, `reshape(data, rays)`: rank
`d * rays + r` holds data shard d and ray shard r.

A step runs under `use_mesh(mesh)`; the models read the active mesh where
the global batch reaches across rows (train-mode BatchNorm moments, the
minibatch-std groups, the pose swap) and where they draw random numbers
(`sharding.draw`). With no mesh every one of those is the single-process
computation.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Any, Iterator, Optional, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
RAY_AXIS = "rays"


def init_distributed(device: Optional[Union[str, torch.device]] = None) -> bool:
    """Join the process group `torchrun` describes, when there is one.

    On when torchrun's WORLD_SIZE is above 1 or GNERF_DISTRIBUTED=1 is set
    (the JAX package's flag); off otherwise, and single-process behaviour is
    unchanged. The rendezvous is torchrun's (env://: MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE). The device follows `resolve_device`
    (CUDA unless named: it raises without a card): NCCL for CUDA, gloo for
    the CPU. Returns True iff a process group is up after the call."""
    from ..utils.device import resolve_device

    enabled = (int(os.environ.get("WORLD_SIZE", "1")) > 1
               or os.environ.get("GNERF_DISTRIBUTED", "") == "1")
    if not enabled:
        return False
    if not dist.is_initialized():
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend)
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size): the pair that gates I/O and shards the data
    sampler; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, rays) layout of the ranks and the groups along each axis.
    `group` holds every rank of the mesh."""

    data: int
    rays: int
    data_rank: int
    ray_rank: int
    data_group: Any
    ray_group: Any
    group: Any


def make_mesh(data: Optional[int] = None, rays: int = 1) -> Optional[Mesh]:
    """The (data, rays) mesh over every rank of the process group; None in
    a single process without one (there is nothing to reduce over).

    data=None puts every remaining rank on the data axis. Every rank must
    call this, with the same arguments, since it creates process groups."""
    rank, n = process_info()
    if data is None:
        assert n % rays == 0, f"{n} devices not divisible by rays={rays}"
        data = n // rays
    assert data * rays == n, f"mesh {data}x{rays} != {n} devices"
    if not dist.is_initialized():
        return None
    grid = [[d * rays + r for r in range(rays)] for d in range(data)]

    def group(ranks):
        return dist.group.WORLD if len(ranks) == n else dist.new_group(ranks)

    # new_group is collective: every rank creates every group, in one order.
    data_groups = [group([grid[d][r] for d in range(data)]) for r in range(rays)]
    ray_groups = [group(grid[d]) for d in range(data)]
    d, r = divmod(rank, rays)
    return Mesh(data=data, rays=rays, data_rank=d, ray_rank=r, data_group=data_groups[r],
                ray_group=ray_groups[d], group=dist.group.WORLD)


# Per thread (and task): a step under a mesh in one thread leaves another
# thread's forward passes, such as a server's, single-process. The rule that
# comes with it: a model call that belongs to a step but runs on another
# thread must enter `use_mesh(mesh)` again there, or that rank skips the
# step's collectives (BatchNorm moments, minibatch-std gathers) that its
# peers make. `train_loop.checkpointed` does so for the recompute, which
# the autograd engine runs on a thread of its own on CUDA.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("gnerf_mesh", default=None)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the step that is running, None outside one."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Within the block the models compute the global-batch step of `mesh`
    (None: the single-process step)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)
