"""This rank's share of the global step: replicated state, its rows of the
global batch, its part of every random draw, and the means over the mesh.

Port of `gnerf_tpu/parallel/sharding.py`. `sharded_jit`, `batch_spec` and
`ray_spec` have no counterpart: there is no compiler to annotate, and the
models read the active mesh (`mesh.use_mesh`) instead.

Data shard d holds rows d*n ... (d+1)*n - 1 of the global batch, the
contiguous layout of JAX's P('data') sharding; ray shard r of R rays holds
rays r*R/k ... (r+1)*R/k - 1. A random draw is the world-1 draw of the
global array, cut to this rank's rows (and rays): a step does not depend
on the number of ranks. The draws are small next to the step.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping, Optional

import torch
import torch.distributed as dist

from .collectives import all_gather, all_reduce, psum_moments
from .mesh import Mesh, active_mesh


@torch.no_grad()
def put_replicated(modules: Iterable[Optional[torch.nn.Module]], mesh: Optional[Mesh]) -> None:
    """Every parameter and buffer of `modules` set to the first rank's, on
    every rank of the mesh (the reference's rank-0 broadcast,
    `training_loop.py:234-238`). A no-op without a mesh."""
    if mesh is None:
        return
    src = dist.get_global_rank(mesh.group, 0)
    for module in modules:
        if module is None:
            continue
        for t in list(module.parameters()) + list(module.buffers()):
            buf = t.detach().contiguous().clone()
            dist.broadcast(buf, src=src, group=mesh.group)
            t.copy_(buf)


def local_rows(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (put_global_batch); x
    itself without a mesh. `mesh` defaults to the active one."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.data == 1:
        return x
    n = x.shape[0] // mesh.data
    if n * mesh.data != x.shape[0]:
        raise ValueError(f"global batch {x.shape[0]} not divisible by {mesh.data} data shards")
    return x.narrow(0, mesh.data_rank * n, n)


@torch.no_grad()
def global_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank tensor that needs no gradient (labels),
    gathered over the active mesh's data group; x itself without one."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return all_gather(x, mesh.data_group)


def draw(sampler: Callable, shape, generator: Optional[torch.Generator], *,
         ray_mesh: Optional[Mesh] = None, ray_dim: Optional[int] = None,
         **kwargs) -> torch.Tensor:
    """`sampler(shape, generator=generator, **kwargs)` (torch.rand, randn)
    for this rank's part of the draw: dimension 0 is the batch, split over
    the active mesh's data axis, and `ray_dim` (when `ray_mesh` shards the
    render's rays) is split over its ray axis. The full draw is made and
    cut, so each rank's values are those of the world-1 draw."""
    mesh = active_mesh()
    shape = tuple(shape)
    data = mesh.data if mesh is not None and shape else 1
    rays = ray_mesh.rays if ray_mesh is not None and ray_dim is not None else 1
    if data == 1 and rays == 1:
        return sampler(shape, generator=generator, **kwargs)
    full = list(shape)
    full[0] *= data
    if rays > 1:
        full[ray_dim] *= rays
    out = sampler(tuple(full), generator=generator, **kwargs)
    if data > 1:
        out = out.narrow(0, mesh.data_rank * shape[0], shape[0])
    if rays > 1:
        out = out.narrow(ray_dim, ray_mesh.ray_rank * shape[ray_dim], shape[ray_dim])
    return out.contiguous()


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the active mesh's data shards (x is a mean over
    this rank's rows, each shard has as many), differentiable; x itself
    without a mesh."""
    mesh = active_mesh()
    return x if mesh is None else all_reduce(x, mesh.data_group, mean=True)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the active mesh's data shards, without a gradient;
    x itself without a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return x
    with torch.no_grad():
        return all_reduce(x, mesh.data_group)


@torch.no_grad()
def mean_stats(stats: Mapping[str, torch.Tensor], mesh: Optional[Mesh]) -> dict:
    """Scalar stats averaged over every rank of the mesh, in one all_reduce:
    each rank's value is a mean over its rows (identical over a ray group),
    so the result is the mean over the global batch."""
    if mesh is None or not stats:
        return dict(stats)
    names = list(stats)
    flat = torch.stack([stats[k].detach().float().reshape(()) for k in names])
    flat = psum_moments(flat, mesh.group) / dist.get_world_size(mesh.group)
    return dict(zip(names, flat.unbind(0)))
