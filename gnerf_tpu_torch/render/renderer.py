"""Two-pass hierarchical tri-plane volume renderer.

Port of `gnerf_tpu/render/renderer.py`: stratified coarse pass -> march for
weights -> inverse-CDF fine pass -> depth-sorted merge -> final march. A
point (x, y, z) projects to plane UVs (x, y), (x, z), (z, x) (the
EG3D-corrected basis).

The TPU-only layouts and merges of the JAX package (`PackedPlanes`,
`sample_packed_*`, `march_merged`, the decoder rows path) are not ported:
their option keys (`packed_combine`, `sample_merge`, `decoder_rows_path`)
are accepted and ignored, and the merge is always one stable sort.

Sequence parallelism: `options['ray_sharding']` may hold a
`parallel.Mesh` whose ray axis splits the rays (the JAX package's
NamedSharding under the same key; pass it per call, never in a stored
config). The ranks of a ray group hold the same samples; each renders its
R/k rays, both passes and the importance sampling, and the features, depth
and weights are gathered over the group with gradient.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops.triplane_sample import triplane_sample
from ..parallel.collectives import all_gather, reduce_max
from ..parallel.mesh import active_mesh
from ..parallel.sharding import draw
from ..utils import prng
from ..utils.profiling import span
from . import math_utils
from .importance import sample_importance, sample_stratified
from .ray_marcher import march_rays

# decoder(sampled_features [N, 3, M, C], directions [N, M, 3]) ->
#   {'rgb': [N, M, C_out], 'sigma': [N, M, 1]}
Decoder = Callable[[torch.Tensor, torch.Tensor], Mapping[str, torch.Tensor]]


def project_onto_planes(coordinates: torch.Tensor) -> torch.Tensor:
    """[N, M, 3] box coords -> [N, 3, M, 2] per-plane UVs (x indexes W)."""
    x, y, z = coordinates.unbind(-1)
    return torch.stack([torch.stack([x, y], -1), torch.stack([x, z], -1),
                        torch.stack([z, x], -1)], dim=1)


def sample_from_planes(plane_features: torch.Tensor, coordinates: torch.Tensor,
                       box_warp: float) -> torch.Tensor:
    """Bilinear samples of the three planes [N, 3, C, H, W] at points
    [N, M, 3]: [N, 3, M, C] contiguous, in the planes' dtype, zeros outside
    the planes (align_corners=False).

    Sampling runs in fp32 (bf16 planes are widened, the coordinates never
    narrowed) and the result is rounded once to the planes' dtype. CUDA
    tensors without a gradient to record take `ops.triplane_sample`, the
    kernel; every other call `grid_sample_planes`."""
    n = plane_features.shape[0]
    if coordinates.shape[0] != n:
        raise ValueError(f"planes batch {n} does not fit coordinates batch "
                         f"{coordinates.shape[0]} (run_model shares one identity's planes)")
    needs_grad = torch.is_grad_enabled() and (plane_features.requires_grad
                                              or coordinates.requires_grad)
    if plane_features.is_cuda and not needs_grad:
        return triplane_sample(plane_features, coordinates, box_warp)
    return grid_sample_planes(plane_features, coordinates, box_warp)


def grid_sample_planes(plane_features: torch.Tensor, coordinates: torch.Tensor,
                       box_warp: float) -> torch.Tensor:
    """`sample_from_planes` through `F.grid_sample` and its autograd: the
    route of CPU tensors and of calls that need a gradient, and the plain
    version the kernel is held to."""
    n, n_planes, c, h, w = plane_features.shape
    m = coordinates.shape[1]
    uv = project_onto_planes((2.0 / box_warp) * coordinates.float())  # [N, 3, M, 2]
    planes = plane_features.reshape(n * n_planes, c, h, w).float()
    out = F.grid_sample(planes, uv.reshape(n * n_planes, m, 1, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=False)  # [N*3, C, M, 1]
    out = out.reshape(n, n_planes, c, m).transpose(2, 3)
    return out.to(plane_features.dtype).contiguous()


def run_model(plane_features: torch.Tensor, decoder: Decoder,
              sample_coordinates: torch.Tensor, sample_directions: torch.Tensor,
              options: Mapping[str, Any], rng: Optional[torch.Tensor] = None
              ) -> dict[str, torch.Tensor]:
    """Tri-plane lookup + decoder at arbitrary 3D points [N, M, 3].

    Planes of one identity (N = 1) with F > 1 point sets fold the sets into
    the point axis: one lookup and one decoder call over F*M points, the
    outputs unfolded to [F, M, ...]."""
    f, m = sample_coordinates.shape[:2]
    if plane_features.shape[0] == 1 and f > 1:
        out = run_model(plane_features, decoder, sample_coordinates.reshape(1, f * m, 3),
                        sample_directions.reshape(1, f * m, 3), options, rng)
        return {k: v.reshape(f, m, *v.shape[2:]) for k, v in out.items()}
    feats = sample_from_planes(plane_features, sample_coordinates, box_warp=options["box_warp"])
    out = dict(decoder(feats, sample_directions))
    noise = options.get("density_noise", 0)
    if noise > 0 and rng is not None:
        sigma = out["sigma"]
        out["sigma"] = sigma + draw(prng.normal, rng, sigma.shape,
                                    ray_mesh=options.get("ray_sharding"), ray_dim=1,
                                    device=sigma.device) * noise
    return out


def unify_samples(depths1, colors1, densities1, depths2, colors2, densities2):
    """Concatenate coarse + fine samples and sort them by depth.

    One stable sort: where a coarse and a fine depth tie, the coarse sample
    stays first, as in the JAX package's stable `lax.sort`."""
    all_depths = torch.cat([depths1, depths2], dim=-2)
    all_colors = torch.cat([colors1, colors2], dim=-2)
    all_densities = torch.cat([densities1, densities2], dim=-2)
    depths_s, perm = torch.sort(all_depths[..., 0], dim=-1, stable=True)
    perm = perm[..., None]
    colors = all_colors.gather(-2, perm.expand(-1, -1, -1, all_colors.shape[-1]))
    densities = all_densities.gather(-2, perm)
    return depths_s[..., None], colors, densities


def auto_ray_extremes(ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                      box_warp: float) -> torch.Tensor:
    """The extremes that the 'auto' ray limits take over a batch of rays:
    [-min valid start, max valid start, any valid], so that extremes over
    several batches are the elementwise max."""
    ray_start, ray_end = math_utils.get_ray_limits_box(
        ray_origins, ray_directions, box_side_length=box_warp)
    return _extremes(ray_start, ray_end > ray_start)


def _extremes(ray_start: torch.Tensor, is_valid: torch.Tensor) -> torch.Tensor:
    inf = torch.full_like(ray_start, float("inf"))
    return torch.stack([-torch.where(is_valid, ray_start, inf).min(),
                        torch.where(is_valid, ray_start, -inf).max(),
                        is_valid.any().to(ray_start.dtype)])


def render_rays(plane_features: torch.Tensor, decoder: Decoder,
                ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                options: Mapping[str, Any], rng: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full two-pass render of rays [N, R, 3] ->
    (features [N, R, C_out], depth [N, R, 1], weight_sum [N, R, 1]).
    `rng` splits in four, as in the JAX package: the stratified jitter, the
    coarse pass's density noise, the importance samples and the fine
    pass's density noise; None gives fully deterministic sampling. With
    'auto' ray limits,
    `options["auto_extremes"]` (from `auto_ray_extremes`) names a larger
    batch whose part these rays are."""
    if options["ray_start"] == options["ray_end"] == "auto":
        ray_start, ray_end = math_utils.get_ray_limits_box(
            ray_origins, ray_directions, box_side_length=options["box_warp"])
        is_valid = ray_end > ray_start
        # Invalid rays get start = min(valid starts) and end = max(valid
        # STARTS), as the reference does; with no valid ray, limits stay.
        # Both extremes are over the global batch.
        ext = options.get("auto_extremes")
        if ext is None:
            ext = _extremes(ray_start, is_valid)
        mesh = active_mesh()
        if mesh is not None:
            ext = reduce_max(ext, mesh.data_group)
        vmin, vmax = -ext[0], ext[1]
        keep = is_valid | (ext[2] == 0)
        ray_start = torch.where(keep, ray_start, vmin)
        ray_end = torch.where(keep, ray_end, vmax)
    else:
        ray_start, ray_end = options["ray_start"], options["ray_end"]

    ray_mesh = options.get("ray_sharding")
    if ray_mesh is not None and ray_mesh.rays > 1:
        k, r_all = ray_mesh.rays, ray_origins.shape[1]
        if r_all % k:
            raise ValueError(f"{r_all} rays do not split over {k} ray shards")
        part = r_all // k

        def mine(x):
            if not isinstance(x, torch.Tensor) or x.dim() == 0:
                return x
            return x.narrow(1, ray_mesh.ray_rank * part, part)

        out = _render_shard(plane_features, decoder, mine(ray_origins), mine(ray_directions),
                            mine(ray_start), mine(ray_end), options, rng, ray_mesh)
        sizes = [t.shape[-1] for t in out]
        full = all_gather(torch.cat(out, dim=-1), ray_mesh.ray_group, dim=1)
        return tuple(full.split(sizes, dim=-1))
    return _render_shard(plane_features, decoder, ray_origins, ray_directions, ray_start,
                         ray_end, options, rng, None)


def _render_shard(plane_features, decoder, ray_origins, ray_directions, ray_start, ray_end,
                  options, rng, ray_mesh):
    """`render_rays` past the ray limits, on this rank's rays."""
    keys = prng.split(rng, 4) if rng is not None else [None] * 4

    def eval_points(depths, key):
        n, r, s, _ = depths.shape
        pts = (ray_origins[:, :, None, :] + depths * ray_directions[:, :, None, :]).reshape(n, -1, 3)
        dirs = ray_directions[:, :, None, :].expand(n, r, s, 3).reshape(n, -1, 3)
        out = run_model(plane_features, decoder, pts, dirs, options, key)
        return out["rgb"].reshape(n, r, s, -1), out["sigma"].reshape(n, r, s, 1)

    with span("render.coarse"):
        depths_coarse = sample_stratified(
            keys[0], ray_origins, ray_start, ray_end, options["depth_resolution"],
            options.get("disparity_space_sampling", False), ray_mesh=ray_mesh)
        colors_coarse, densities_coarse = eval_points(depths_coarse, keys[1])

    n_imp = options["depth_resolution_importance"]
    if n_imp > 0:
        with span("render.importance"):
            _, _, weights = march_rays(colors_coarse, densities_coarse, depths_coarse, options)
            depths_fine = sample_importance(keys[2], depths_coarse, weights, n_imp,
                                            ray_mesh=ray_mesh)
        with span("render.fine"):
            colors_fine, densities_fine = eval_points(depths_fine, keys[3])
        with span("render.composite"):
            all_depths, all_colors, all_densities = unify_samples(
                depths_coarse, colors_coarse, densities_coarse,
                depths_fine, colors_fine, densities_fine)
            rgb_final, depth_final, weights = march_rays(all_colors, all_densities, all_depths,
                                                         options)
    else:
        with span("render.composite"):
            rgb_final, depth_final, weights = march_rays(
                colors_coarse, densities_coarse, depths_coarse, options)
    return rgb_final, depth_final, weights.sum(dim=2)
