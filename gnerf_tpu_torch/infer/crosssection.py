"""Cross-section density visualization: a planar slice of sigma through
`sample_mixed`, for debugging the learned geometry. Port of
`gnerf_tpu/infer/crosssection.py`."""

from __future__ import annotations

import torch


@torch.inference_mode()
def sample_cross_section(g, ws: torch.Tensor, resolution: int = 256, w_extent: float = 0.3,
                         axis: str = "z", offset: float = 0.0) -> torch.Tensor:
    """[N, resolution, resolution] sigma slice at `axis` = offset, on G's device."""
    lin = torch.linspace(-w_extent, w_extent, resolution, device=ws.device)
    u, v = torch.meshgrid(lin, lin, indexing="ij")
    flat_u, flat_v = u.reshape(-1), v.reshape(-1)
    off = torch.full_like(flat_u, offset)
    cols = {"x": (off, flat_u, flat_v),
            "y": (flat_u, off, flat_v),
            "z": (flat_u, flat_v, off)}[axis]
    coords = torch.stack(cols, dim=-1)[None].expand(ws.shape[0], -1, -1).contiguous()
    sigma = g.sample_mixed(coords, torch.zeros_like(coords), ws)["sigma"]
    return sigma.reshape(ws.shape[0], resolution, resolution)
