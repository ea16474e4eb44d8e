"""3D shape extraction: dense sigma grid -> isosurface mesh.

Port of `gnerf_tpu/infer/shape_utils.py`: evaluate sigma on a voxel grid in
chunks through `run_model` and the decoder kernel, write an `.mrc` volume,
run isosurface extraction, write a `.ply` mesh.

The sweep builds one identity's planes once (fp32, as the JAX sweep does)
and makes each chunk's voxel centres on the device from their indices, so
no host coordinate array exists; the ragged last chunk runs at its own
size. Under a `parallel.Mesh` each rank decodes its contiguous part of
every chunk (the JAX package's P(None, 'data', None) over every device),
and the parts are gathered. The MRC (MRC2014, mode 2) reader/writer, the
PLY writer and marching tetrahedra (6-tet cube split, no case tables) are
numpy copies of the JAX package's.

    python -m gnerf_tpu_torch.infer.shape_utils out/seedinit/119.mrc --level 10
"""

from __future__ import annotations

import struct

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import module_device

# ---------------------------------------------------------------------------
# Sigma grid evaluation


def grid_points(n: int, start: int, stop: int, cube_length: float = 2.0,
                voxel_origin=(0, 0, 0), device=None) -> torch.Tensor:
    """Voxel centres [stop - start, 3] float32 of an n^3 grid, in the
    reference's axis order: index = ((x * n) + y) * n + z. Computed in
    float64 and rounded once, as `create_samples` does."""
    origin = np.asarray(voxel_origin, dtype=np.float64) - cube_length / 2
    voxel_size = cube_length / (n - 1)
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    cols = (idx // n // n % n, idx // n % n, idx % n)
    return torch.stack([c.double() * voxel_size + o
                        for c, o in zip(cols, origin[::-1])], dim=-1).float()


def create_samples(N: int, cube_length: float = 2.0,
                   voxel_origin=(0, 0, 0)) -> tuple[np.ndarray, np.ndarray, float]:
    """([1, N^3, 3] float32 voxel centres, origin, voxel size)."""
    origin = np.asarray(voxel_origin, dtype=np.float64) - cube_length / 2
    samples = grid_points(N, 0, N ** 3, cube_length, voxel_origin).numpy()
    return samples[None], origin, cube_length / (N - 1)


@torch.inference_mode()
def extract_sigma_grid(g, ws: torch.Tensor, voxel_resolution: int = 512,
                       cube_length: float = 1.0, max_batch: int = 1 << 20,
                       apply_pad_mask: bool = True, mesh=None, device=None) -> np.ndarray:
    """[res, res, res] float32 sigma volume for one identity (ws [1, ...]).

    Runs on CUDA unless `device` names another device; G must live there.
    Post-processing as the reference: axis-0 flip + border zeroing. With a
    `parallel.Mesh`, every rank of it sweeps its part of each chunk
    (`max_batch` rounded up to a multiple of the ranks; the ragged last
    chunk's parts padded with zeros, the padding dropped) and every rank
    returns the whole volume."""
    from ..render.renderer import run_model

    device = module_device(g, device)
    ranks, me = 1, 0
    if mesh is not None:
        from ..parallel import Mesh, all_gather

        if not isinstance(mesh, Mesh):  # e.g. a jax.sharding.Mesh
            raise ValueError(f"mesh must be a gnerf_tpu_torch.parallel.Mesh, "
                             f"got {type(mesh).__name__}")
        ranks, me = dist.get_world_size(mesh.group), dist.get_rank(mesh.group)
        max_batch = -(-max_batch // ranks) * ranks
    planes = g.backbone_planes(ws.to(device), noise_mode="const")
    opts = dict(g.rendering_kwargs)
    total = voxel_resolution ** 3
    sigmas = torch.empty((total,), dtype=torch.float32, device=device)
    for head in range(0, total, max_batch):
        n = min(max_batch, total - head)
        part = -(-n // ranks)
        lo = min(head + me * part, head + n)
        coords = grid_points(voxel_resolution, lo, min(lo + part, head + n), cube_length,
                             device=device)
        if mesh is not None:
            coords = torch.cat([coords, coords.new_zeros((part - coords.shape[0], 3))])
        coords = coords[None]
        dirs = torch.zeros_like(coords)
        dirs[..., 2] = -1.0
        sigma = run_model(planes, g.decoder, coords, dirs, opts)["sigma"][0, :, 0]
        if mesh is not None:
            sigma = all_gather(sigma, mesh.group)[:n]
        sigmas[head:head + n] = sigma

    vol = sigmas.cpu().numpy().reshape((voxel_resolution,) * 3)
    vol = np.flip(vol, 0).copy()
    if apply_pad_mask:
        pad = int(30 * voxel_resolution / 256)
        pad_top = int(38 * voxel_resolution / 256)
        vol[:pad] = 0
        vol[-pad:] = 0
        vol[:, :pad] = 0
        vol[:, -pad_top:] = 0
        vol[:, :, :pad] = 0
        vol[:, :, -pad:] = 0
    return vol


# ---------------------------------------------------------------------------
# MRC2014 I/O (mode 2 = float32)


def write_mrc(path: str, volume: np.ndarray, voxel_size: float = 1.0) -> None:
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    nz, ny, nx = vol.shape
    header = bytearray(1024)
    struct.pack_into("<3i", header, 0, nx, ny, nz)        # NX NY NZ
    struct.pack_into("<i", header, 12, 2)                 # MODE 2 = float32
    struct.pack_into("<3i", header, 28, nx, ny, nz)       # MX MY MZ
    struct.pack_into("<3f", header, 40, nx * voxel_size, ny * voxel_size,
                     nz * voxel_size)                     # CELLA
    struct.pack_into("<3f", header, 52, 90.0, 90.0, 90.0) # CELLB
    struct.pack_into("<3i", header, 64, 1, 2, 3)          # MAPC MAPR MAPS
    struct.pack_into("<3f", header, 76, float(vol.min()), float(vol.max()),
                     float(vol.mean()))                   # DMIN DMAX DMEAN
    header[208:212] = b"MAP "                             # MAP stamp
    header[212:216] = b"\x44\x44\x00\x00"                 # little-endian stamp
    struct.pack_into("<f", header, 216, float(vol.std()))
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(vol.tobytes())


def read_mrc(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.read(1024)
        nx, ny, nz = struct.unpack_from("<3i", header, 0)
        mode = struct.unpack_from("<i", header, 12)[0]
        if mode != 2:
            raise ValueError(f"only mode-2 (float32) MRC supported, got {mode}")
        data = np.frombuffer(f.read(nx * ny * nz * 4), dtype=np.float32)
    return data.reshape(nz, ny, nx)


# ---------------------------------------------------------------------------
# Isosurface extraction: marching tetrahedra


_CUBE_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], dtype=np.int64)

_CUBE_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.int64)


def marching_tetrahedra(volume: np.ndarray, level: float = 10.0,
                        spacing: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Isosurface of `volume` at `level` via 6-tetrahedron cube splitting.

    Returns (vertices [V, 3] float32, faces [F, 3] int64)."""
    vol = np.asarray(volume, dtype=np.float32)
    nz, ny, nx = vol.shape

    # Cube origin grids (exclude last voxel along each axis).
    gz, gy, gx = np.meshgrid(
        np.arange(nz - 1), np.arange(ny - 1), np.arange(nx - 1), indexing="ij"
    )
    base = np.stack([gz.ravel(), gy.ravel(), gx.ravel()], axis=1)  # [C, 3]

    # Only keep cubes that straddle the level (cheap prefilter).
    corner_vals = np.stack([
        vol[base[:, 0] + c[2], base[:, 1] + c[1], base[:, 2] + c[0]]
        for c in _CUBE_CORNERS
    ], axis=1)  # [C, 8]   (corner xyz -> index: x fastest per _CUBE_CORNERS)
    inside = corner_vals > level
    active = np.any(inside, axis=1) & ~np.all(inside, axis=1)
    base = base[active]
    corner_vals = corner_vals[active]
    if base.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # Corner positions in (z, y, x) volume coordinates.
    corner_pos = base[:, None, :] + _CUBE_CORNERS[None, :, ::-1]  # [C, 8, 3]

    verts_out = []
    faces_out = []
    vert_count = 0

    for tet in _CUBE_TETS:
        v = corner_vals[:, tet]           # [C, 4]
        p = corner_pos[:, tet]            # [C, 4, 3]
        ins = v > level                   # [C, 4]
        n_in = ins.sum(axis=1)

        def edge_verts(sel, pairs):
            """Interpolated crossing points for `pairs` of local tet corners."""
            pts = []
            for a, b in pairs:
                va, vb = v[sel, a], v[sel, b]
                t = (level - va) / np.where(vb - va == 0, 1e-12, vb - va)
                t = np.clip(t, 0.0, 1.0)[:, None]
                pts.append(p[sel, a] * (1 - t) + p[sel, b] * t)
            return pts

        # Case: exactly one corner inside -> one triangle.
        for corner in range(4):
            others = [c for c in range(4) if c != corner]
            sel = (n_in == 1) & ins[:, corner]
            if not np.any(sel):
                continue
            tri = edge_verts(sel, [(corner, o) for o in others])
            n = tri[0].shape[0]
            verts_out.extend(tri)
            idx = vert_count + np.arange(n)
            faces_out.append(np.stack([idx, idx + n, idx + 2 * n], axis=1))
            vert_count += 3 * n

        # Case: exactly three corners inside -> one triangle (inverted).
        for corner in range(4):
            others = [c for c in range(4) if c != corner]
            sel = (n_in == 3) & ~ins[:, corner]
            if not np.any(sel):
                continue
            tri = edge_verts(sel, [(o, corner) for o in others])
            n = tri[0].shape[0]
            verts_out.extend(tri)
            idx = vert_count + np.arange(n)
            faces_out.append(np.stack([idx, idx + n, idx + 2 * n], axis=1))
            vert_count += 3 * n

        # Case: two inside -> quad (two triangles).
        for pair in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
            a, b = pair
            others = [c for c in range(4) if c not in pair]
            sel = (n_in == 2) & ins[:, a] & ins[:, b]
            if not np.any(sel):
                continue
            # Crossings: a-o0, a-o1, b-o0, b-o1 -> quad (ao0, ao1, bo1, bo0).
            q = edge_verts(sel, [(a, others[0]), (a, others[1]),
                                 (b, others[1]), (b, others[0])])
            n = q[0].shape[0]
            verts_out.extend(q)
            idx = vert_count + np.arange(n)
            faces_out.append(np.stack([idx, idx + n, idx + 2 * n], axis=1))
            faces_out.append(np.stack([idx, idx + 2 * n, idx + 3 * n], axis=1))
            vert_count += 4 * n

    verts = np.concatenate(verts_out, axis=0).astype(np.float32) * spacing
    faces = np.concatenate(faces_out, axis=0).astype(np.int64)
    return verts, faces


# ---------------------------------------------------------------------------
# PLY writer


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              offset=(0.0, 0.0, 0.0), scale: float = 1.0) -> None:
    """Binary little-endian PLY: float xyz vertices, uchar-counted int faces."""
    v = (np.asarray(verts, np.float32) * scale) + np.asarray(offset, np.float32)
    f = np.asarray(faces, np.int32)
    with open(path, "wb") as fh:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(f)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        fh.write(header.encode())
        fh.write(v.astype("<f4").tobytes())
        body = np.empty(len(f), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        body["n"] = 3
        body["idx"] = f
        fh.write(body.tobytes())


def convert_mrc(mrc_path: str, level: float = 10.0) -> str:
    """`.mrc` -> `.ply` beside it; returns the `.ply` path."""
    vol = read_mrc(mrc_path)
    verts, faces = marching_tetrahedra(vol, level=level)
    out = mrc_path.replace(".mrc", ".ply")
    write_ply(out, verts, faces)
    return out


if __name__ == "__main__":
    import click

    @click.command()
    @click.argument("mrc_files", nargs=-1)
    @click.option("--level", type=float, default=10.0)
    def main(mrc_files, level):
        for p in mrc_files:
            print(convert_mrc(p, level=level))

    main()
