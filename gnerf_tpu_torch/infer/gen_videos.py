"""Single-image -> pose-swept novel-view video (the flagship workload).

Port of `gnerf_tpu/infer/gen_videos.py`: encode the identity photo(s) with
E, map to ws and build the tri-planes ONCE, then render the camera orbit
frame by frame (`render_video`: 8 frames per host round trip, uint8
conversion on the device) and write `<name>.mp4` + `<name>_raw.mp4` (or the
fallback formats of `video_io`). Sampling density is doubled at load, as in
the reference. Photos are decoded and resized to 512^2 (under `--dataset
shapenet` to G's output side, 128^2) by the native loader
(`utils/native_loader.py`, PIL bilinear without the library), or
FFHQ-aligned first when `--align_lm` names a folder of landmark files;
`--gen_shapes true` also writes the sigma volume `<outdir>/<name>/<frames-1>.mrc`.

    python -m gnerf_tpu_torch.infer.gen_videos --seed-init 0 --frames 8

Several cards: one process per card under torchrun, as the training CLI
(the JAX package takes every attached device in one process instead):

    torchrun --nproc_per_node=K -m gnerf_tpu_torch.infer.gen_videos --seed-init 0 --ray_shards R

The ranks form a (data = K / R, rays = R) mesh. Each chunk of
ceil(min(8, frames) / data) * data frames (the tail padded with the last
label, and the padding dropped) is split over the data axis, and each
frame's rays over the rays axis (`render_rays`' `ray_sharding`); the uint8
frames are gathered to rank 0, which alone writes the videos and returns
the result. The sigma sweep splits each chunk's points over every rank.
"""

from __future__ import annotations

import functools
import itertools
import json
import math
import os
import time
import weakref
from typing import Optional

import click
import numpy as np
import torch

from ..utils import camera, prng
from ..utils.device import resolve_device
from ..utils.profiling import profiled_function, span

CHUNK = 8  # frames per device -> host copy


def _find_landmarks(align_lm: str, img_path: str) -> Optional[str]:
    """Per-image landmark file `<align_lm>/<stem>.{json,npy,txt}`, or None."""
    stem = os.path.splitext(os.path.basename(img_path))[0]
    for ext in (".json", ".npy", ".txt"):
        p = os.path.join(align_lm, stem + ext)
        if os.path.isfile(p):
            return p
    return None


def _load_images(id_image: Optional[str], prepared: Optional[str],
                 align_lm: str = "", size: int = 512) -> np.ndarray:
    """Identity photos -> [N, 3, size, size] uint8.

    With no photo, a deterministic synthetic identity (as the JAX CLI's
    --seed-init smoke runs). A photo with a landmark file in `align_lm` is
    FFHQ-aligned to a size^2 crop; any other photo is decoded and resized to
    size^2 by `native_loader.decode_image`, as in the JAX package."""
    from PIL import Image

    from ..utils.alignment import align_face, load_landmarks
    from ..utils.native_loader import decode_image

    if prepared:
        paths = sorted(os.path.join(prepared, f) for f in os.listdir(prepared)
                       if f.endswith(".jpg") or f.endswith(".png"))
    elif id_image is None:
        return np.random.RandomState(0).randint(
            0, 256, size=(1, 3, size, size), dtype=np.uint8).astype(np.uint8)
    else:
        paths = [id_image]
    imgs = []
    for p in paths:
        lm_path = _find_landmarks(align_lm, p) if align_lm else None
        if lm_path is not None:
            raw = np.asarray(Image.open(p).convert("RGB"))
            img = align_face(raw, load_landmarks(lm_path), output_size=size).transpose(2, 0, 1)
        else:
            img = decode_image(p, size, size)
        imgs.append(img[None])
    return np.concatenate(imgs, axis=0)


def orbit_label(i: int, frame_num: int, dataset: str, rendering_kwargs,
                id_image: str = "") -> torch.Tensor:
    """Frame i's [1, 25] camera label on the reference's orbit."""
    if dataset == "shapenet":
        yaw = 2 * math.pi * i / (frame_num - 1)
        radius = 1.3 if "cars" in id_image else 2.0
        c2w = camera.lookat_sample_srn(yaw, math.pi / 3, radius=radius)
        intr = camera.SHAPENET_INTRINSICS
    else:
        pitch_range, yaw_range = 0.3, 0.7
        c2w = camera.lookat_sample(
            3.14 / 2 + yaw_range * np.sin(2 * 3.14 * i / frame_num),
            3.14 / 2 - 0.05 + pitch_range * np.cos(2 * 3.14 * i / frame_num),
            radius=rendering_kwargs["avg_camera_radius"])
        intr = camera.FFHQ_INTRINSICS
    return camera.pose_to_label(c2w, intr)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1,1] NCHW float -> NHWC uint8 (reference `gen_videos.py:173`)."""
    img = np.asarray(img) * 127.5 + 128
    return np.clip(img, 0, 255).astype(np.uint8).transpose(0, 2, 3, 1)


def normalize_depth(depth: np.ndarray) -> np.ndarray:
    hi, lo = depth.max(), depth.min()
    d = (depth - lo) * (255 / max(hi - lo, 1e-8))
    return np.clip(d, 0, 255).astype(np.uint8)


def u8(img: torch.Tensor) -> torch.Tensor:
    """On-device [-1,1] -> uint8, same layout: `* 127.5 + 128`, clip, and a
    truncating cast."""
    return (img.float() * 127.5 + 128).clamp(0, 255).to(torch.uint8)


def load_networks(network: Optional[str], seed_init: Optional[int] = None, device=None,
                  double_sampling: bool = True, fallback_config: Optional[dict] = None):
    """(G, E) for inference, from an npz checkpoint or random init from
    `seed_init`: G from PRNGKey(seed_init) and E from PRNGKey(seed_init + 1),
    drawn on `device`, as the JAX CLI builds them. A checkpoint is loaded
    into networks built on `meta` (nothing drawn). G comes from `G_ema`
    (else `G`), built from the checkpoint's `generator` config, else from
    `fallback_config` (the default G when None); E is None when the
    checkpoint has none. `double_sampling` doubles G's samples per ray, as
    the reference does at inference. Parameters are frozen."""
    from ..models import ResNeXt50Encoder, TriPlaneGenerator
    from ..utils import checkpoint as ckpt

    device = resolve_device(device)
    if network:
        trees, config = ckpt.load_checkpoint(network)
        config = config or {}
        gen_cfg = dict(config.get("generator") or fallback_config or {})
        if gen_cfg.get("rendering_kwargs"):  # JSON lists back to tuples
            gen_cfg["rendering_kwargs"] = {k: tuple(v) if isinstance(v, list) else v
                                           for k, v in gen_cfg["rendering_kwargs"].items()}
        g = ckpt.load_jax_params(TriPlaneGenerator(**gen_cfg, device="meta"),
                                 trees.get("G_ema", trees.get("G")), device=device)
        enc = None
        if "E" in trees:
            # The port also reads an optional `encoder` entry (e.g. `layers`).
            enc = ResNeXt50Encoder(out_dim=g.z_dim, **config.get("encoder", {}), device="meta")
            state_e = trees.get("E_state")
            if state_e is None:  # default BN statistics
                state_e = ckpt.default_bn_state(enc)
            ckpt.load_jax_params(enc, trees["E"], state_e, device=device)
    else:
        if seed_init is None:
            raise ValueError("--network or --seed-init required")
        g = TriPlaneGenerator(device=device, key=prng.PRNGKey(seed_init))
        enc = ResNeXt50Encoder(out_dim=g.z_dim, device=device, key=prng.PRNGKey(seed_init + 1))
    if double_sampling:
        rk = g.rendering_kwargs
        rk["depth_resolution"] = int(rk["depth_resolution"] * 2)
        rk["depth_resolution_importance"] = int(rk["depth_resolution_importance"] * 2)
    for net in (g, enc):
        if net is not None:
            net.requires_grad_(False).eval()
    return g, enc


@torch.inference_mode()
@profiled_function("video.identity")
def prepare_identity(g, enc, id_images: np.ndarray, truncation_psi: float = 1.0,
                     dtype: torch.dtype = torch.bfloat16):
    """Identity-level compute, once: uint8 photos -> (ws, planes)."""
    device = next(g.parameters()).device
    imgs = torch.as_tensor(id_images, device=device).float() / 127.5 - 1.0
    z = enc.apply(imgs, train=False)
    c0 = torch.zeros((z.shape[0], 25), device=device)
    ws = g.mapping(z, c0, truncation_psi=truncation_psi)
    planes = g.backbone_planes(ws, noise_mode="const", dtype=dtype)
    return ws, planes


@torch.inference_mode()
def render_frame(g, planes, ws, c, res: int, dtype: torch.dtype = torch.bfloat16,
                 rendering_kwargs=None):
    """One camera label [1, 25] -> (image, image_raw) as uint8 NCHW on the
    device, and whether both float images were finite (a device bool).
    `rendering_kwargs` overrides G's per call (the mesh's `ray_sharding`)."""
    c = c.to(planes.device).expand(planes.shape[0], -1)
    out = g.render_planes(planes, c, ws, neural_rendering_resolution=res,
                          noise_mode="const", dtype=dtype, rendering_kwargs=rendering_kwargs)
    finite = torch.isfinite(out["image"]).all() & torch.isfinite(out["image_raw"]).all()
    return u8(out["image"]), u8(out["image_raw"]), finite


# G -> its `_FrameGraph`: a graph and its memory pool live as long as their G.
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream the frame graphs of `device` are warmed up and
    captured on: cuBLAS and cuDNN set up their workspaces for it once,
    outside any capture."""
    return torch.cuda.Stream(device)


class _FrameGraph:
    """`render_frame`'s work for one G, captured as a CUDA graph from a
    memory pool of its own, reading static copies of (planes, ws, label).
    The first frame runs eagerly on the side stream before the capture, so
    that every lazy set-up (kernel builds, workspaces, cached resize
    weights) happens outside it; its outputs are `first`. Not for
    concurrent use: inputs and outputs are copied in and out around each
    replay, on one thread."""

    def __init__(self, key, fn, owner, planes, ws, label):
        self.key, self.bound = key, weakref.ref(owner)
        self.planes, self.ws, self.label = planes.clone(), ws.clone(), label.clone()
        side = _capture_stream(planes.device)
        current = torch.cuda.current_stream(planes.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.first = fn(self.planes, self.ws, self.label)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self.outputs = fn(self.planes, self.ws, self.label)
        current.wait_stream(side)
        for t in self.first:
            t.record_stream(current)

    def replay(self, owner, planes, ws, label) -> tuple:
        """The outputs (copies) for `label` and `owner`'s (planes, ws); these
        are copied in only where another owner's are in place."""
        if self.bound() is not owner:
            self.planes.copy_(planes)
            self.ws.copy_(ws)
            self.bound = weakref.ref(owner)
        self.label.copy_(label)
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)


class IdentityFrames:
    """`render_frame` for one identity's (planes, ws) under one camera label
    after another; planes and ws are read once, so they must not change
    while it is in use. On CUDA, without ray sharding, frames replay G's
    CUDA graph of the frame's work (one launch a frame in place of several
    hundred, so that the host no longer paces the card). The graph is
    captured at the first frame that finds none of this key (G's storage,
    the inputs' shapes and the rendering options), that frame running
    eagerly, and serves later videos of the same key; another key's capture
    replaces it. A replay runs the eager frame's kernels on the same
    inputs, but the kernels' `.launches` counters see only the eager frame
    and the capture. Elsewhere every frame runs eagerly."""

    def __init__(self, g, planes, ws, res: int, dtype: torch.dtype = torch.bfloat16,
                 rendering_kwargs=None):
        self.args = (g, planes, ws)
        self.res, self.dtype, self.rendering_kwargs = res, dtype, rendering_kwargs
        self.key = None
        if planes.is_cuda and rendering_kwargs is None:
            # G's storage (a graph reads its weights where they were), the
            # inputs' shapes and the rendering options.
            self.key = (tuple(t.data_ptr() for t in itertools.chain(g.parameters(), g.buffers())),
                        planes.device, tuple(planes.shape), planes.dtype, tuple(ws.shape),
                        ws.dtype, res, dtype, repr(sorted(g.rendering_kwargs.items())))

    @torch.inference_mode()
    def __call__(self, c: torch.Tensor):
        """(image, image_raw) uint8 NCHW on the device and the finite flag,
        as `render_frame` gives them, for the label c [1, 25] (on the
        planes' device)."""
        g, planes, ws = self.args
        if self.key is None:
            return render_frame(g, planes, ws, c, self.res, self.dtype, self.rendering_kwargs)
        graph = _GRAPHS.get(g)
        if graph is None or graph.key != self.key:
            _GRAPHS.pop(g, None)  # the old graph and its pool go before the next capture
            graph = _GRAPHS[g] = _FrameGraph(self.key, lambda p, w, label: render_frame(
                g, p, w, label, self.res, self.dtype), self, planes, ws, c)
            first, graph.first = graph.first, None
            return first
        return graph.replay(self, planes, ws, c)


def render_video(g, planes, ws, labels: torch.Tensor, res: int,
                 dtype: torch.dtype = torch.bfloat16, mesh=None):
    """The video's frame loop: one frame's work a label (`IdentityFrames`:
    `render_frame`, replayed from a CUDA graph on the card), one copy to the
    host a chunk of `CHUNK` frames. Yields, per chunk, (image [F, H,
    W * n_ids, 3], image_raw likewise: uint8 numpy arrays, the identities
    side by side; None on ranks other than 0) and the chunk's finite flag
    for this rank's frames (a device bool).

    Under a mesh each chunk is ceil(min(CHUNK, frames) / data) * data
    frames, the tail padded with the last label; each data rank renders its
    contiguous part and the frames are gathered, padding dropped, before
    rank 0 copies them. Spans: `video.frame` (a frame's launches),
    `video.to_host` (a chunk's copy). `render_video.frames` and
    `render_video.chunks` count this rank's rendered frames and chunks."""
    from ..parallel import all_gather, process_info

    rank = process_info()[0]
    frames = labels.shape[0]
    data = mesh.data if mesh is not None else 1
    chunk = math.ceil(min(CHUNK, frames) / data) * data
    per_rank = chunk // data
    rk = {"ray_sharding": mesh} if mesh is not None and mesh.rays > 1 else None
    frame = IdentityFrames(g, planes, ws, res, dtype, rk)
    labels = labels.to(planes.device)  # one copy: a copy from the host waits for the card
    for start in range(0, frames, chunk):
        n_valid = min(chunk, frames - start)
        ids = [min(i, frames - 1) for i in range(start, start + (chunk if mesh else n_valid))]
        if mesh is not None:
            ids = ids[mesh.data_rank * per_rank:(mesh.data_rank + 1) * per_rank]
        imgs, raws = [], []
        finite = torch.ones((), dtype=torch.bool, device=planes.device)
        for i in ids:
            with span("video.frame"):
                img, raw, ok = frame(labels[i: i + 1])
            imgs.append(img)
            raws.append(raw)
            finite &= ok
        render_video.frames += len(ids)
        render_video.chunks += 1
        imgs, raws = torch.stack(imgs), torch.stack(raws)
        if mesh is not None:  # every data rank's frames, in chunk order; padding dropped
            imgs = all_gather(imgs, mesh.data_group)[:n_valid]
            raws = all_gather(raws, mesh.data_group)[:n_valid]
        if rank != 0:
            yield None, None, finite
            continue
        with span("video.to_host"):
            imgs = imgs.permute(0, 3, 1, 4, 2).flatten(2, 3).cpu().numpy()
            raws = raws.permute(0, 3, 1, 4, 2).flatten(2, 3).cpu().numpy()
        yield imgs, raws, finite


render_video.frames = render_video.chunks = 0


def generate_videos(
    network: Optional[str],
    id_image: Optional[str] = None,
    prepared: Optional[str] = None,
    video_out_path: str = "video_results/",
    outdir: str = "video_results/",
    res: int = 64,
    frames: int = 120,
    dataset: str = "ffhq",
    gen_shapes: bool = False,
    seed_init: Optional[int] = None,
    shape_res: int = 512,
    truncation_psi: float = 1.0,
    fp32: bool = False,
    label_path: Optional[str] = None,
    ray_shards: int = 1,
    align_lm: str = "",
    device=None,
) -> dict:
    """Render the orbit video(s). Runs on CUDA unless `device` names another
    device; under torchrun (or an initialised process group) over the
    (data, rays) mesh of its ranks, `ray_shards` of which split each frame's
    rays. Returns, on rank 0, {'video', 'video_raw': output paths, 'frames',
    'frames_raw': uint8 [F, H, W * n_ids, 3], 'finite': bool} and, with
    `gen_shapes`, 'mrc': the sigma volume's path; None on the other ranks."""
    from ..parallel import all_reduce, init_distributed, make_mesh, process_info
    from .video_io import VideoWriter

    device = resolve_device(device)
    init_distributed(device)
    rank, world = process_info()
    ray_shards = max(1, int(ray_shards))
    if world == 1 and ray_shards > 1:
        print(f"--ray_shards {ray_shards} ignored: single device attached")
        ray_shards = 1
    if world % ray_shards:  # refused, not clamped, as the JAX CLI and train.py do
        raise ValueError(f"--ray_shards {ray_shards} must divide device count {world}")
    mesh = make_mesh(data=world // ray_shards, rays=ray_shards)  # None without a group
    g, enc = load_networks(network, seed_init, device)
    if enc is None:
        raise ValueError(f"{network} holds no encoder E")
    # ShapeNet photos reach E at G's output side, unresized from the SRN
    # renders' 128^2, as the reference reads them; other photos at 512^2.
    side = g.superresolution.img_resolution if dataset == "shapenet" else 512
    id_images = _load_images(id_image, prepared, align_lm=align_lm, size=side)
    dtype = torch.float32 if fp32 else torch.bfloat16
    ws, planes = prepare_identity(g, enc, id_images, truncation_psi, dtype)

    if label_path:
        with open(label_path) as f:
            raw = json.load(f)
        vals = list(raw.values()) if isinstance(raw, dict) else raw
        labels = torch.as_tensor(np.asarray(vals, dtype=np.float32))
        frames = labels.shape[0]
    else:
        labels = torch.cat([orbit_label(i, frames, dataset, g.rendering_kwargs, id_image or "")
                            for i in range(frames)], dim=0)

    name = os.path.basename(prepared or id_image or "seedinit").split(".")[0]
    if rank == 0:
        os.makedirs(video_out_path, exist_ok=True)
        writer = VideoWriter(os.path.join(video_out_path, name + ".mp4"), fps=30)
        writer_raw = VideoWriter(os.path.join(video_out_path, name + "_raw.mp4"), fps=30)
    finite = torch.ones((), dtype=torch.bool, device=device)
    all_imgs, all_raws = [], []
    for imgs, raws, ok in render_video(g, planes, ws, labels, res, dtype, mesh):
        finite &= ok
        if rank != 0:
            continue
        for img, raw in zip(imgs, raws):
            writer.append_data(img)
            writer_raw.append_data(raw)
        all_imgs.append(imgs)
        all_raws.append(raws)
    if mesh is not None:
        finite = all_reduce((~finite).float(), mesh.group) == 0
    result = None
    if rank == 0:
        writer.close()
        writer_raw.close()
        print(f"wrote {writer.output_path} ({frames} frames)")
        result = {"video": writer.output_path, "video_raw": writer_raw.output_path,
                  "frames": np.concatenate(all_imgs), "frames_raw": np.concatenate(all_raws),
                  "finite": bool(finite.item())}

    if gen_shapes:  # the first identity's sigma volume, fp32 planes
        from .shape_utils import extract_sigma_grid, write_mrc

        t0 = time.perf_counter()
        sigmas = extract_sigma_grid(g, ws[:1], voxel_resolution=shape_res,
                                    cube_length=g.rendering_kwargs["box_warp"], mesh=mesh,
                                    device=device)
        secs = time.perf_counter() - t0
        if rank == 0:
            os.makedirs(os.path.join(outdir, name), exist_ok=True)
            result["mrc"] = os.path.join(outdir, name, f"{frames - 1}.mrc")
            write_mrc(result["mrc"], sigmas)
            print(f"wrote {result['mrc']} ({shape_res}^3 sigma volume, swept in {secs:.3f} s)")
    return result


@click.command()
@click.option("--network", "network", help="Checkpoint (.npz)", default=None)
@click.option("--id_image", "id_image", help="Identity reference image", default=None)
@click.option("--prepared", "prepared", help="Folder of identity images", default=None)
@click.option("--gen_shapes", "gen_shapes", type=bool, default=False)
@click.option("--video_out_path", type=str, default="video_results/")
@click.option("--outdir", type=str, default="video_results/")
@click.option("--res", type=int, default=64, help="Neural render resolution")
@click.option("--frames", type=int, default=120)
@click.option("--dataset", type=str, default="ffhq")
@click.option("--seed-init", "seed_init", type=int, default=None,
              help="Random-init networks instead of loading a checkpoint")
@click.option("--shape-res", "shape_res", type=int, default=512)
@click.option("--fp32", is_flag=True, default=False,
              help="Full fp32 compute (default: bf16 backbone/SR)")
@click.option("--label_path", default=None,
              help="JSON of 25-dim camera labels to render instead of the orbit")
@click.option("--ray_shards", type=int, default=1,
              help="Shard each frame's rays over this many ranks (torchrun; must divide "
                   "their number): the 2-D frames x rays inference mesh")
@click.option("--align_lm", default="",
              help="Folder of per-image 68-pt landmark files (<stem>.json/.npy/.txt); "
                   "photos with landmarks are FFHQ-aligned before encoding")
@click.option("--device", default=None, help="Device to run on (default: cuda)")
def main(**kwargs):
    generate_videos(**kwargs)


if __name__ == "__main__":
    main()
