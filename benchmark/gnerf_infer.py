"""G-NeRF inference cells' common parts: seeded inputs, the program under
test (`GNerfService` over G and E loaded through the checkpoint path), and
the comparison of served frames with the frozen reference.

The weights come from `weights.draw` in the JAX layout, on the device (E's
BatchNorm statistics fitted to a batch of seeded photos, `weights.fit_bn`),
and reach the program through `utils.checkpoint.load_jax_params` into modules
built on `meta`, with the samples per ray doubled at load, as
`gen_videos.load_networks` does. The reference gets the same host copy.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.reference import gnerf as ref

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def photos(seed: int, count: int, side: int, device) -> np.ndarray:
    """[count, 3, side, side] uint8 photos from the seed: smooth colour fields
    (16^2 noise, bilinear to side^2) with pixel noise, made on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    low = torch.rand((count, 3, 16, 16), generator=gen, device=device)
    img = F.interpolate(low, size=(side, side), mode="bilinear", align_corners=False)
    img = img + 0.05 * torch.randn((count, 3, side, side), generator=gen, device=device)
    return (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()


def reference_modules(cfg: dict):
    """(G, E) of the frozen reference on `meta`, at the configuration's sizes."""
    g = cfg["generator"]
    gen = ref.Generator(
        z_dim=g["z_dim"], c_dim=g["c_dim"], w_dim=g["w_dim"],
        plane_resolution=g["plane_resolution"], plane_channels=g["plane_channels"],
        mapping_layers=g["mapping_layers"], channel_base=g["channel_base"],
        channel_max=g["channel_max"], neural_res=g["neural_rendering_resolution"],
        depth_resolution=g["depth_resolution"] * (2 if g["double_sampling"] else 1),
        depth_resolution_importance=g["depth_resolution_importance"]
        * (2 if g["double_sampling"] else 1),
        ray_start=g["ray_start"], ray_end=g["ray_end"], box_warp=g["box_warp"])
    enc = ref.Encoder(out_dim=cfg["encoder"]["out_dim"], layers=tuple(cfg["encoder"]["layers"]))
    return gen, enc


def program(cfg: dict, host: dict, device: str, service_kwargs: dict):
    """The program under test: a GNerfService over G and E loaded from `host`,
    on `device` alone."""
    from gnerf_tpu_torch.infer.server import GNerfService
    from gnerf_tpu_torch.models import ResNeXt50Encoder, TriPlaneGenerator
    from gnerf_tpu_torch.models.triplane import DEFAULT_RENDERING_KWARGS
    from gnerf_tpu_torch.utils.checkpoint import load_jax_params

    g = cfg["generator"]
    rk = dict(DEFAULT_RENDERING_KWARGS)
    rk.update(superresolution_module=g["superresolution_module"],
              depth_resolution=g["depth_resolution"],
              depth_resolution_importance=g["depth_resolution_importance"],
              ray_start=g["ray_start"], ray_end=g["ray_end"], box_warp=g["box_warp"])
    gen = TriPlaneGenerator(
        z_dim=g["z_dim"], c_dim=g["c_dim"], w_dim=g["w_dim"],
        img_resolution=g["img_resolution"], plane_resolution=g["plane_resolution"],
        plane_channels=g["plane_channels"], mapping_layers=g["mapping_layers"],
        channel_base=g["channel_base"], channel_max=g["channel_max"],
        neural_rendering_resolution=g["neural_rendering_resolution"], rendering_kwargs=rk,
        device="meta")
    load_jax_params(gen, host["G"], device=device)
    if g["double_sampling"]:
        gen.rendering_kwargs["depth_resolution"] *= 2
        gen.rendering_kwargs["depth_resolution_importance"] *= 2
    enc = ResNeXt50Encoder(out_dim=cfg["encoder"]["out_dim"],
                           layers=tuple(cfg["encoder"]["layers"]), device="meta")
    load_jax_params(enc, host["E"], device=device)
    for net in (gen, enc):
        net.requires_grad_(False).eval()
    # The card G lives on alone, whatever the host shows: by default the
    # service keeps a replica of G on every visible card.
    return GNerfService(gen, enc, dtype=DTYPES[cfg["dtype"]["backbone"]], device=device,
                        devices=[next(gen.parameters()).device], **service_kwargs)


class Setup:
    """Builds the kernels, the weights and the service, timing each part."""

    def __init__(self, cell, service_kwargs: dict):
        from benchmark.harness import process_age_s

        self.cell = cell
        self.parts: dict = {"import_s": process_age_s()}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            if cell.device == "cuda":
                torch.cuda.synchronize()
            now = time.perf_counter()
            self.parts[name] = now - t
            t = now

        import gnerf_tpu_torch.infer.server  # noqa: F401 - the program's import cost
        from gnerf_tpu_torch.ops import cuda_build

        lap("program_import_s")
        if cell.device == "cuda":
            torch.zeros(1, device=cell.device).sum().item()
            lap("cuda_init_s")
            cuda_build.build(["osg_decode", "threefry"])
        lap("build_s")
        n = int(cell.traffic.get("photos", 64))
        self.photos = photos(cell.seed + 1, n, cell.config["encoder"]["image"], cell.device)
        lap("photos_s")
        rg, re_ = reference_modules(cell.config)
        trees = weights.draw({"G": rg, "E": re_}, cell.seed, cell.device)
        weights.fit_bn(re_, trees["E"], photos(cell.seed + 2, 8, cell.config["encoder"]["image"],
                                               cell.device), cell.device)
        del re_
        lap("draw_s")
        self.host = weights.to_host(trees)
        del trees
        lap("to_host_s")
        self.svc = program(cell.config, self.host, cell.device, service_kwargs)
        lap("load_s")

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.svc.close()
        self.svc = None
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def check_frames(cell, host: dict, photos_u8: np.ndarray, samples: list, log) -> list:
    """The compared numbers, each [name, value, limit], over `samples` of
    (photo index, yaw, pitch, frame): `frame_mad`, the largest over the
    frames of the mean |program - reference| in uint8 levels; `frame_max_gap`,
    the largest |program - reference| of any pixel; `frames_unchecked`, 1
    when no frame was there to compare. The reference runs in the
    configuration's precision, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = reference_frames(cell, host, photos_u8, [s[:3] for s in samples],
                            DTYPES[cell.config["dtype"]["backbone"]])
    got = [s[3] for s in samples]
    mad, top = worst_mad(want, got), max_gap(want, got)
    limits = cell.config["limits"]
    log(f"frame_mad {mad!r}, frame_max_gap {top} over {len(samples)} frames")
    return [["frame_mad", mad, float(limits["frame_mad"])],
            ["frame_max_gap", top, int(limits["frame_max_gap"])],
            ["frames_unchecked", 0 if samples else 1, 0]]


def reference_frames(cell, host, photos_u8, poses, dtype) -> list:
    """The reference's uint8 frames [H, W, 3] at `poses` of (photo index,
    yaw, pitch), computed in `dtype` (ref.FP8 for the control), one
    identity at a time."""
    g, e = reference_modules(cell.config)
    ref.load_state(g, host["G"], cell.device)
    ref.load_state(e, host["E"], cell.device)
    out: list = [None] * len(poses)
    by_photo: dict = {}
    for i, (p, yaw, pitch) in enumerate(poses):
        by_photo.setdefault(p, []).append((i, yaw, pitch))
    for p, items in by_photo.items():
        ws, planes = ref.identity(g, e, torch.as_tensor(photos_u8[p]), dtype)
        for i, yaw, pitch in items:
            out[i] = ref.frame(g, ws, planes, yaw, pitch, dtype).cpu().numpy()
    return out


def max_gap(frames_a, frames_b) -> int:
    """The largest |a - b| of any pixel over pairs of uint8 frames, in levels."""
    return max((int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())
                for a, b in zip(frames_a, frames_b)), default=0)


def worst_mad(frames_a, frames_b) -> float:
    """The largest mean |a - b| over pairs of uint8 frames, in levels."""
    return max((float(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).mean())
                for a, b in zip(frames_a, frames_b)), default=0.0)


def wrap_spans(svc) -> None:
    """The spans of a traced inference run, around the service's model
    calls: identity preparation (`prep.*`, inside `encode`), `render` and
    `sr` inside it."""
    from benchmark import trace

    trace.wrap(svc.enc, "apply", "prep.encoder")
    trace.wrap(svc.g, "mapping", "prep.mapping")
    trace.wrap(svc.g, "backbone_planes", "prep.backbone")
    trace.wrap(svc.g, "render_planes", "render")
    trace.wrap(svc.g.superresolution, "forward", "sr")
    trace.wrap(svc, "_encode_image", "encode")


def flops(cell, host, photo) -> dict:
    """FLOPs of one identity's preparation and of one frame, counted over
    the reference at the cell's shapes."""
    from benchmark import roofline

    g, e = reference_modules(cell.config)
    ref.load_state(g, host["G"], cell.device)
    ref.load_state(e, host["E"], cell.device)
    dtype = DTYPES[cell.config["dtype"]["backbone"]]
    prep, (ws, planes) = roofline.count_flops(ref.identity, g, e, torch.as_tensor(photo), dtype)
    frame, _ = roofline.count_flops(ref.frame, g, ws, planes, *front_pose(), dtype)
    return {"prep": prep, "frame": frame}


def sample_indices(seed: int, n: int, k: int) -> list:
    """k of range(n), drawn from the seed, sorted."""
    rng = np.random.default_rng([seed, 17])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist()) if n else []


def front_pose() -> tuple[float, float]:
    return math.pi / 2, math.pi / 2
