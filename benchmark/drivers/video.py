"""Closed loop, one client: a photo to a video through the video CLI's own
frame loop, again and again.

Each unit of work is `gen_videos.prepare_identity` of the next seeded photo
(E, the mapping and the backbone: the program's `video.identity` span),
then `gen_videos.render_video` over the orbit's labels: one render call a
frame, one copy to the host a chunk, `image` and `image_raw` both
delivered. The labels are the CLI's `orbit_label` for the configuration's
`dataset` and `category`, made once in set-up. The window runs whole
videos until `--seconds` have passed; `frames_per_s` is every frame
delivered to the host over the time from the first call to the last
frame. From each video the frames at three positions drawn from the seed
are kept; once the window has closed, `check_videos` of the finished
videos, drawn from the seed, are compared frame by frame, both images,
with `reference/gnerf_shapenet.py`'s frames of the same photo and pose.
A video with a frame that is not finite counts as failed.

G and E are built on `meta` and loaded from `weights.draw`'s seeded trees
(E's BatchNorm statistics fitted to seeded photos, as `gnerf_infer.Setup`
does), with the samples per ray doubled as `gen_videos.load_networks`
doubles them.

Mix parameters (traffic/<mix>.json): frames, photos, check_videos,
warmup_videos, trace_seconds, span_seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import gnerf_infer, roofline, trace, weights
from benchmark.reference import gnerf as ref
from benchmark.reference import gnerf_shapenet as ref_sn

# Every kernel the loop launches (threefry: the program's draws, none with
# constant noise and no key, built so that none builds inside the window).
KERNELS = ("osg_decode", "threefry", "upfirdn2d", "triplane_sample", "modconv_epilogue")
# Eager frames profiled after a traced run's windows, whose frames replay a
# CUDA graph that no span around the program's methods sees.
EAGER_FRAMES = 8


def generator_kwargs(cfg: dict) -> dict:
    """TriPlaneGenerator's keyword arguments for the configuration, before
    the doubling of samples that inference applies (JSON-ready: the video
    CLI reads them as a checkpoint's `generator` entry)."""
    from gnerf_tpu_torch.models.triplane import DEFAULT_RENDERING_KWARGS

    g = cfg["generator"]
    rk = dict(DEFAULT_RENDERING_KWARGS)
    rk.update({k: g[k] for k in ("superresolution_module", "depth_resolution",
                                 "depth_resolution_importance", "ray_start", "ray_end",
                                 "box_warp", "white_back", "avg_camera_radius",
                                 "avg_camera_pivot")})
    keys = ("z_dim", "c_dim", "w_dim", "img_resolution", "plane_resolution", "plane_channels",
            "mapping_layers", "channel_base", "channel_max", "neural_rendering_resolution")
    return dict({k: g[k] for k in keys}, rendering_kwargs=rk)


def program(cfg: dict, host: dict, device) -> tuple:
    """(G, E) under test, loaded from `host` on `device`, frozen."""
    from gnerf_tpu_torch.models import ResNeXt50Encoder, TriPlaneGenerator
    from gnerf_tpu_torch.utils.checkpoint import load_jax_params

    gen = load_jax_params(TriPlaneGenerator(**generator_kwargs(cfg), device="meta"), host["G"],
                          device=device)
    if cfg["generator"]["double_sampling"]:
        gen.rendering_kwargs["depth_resolution"] *= 2
        gen.rendering_kwargs["depth_resolution_importance"] *= 2
    enc = load_jax_params(ResNeXt50Encoder(out_dim=cfg["encoder"]["out_dim"],
                                           layers=tuple(cfg["encoder"]["layers"]), device="meta"),
                          host["E"], device=device)
    for net in (gen, enc):
        net.requires_grad_(False).eval()
    return gen, enc


def reference_modules(cfg: dict):
    """(G, E) of the plain reference on `meta`, at the configuration's sizes."""
    g = cfg["generator"]
    twice = 2 if g["double_sampling"] else 1
    gen = ref_sn.Generator(
        white_back=g["white_back"], z_dim=g["z_dim"], c_dim=g["c_dim"], w_dim=g["w_dim"],
        plane_resolution=g["plane_resolution"], plane_channels=g["plane_channels"],
        mapping_layers=g["mapping_layers"], channel_base=g["channel_base"],
        channel_max=g["channel_max"], neural_res=g["neural_rendering_resolution"],
        depth_resolution=g["depth_resolution"] * twice,
        depth_resolution_importance=g["depth_resolution_importance"] * twice,
        ray_start=g["ray_start"], ray_end=g["ray_end"], box_warp=g["box_warp"])
    enc = ref.Encoder(out_dim=cfg["encoder"]["out_dim"], layers=tuple(cfg["encoder"]["layers"]))
    return gen, enc


def reference_frames(cfg: dict, host: dict, photos_u8, poses, dtype, device) -> list:
    """The reference's (image, raw image) uint8 pairs at `poses` of (photo
    index, yaw, pitch), computed in `dtype` (ref.FP8 for the control), one
    identity at a time."""
    g, e = reference_modules(cfg)
    ref.load_state(g, host["G"], device)
    ref.load_state(e, host["E"], device)
    radius = cfg["orbit"]["radius"]
    out: list = [None] * len(poses)
    by_photo: dict = {}
    for i, (p, yaw, pitch) in enumerate(poses):
        by_photo.setdefault(p, []).append((i, yaw, pitch))
    for p, items in by_photo.items():
        ws, planes = ref.identity(g, e, torch.as_tensor(photos_u8[p]), dtype)
        for i, yaw, pitch in items:
            out[i] = tuple(t.cpu().numpy() for t in ref_sn.frame(g, ws, planes, yaw, pitch, dtype,
                                                                   radius))
    return out


def frame_gaps(want: list, got: list) -> tuple[float, int, float]:
    """(worst mean |gap|, largest |gap|) in uint8 levels over pairs of
    (image, raw image), both images of every pair, and the worst mean |gap|
    of the raw images alone."""
    a = [x for pair in want for x in pair]
    b = [x for pair in got for x in pair]
    raw = gnerf_infer.worst_mad([w[1] for w in want], [g[1] for g in got])
    return gnerf_infer.worst_mad(a, b), gnerf_infer.max_gap(a, b), raw


class Driver:
    def __init__(self, cell, log):
        self.cell, self.log = cell, log
        self.attempted = self.failed = 0
        self.frames = int(cell.traffic["frames"])
        self.setup_parts: dict = {}
        self.kept: list = []   # per video: (photo, frame index, image, raw image)
        self.counters: dict = {}
        self.flops: dict = {}
        self.host_frame_s = 0.0
        self.eager, self.eager_frames = None, 0
        self._unwrap = None

    def setup(self) -> None:
        from benchmark.harness import process_age_s
        from gnerf_tpu_torch.infer import gen_videos
        from gnerf_tpu_torch.utils.device import resolve_device

        if not hasattr(gen_videos, "render_video"):
            raise SystemExit("benchmark: this program has no gen_videos.render_video, "
                             "the video CLI's frame loop that this cell drives")
        self.gv = gen_videos
        cell, cfg = self.cell, self.cell.config
        parts = self.setup_parts
        parts["import_s"] = process_age_s()
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            if cell.device == "cuda":
                torch.cuda.synchronize()
            now = time.perf_counter()
            parts[name] = now - t
            t = now

        # The CLI's device and precision policy: fp32 is true fp32 (TF32 off).
        resolve_device(cell.device)
        if cell.device == "cuda":
            from gnerf_tpu_torch.ops import cuda_build

            torch.zeros(1, device=cell.device).sum().item()
            cuda_build.build(KERNELS)
        lap("build_s")
        side = cfg["encoder"]["image"]
        self.photos = gnerf_infer.photos(cell.seed + 1, int(cell.traffic["photos"]), side,
                                         cell.device)
        rg, re_ = reference_modules(cfg)
        trees = weights.draw({"G": rg, "E": re_}, cell.seed, cell.device)
        weights.fit_bn(re_, trees["E"], gnerf_infer.photos(cell.seed + 2, 8, side, cell.device),
                       cell.device)
        del re_
        self.host = weights.to_host(trees)
        del trees
        lap("draw_s")
        self.g, self.enc = program(cfg, self.host, cell.device)
        self.dtype = gnerf_infer.DTYPES[cfg["dtype"]["backbone"]]
        orbit = cfg["orbit"]
        self.labels = torch.cat([gen_videos.orbit_label(i, self.frames, orbit["dataset"],
                                                        self.g.rendering_kwargs,
                                                        orbit["category"])
                                 for i in range(self.frames)])
        lap("load_s")
        for v in range(int(cell.traffic.get("warmup_videos", 2))):
            self._video(v, keep=False)
        lap("warmup_s")
        if cell.trace:
            trace.wrap(self.g, "render_planes", "render")
            trace.wrap(self.g.superresolution, "forward", "sr")
            self._time_frames()

    def _time_frames(self) -> None:
        """Host seconds inside each frame's call of the loop's
        `IdentityFrames` (one frame's launches, the program's `video.frame`
        span) into `host_frame_s`."""
        cls = self.gv.IdentityFrames
        inner = cls.__call__

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                self.host_frame_s += time.perf_counter() - t

        cls.__call__ = timed
        self._unwrap = lambda: setattr(cls, "__call__", inner)

    def _eager_frames(self) -> trace.Trace:
        """The profile of `render_frame` called eagerly for the first
        photo's first `EAGER_FRAMES` frames (at most): the same kernels as the
        window's replays, inside the `render` and `sr` spans."""
        ws, planes = self.gv.prepare_identity(self.g, self.enc, self.photos[:1], dtype=self.dtype)
        labels = self.labels.to(planes.device)
        res = self.cell.config["generator"]["neural_rendering_resolution"]
        box: dict = {}
        self.eager_frames = min(EAGER_FRAMES, self.frames)
        with trace.profiled(box, spans=True):
            for i in range(self.eager_frames):
                self.gv.render_frame(self.g, planes, ws, labels[i:i + 1], res, self.dtype)
        spans = box["trace"].spans
        self.log(f"{self.eager_frames} eager frames, device s in spans: "
                 f"{ {k: v for k, v in spans.items() if k in ('render', 'sr')} }")
        return box["trace"]

    def _positions(self, video: int) -> list:
        rng = np.random.default_rng([self.cell.seed, video, 3])
        return sorted(rng.choice(self.frames, size=3, replace=False).tolist())

    def _video(self, video: int, keep: bool) -> tuple[int, bool]:
        """One video: (frames delivered, whether every frame was finite)."""
        p = video % len(self.photos)
        ws, planes = self.gv.prepare_identity(self.g, self.enc, self.photos[p:p + 1],
                                              dtype=self.dtype)
        want = set(self._positions(video)) if keep else set()
        kept, n, finite = [], 0, []
        res = self.cell.config["generator"]["neural_rendering_resolution"]
        for imgs, raws, ok in self.gv.render_video(self.g, planes, ws, self.labels, res,
                                                   self.dtype):
            kept += [(p, n + j, imgs[j], raws[j]) for j in range(len(imgs)) if n + j in want]
            n += len(imgs)
            finite.append(ok)
        if keep:
            self.kept.append(kept)
        return n, bool(torch.stack(finite).all())

    def window(self, seconds: float) -> dict:
        rv = self.gv.render_video
        f0, c0, h0 = rv.frames, rv.chunks, self.host_frame_s
        t0 = time.perf_counter()
        frames = videos = failed = 0
        while time.perf_counter() - t0 < seconds:
            n, finite = self._video(videos, keep=True)
            frames += n
            videos += 1
            failed += not finite
        elapsed = time.perf_counter() - t0
        self.attempted, self.failed = videos, failed
        self.counters = {"frames": rv.frames - f0, "chunks": rv.chunks - c0, "videos": videos,
                         "host_frame_s": self.host_frame_s - h0}
        self.log(f"window {elapsed:.3f} s: {videos} videos, {frames} frames delivered, "
                 f"{failed} failed; program counters {self.counters}")
        return {"frames_per_s": frames / elapsed}

    def release(self) -> None:
        """Free the program's state before the reference runs; in a traced
        run, first profile `EAGER_FRAMES` eager frames with the spans on."""
        if self._unwrap is not None:
            self._unwrap()
            self._unwrap = None
        if self.cell.trace and self.g is not None:
            self.eager = self._eager_frames()
        self.g = self.enc = None
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def samples(self) -> list:
        """(photo index, yaw, pitch, image, raw image) of the frames to compare."""
        rng = np.random.default_rng([self.cell.seed, 5])
        k = min(int(self.cell.traffic["check_videos"]), len(self.kept))
        chosen = sorted(rng.choice(len(self.kept), size=k, replace=False).tolist())
        return [(p, *ref_sn.orbit_pose(i, self.frames), img, raw)
                for v in chosen for p, i, img, raw in self.kept[v]]

    def reference(self, samples: list, dtype) -> list:
        return reference_frames(self.cell.config, self.host, self.photos,
                                [s[:3] for s in samples], dtype, self.cell.device)

    def check(self) -> list:
        """`frame_mad`, the largest mean |program - reference| of a frame,
        and `frame_max_gap`, the largest of any pixel, both in uint8 levels
        over `image` and `image_raw`; `raw_mad`, the largest mean gap of an
        `image_raw` alone (the render's own 64^2 image, which SR2X's bf16
        convolutions have not yet spread: it sees a render gone wrong, such
        as samples not doubled, that the 128^2 image's gap hides);
        `frames_unchecked`, 1 when no frame was there to compare. The
        reference runs in the configuration's precision, TF32 off."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        samples = self.samples()
        mad, top, raw = frame_gaps(self.reference(samples, self.dtype), [s[3:] for s in samples])
        limits = self.cell.config["limits"]
        self.log(f"frame_mad {mad!r}, frame_max_gap {top}, raw_mad {raw!r} over "
                 f"{len(samples)} frame pairs")
        if self.cell.trace:
            self.flops = self.count_flops()
        return [["frame_mad", mad, float(limits["frame_mad"])],
                ["frame_max_gap", top, int(limits["frame_max_gap"])],
                ["raw_mad", raw, float(limits["raw_mad"])],
                ["frames_unchecked", 0 if samples else 1, 0]]

    def control(self) -> dict:
        """The readings the limits are set from, after `release`: the
        program against the reference (lower) and the control, the
        reference with its bf16 parts in float8 e4m3 and TF32 on, against
        the reference (upper)."""
        samples = self.samples()
        got = [s[3:] for s in samples]
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        try:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            want = self.reference(samples, self.dtype)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            fp8 = self.reference(samples, ref.FP8)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        lower, upper = frame_gaps(want, got), frame_gaps(want, fp8)
        return {"seed": self.cell.seed, "frames": len(samples), "lower": lower[0],
                "lower_max_gap": lower[1], "lower_raw": lower[2], "upper": upper[0],
                "upper_max_gap": upper[1], "upper_raw": upper[2]}

    def count_flops(self) -> dict:
        """FLOPs of one identity's preparation and of one frame, counted
        over the reference at the cell's shapes."""
        g, e = reference_modules(self.cell.config)
        ref.load_state(g, self.host["G"], self.cell.device)
        ref.load_state(e, self.host["E"], self.cell.device)
        prep, (ws, planes) = roofline.count_flops(ref.identity, g, e,
                                                  torch.as_tensor(self.photos[0]), self.dtype)
        frame, _ = roofline.count_flops(ref_sn.frame, g, ws, planes,
                                        *ref_sn.orbit_pose(0, self.frames), self.dtype)
        return {"prep": prep, "frame": frame}

    def reading(self, tr: trace.Trace) -> dict:
        g = self.cell.config["generator"]
        m = g["neural_rendering_resolution"] ** 2 * g["depth_resolution"] * (
            2 if g["double_sampling"] else 1)
        return {"trace": tr, "counters": self.counters, "flops": self.flops,
                "eager": self.eager, "eager_frames": self.eager_frames,
                "decoder_bound_s": roofline.decoder_bound_s(
                    1, m, g["plane_channels"], g["decoder_hidden"], 1 + g["decoder_output_dim"],
                    self.cell.config["dtype"]["planes"] == "bf16"),
                "peak_flops": roofline.PEAK_FLOPS["bf16"]}
