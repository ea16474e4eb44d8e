"""Closed loop, one client: a photo to an orbit video, again and again.

Each unit of work is `GNerfService.encode_image` of the next seeded photo,
then `render_orbit(identity, frames)`. The window runs whole videos until
`--seconds` have passed; `frames_per_s` is every frame delivered to the host
over the time from the first call to the last frame. From each video the
frames at three positions drawn from the seed are kept; once the window has
closed, `check_videos` of the finished videos, drawn from the seed, are
compared frame by frame with the reference.

Mix parameters (traffic/<mix>.json): frames, photos, check_videos,
trace_seconds, warmup_videos.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import gnerf_infer, roofline, trace
from benchmark.reference import gnerf as ref


class Driver:
    def __init__(self, cell, log):
        self.cell, self.log = cell, log
        self.attempted = self.failed = 0
        self.frames = int(cell.traffic["frames"])
        self.setup_parts: dict = {}
        self.kept: list = []   # (photo index, frame index, uint8 frame) per video
        self.counters: dict = {}
        self.flops: dict = {}

    def setup(self) -> None:
        self.s = gnerf_infer.Setup(self.cell, {})
        self.setup_parts = self.s.parts
        t = time.perf_counter()
        for v in range(int(self.cell.traffic.get("warmup_videos", 2))):
            self._video(v, keep=False)
        self.setup_parts["warmup_s"] = time.perf_counter() - t
        if self.cell.trace:
            gnerf_infer.wrap_spans(self.s.svc)
            trace.wrap(self.s.svc, "_render_orbit", "orbit")

    def _positions(self, video: int) -> list:
        rng = np.random.default_rng([self.cell.seed, video, 3])
        return sorted(rng.choice(self.frames, size=3, replace=False).tolist())

    def _video(self, video: int, keep: bool) -> int:
        p = video % len(self.s.photos)
        ident = self.s.svc.encode_image(self.s.photos[p])
        out = self.s.svc.render_orbit(ident, frames=self.frames)
        if keep:
            self.kept.append([(p, i, out[i]) for i in self._positions(video)])
        return len(out)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        frames = videos = 0
        while time.perf_counter() - t0 < seconds:
            frames += self._video(videos, keep=True)
            videos += 1
        elapsed = time.perf_counter() - t0
        self.attempted, self.counters = videos, {"frames": frames, "videos": videos}
        self.log(f"window {elapsed:.3f} s: {videos} videos, {frames} frames")
        return {"frames_per_s": frames / elapsed}

    def release(self) -> None:
        self.s.release()

    def samples(self) -> list:
        """(photo index, yaw, pitch, frame) of the frames to compare."""
        rng = np.random.default_rng([self.cell.seed, 5])
        k = min(int(self.cell.traffic["check_videos"]), len(self.kept))
        chosen = sorted(rng.choice(len(self.kept), size=k, replace=False).tolist())
        return [(p, *ref.orbit_pose(i, self.frames), frame)
                for v in chosen for p, i, frame in self.kept[v]]

    def check(self) -> list:
        checks = gnerf_infer.check_frames(self.cell, self.s.host, self.s.photos, self.samples(),
                                          self.log)
        if self.cell.trace:
            self.flops = gnerf_infer.flops(self.cell, self.s.host, self.s.photos[0])
        return checks

    def reading(self, tr: trace.Trace) -> dict:
        g = self.cell.config["generator"]
        m = 15 * g["neural_rendering_resolution"] ** 2 * g["depth_resolution"] * (
            2 if g["double_sampling"] else 1)
        return {"trace": tr, "counters": self.counters, "flops": self.flops,
                "decoder_bound_s": roofline.decoder_bound_s(
                    1, m, g["plane_channels"], 64, 33, self.cell.config["dtype"]["planes"] == "bf16"),
                "peak_flops": roofline.PEAK_FLOPS["bf16"]}

