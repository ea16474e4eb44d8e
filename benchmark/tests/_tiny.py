"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: a small
backbone, encoder and discriminator, few samples a ray (the
superresolution keeps its widths: it has no smaller form). For tests only;
no cell of the benchmark runs at these sizes."""

from __future__ import annotations

import json

from benchmark import harness

# Cells whose files stay in the benchmark while they wait outside
# BENCHMARK.json for a steadier service (PERF.md, Open questions):
# name -> (configuration, mix).
HELD = {"encode-ffhq512": ("gnerf-ffhq512", "encode")}


def load(workload: str) -> harness.Cell:
    """A cell of BENCHMARK.json, or a held one from its files."""
    if workload not in HELD:
        return harness.load_cell(workload)
    config, mix = HELD[workload]
    return harness.Cell(
        name=workload, chips=1,
        config=json.loads((harness.BENCH / "configs" / f"{config}.json").read_text()),
        traffic=json.loads((harness.BENCH / "traffic" / f"{mix}.json").read_text()),
        end_to_end=[{"name": "latency_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
        per_layer=[])


def cell(workload: str, seed: int = 2 ** 31 + 5, trace: bool = False, seconds: float = 0.5):
    c = load(workload)
    g = c.config["generator"]
    g.update(plane_resolution=32, channel_base=1024, channel_max=64,
             neural_rendering_resolution=16, depth_resolution=4, depth_resolution_importance=4)
    if "rendering_kwargs" in c.config:
        g["neural_rendering_resolution"] = 64
        c.config["rendering_kwargs"].update(depth_resolution=4, depth_resolution_importance=4)
        c.config["discriminator"].update(channel_base=256, channel_max=16)
        c.traffic.update(batch=2, warmup_steps=0)
    c.config["encoder"].update(layers=[1, 1, 1, 1], image=64)
    c.traffic.update(frames=2, photos=3, warmup_videos=1, check_videos=1, trace_seconds=seconds,
                     span_seconds=seconds, identities=min(c.traffic.get("identities", 0), 3),
                     rate_per_s=2.0, check_requests=1, drain_s=30)
    c.seed, c.seconds, c.trace, c.device = seed, seconds, trace, "cpu"
    return c


DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1}
