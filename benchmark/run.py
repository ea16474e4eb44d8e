"""Run one benchmark cell of gnerf_tpu_torch on the card and print its result.

    python3 benchmark/run.py --workload orbit-ffhq512 --seed 7 --seconds 20 --trace 0

Set-up (imports, the CUDA build, seeded weights and inputs, warm-up of the
cell's own shapes) ends at the first timed call; then the cell's traffic
runs for `--seconds`. With `--trace 1` it runs instead under torch.profiler:
for the mix's `trace_seconds` recording the device alone (busy time,
kernels, rates), then for its `span_seconds` with the host's ops and the
benchmark's spans too. Once the window has closed, the peak memory is read, the
program's state is freed and what the window produced is compared with the
frozen plain reference. The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of standard
error and the `checks` key of that object.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
# Every cache of the run stays at a fixed place inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, bool(args.trace)
    device = harness.card(cell.chips)
    return run(cell, device)


def run(cell: harness.Cell, device: dict) -> int:
    """Set up, measure, check and print; `device` is the result's description."""
    import torch

    log = lambda msg: print(f"[bench] {msg}", file=sys.stderr, flush=True)  # noqa: E731
    log(f"{cell.name} seed {cell.seed} seconds {cell.seconds} trace {int(cell.trace)} "
        f"on {harness.power_limit() if cell.device == 'cuda' else cell.device}")
    drv = harness.driver(cell.traffic["kind"]).Driver(cell, log)
    drv.setup()
    setup_s = harness.process_age_s()
    log(f"setup_s {setup_s:.3f} ({drv.setup_parts})")
    trace = spans = None
    if cell.trace:
        from benchmark.trace import profiled

        box: dict = {}
        with profiled(box, spans=False):
            e2e = drv.window(float(cell.traffic.get("trace_seconds", cell.seconds)))
        trace, counters = box["trace"], drv.counters
        attempted, failed = drv.attempted, drv.failed
        with profiled(box, spans=True):
            drv.window(float(cell.traffic.get("span_seconds", 2)))
        spans, drv.span_counters, drv.counters = box["trace"], drv.counters, counters
        drv.attempted, drv.failed = attempted, failed
    else:
        e2e = drv.window(cell.seconds)
    peak = torch.cuda.max_memory_allocated() if cell.device == "cuda" else 0
    found = harness.forbidden_loaded()
    if found:
        print(f"benchmark: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    drv.release()
    checks = drv.check()
    correct = all(value <= limit for _, value, limit in checks)
    metrics: dict = {}
    if cell.trace:
        r = dict(drv.reading(trace), spans=spans, span_counters=drv.span_counters)
        for m in cell.per_layer:
            value = harness.reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device = dict(device, busy_s=trace.busy_s, window_s=trace.window_s)
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device, memory_peak_bytes=int(peak))
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    breakdown = None
    if trace is not None:
        breakdown = {"device_ops": trace.breakdown()["device_ops"],
                     "idle_gaps": spans.breakdown()["idle_gaps"]}
    print(harness.result_line(correct, drv.attempted, drv.failed, metrics, device, checks,
                              breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
