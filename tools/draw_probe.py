#!/usr/bin/env python3
"""What one draw of the key stream costs on one CUDA card and on the host.

    python3 tools/draw_probe.py [--plain] [--host-profile N] [--root DIR]

For each `utils.prng` draw at a training step's shapes (the jitter, the
importance u, a 256^2 noise layer, a 4^2 one, ADA's per-sample draws, the
bits of 786k values), with a key on the host drawing on the card: the ms
per call back to back (CUDA events over 20 calls), and, from a profile of
5 calls, the kernels' device ms and launches per call and the host ms of
the ops. `--plain` draws through the plain version (int64 torch ops, the
float steps in torch) instead of the kernel. Then the host ms of a key
split and a fold_in (keys stay on the host during training).
`--host-profile N`: first a cProfile of N back-to-back jitter draws (uniform
[4, 4096, 48, 1], a host key drawing on the card), the functions by their
own host time. `--root DIR` imports `gnerf_tpu_torch` from another checkout
(e.g. the parent, unpacked with `git archive`) to profile its call path.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [("uniform", (4, 4096, 48, 1)), ("uniform", (16384, 48)), ("normal", (4, 1, 256, 256)),
         ("normal", (4, 1, 4, 4)), ("uniform", (4,)), ("normal", (4,)), ("bits", (786432,))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--host-profile", type=int, default=0, metavar="N")
    ap.add_argument("--root", default=ROOT, help="the checkout to import gnerf_tpu_torch from")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gnerf_tpu_torch.ops import threefry as T
    from gnerf_tpu_torch.utils import prng
    from gnerf_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("draw_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = resolve_device("cuda")
    key = prng.PRNGKey(3)
    if args.host_profile:
        host_profile(prng, key, dev, args.host_profile)
    for kind, shape in CASES:
        if args.plain:
            span = T._bounds(kind, 0.0, 1.0)

            def fn():
                return T._plain(key, shape, None, dev, kind, *span)
        else:
            def fn(kind=kind, shape=shape):
                return getattr(prng, kind)(key, shape, device=dev)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(20):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
        dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in kernels) / 5e3
        host_ms = sum(e.self_cpu_time_total for e in ka if e.device_type == DeviceType.CPU) / 5e3
        print(f"{'plain ' if args.plain else ''}{kind}{list(shape)}: "
              f"{ev[0].elapsed_time(ev[1]) / 20:.4f} ms per call back to back; kernels "
              f"{dev_ms:.4f} ms, {sum(e.count for e in kernels) // 5} launches; host ops "
              f"{host_ms:.3f} ms (profiled)", flush=True)
    for name, fn in (("split(key, 2)", lambda: prng.split(key, 2)),
                     ("split(key, 32)", lambda: prng.split(key, 32)),
                     ("fold_in(key, 7)", lambda: prng.fold_in(key, 7))):
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        print(f"host key {name}: {(time.perf_counter() - t0) / 200 * 1e3:.4f} ms", flush=True)
    return 0


def host_profile(prng, key, dev, calls: int) -> None:
    """cProfile of `calls` jitter draws on the card from a host key: the
    host us per call without and with the profiler, and the 20 functions
    with the most own time."""
    import cProfile
    import io
    import pstats

    import torch

    def run():
        for _ in range(calls):
            prng.uniform(key, (4, 4096, 48, 1), device=dev)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    plain_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(run)
    profiled_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(20)
    print(f"host profile of {calls} jitter draws: {plain_us:.2f} us a call ({profiled_us:.2f} "
          f"under cProfile)\n{out.getvalue()}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
