#!/usr/bin/env python3
"""Two host-side choices of `gnerf_tpu_torch.infer.server`, timed on one CUDA card.

    python3 tools/server_probe.py [--rounds 3]

Builds a `GNerfService` at the full width of the default TriPlaneGenerator
and ResNeXt50 encoder (seed-init weights, bf16, 96+96, 8XDC to 512^2) and
times, `--rounds` times each:

  - identity preparation (mapping and backbone from a latent z) on the
    service's long-lived device worker, against the same work on a fresh
    thread per call (cuDNN keeps its execution plans per thread);
  - PNG encoding of one rendered 512^2 frame at zlib level 1 (what /render
    sends) against PIL's default level 6.

Prints the card's name and power limit, then one line per case in ms.
"""

from __future__ import annotations

import argparse
import io
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from gnerf_tpu_torch.infer import gen_videos as gv
    from gnerf_tpu_torch.infer.server import GNerfService

    if not torch.cuda.is_available():
        raise SystemExit("server_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    g, enc = gv.load_networks(None, seed_init=0, device="cuda")
    service = GNerfService(g, enc, microbatch=4, device="cuda")
    try:
        z = torch.randn((1, g.z_dim), generator=torch.Generator().manual_seed(9))
        frame = service.render_frame(service._register(z))  # first calls, not timed

        def fresh_thread_prepare():
            th = threading.Thread(target=service._prepare, args=(z,))
            th.start()
            th.join()

        def png(level):
            Image.fromarray(frame).save(io.BytesIO(), format="PNG", compress_level=level)

        for name, fn in (("prep_on_worker", lambda: service._register(z)),
                         ("prep_on_fresh_thread", fresh_thread_prepare),
                         ("png_level6", lambda: png(6)), ("png_level1", lambda: png(1))):
            ms = []
            for _ in range(args.rounds):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            print(f"[probe] {name}: ms={' '.join(f'{t:.3f}' for t in ms)}", flush=True)
    finally:
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
