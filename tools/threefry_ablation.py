#!/usr/bin/env python3
"""What holds the threefry kernel below its bound, on one CUDA card.

    python3 tools/threefry_ablation.py [--rounds 2] [--iters 50]

Builds `gnerf_tpu_torch/csrc/threefry.cu` as it is and in variants that move
work from the ALU pipe (funnel shifts, LOP3, three-input adds) to the FMA
pipe: every round's adds written as multiply-adds by a 1 the compiler
cannot see (`imad_adds`), and k of every 8 rotations computed as
umulhi(x, 2^r) | x * 2^r (`rot<k>of8`, k = 2, 4, 8). Prints ptxas's
registers and spills and the SASS opcode counts (cuobjdump) of each
variant's `threefry_table` instances, then times each variant on the step's
draws (device ms from torch.profiler, 50 calls) in turns, `--rounds` times,
checking each against the plain version. Last, the card's SM clock and power
sampled by nvidia-smi over 4 s of back-to-back 2^24 draws. Each
substitution must match the source, so an edit of the kernel that moves a
part fails here loudly instead of timing the wrong thing.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ONE = {"  const I n = e.n;\n": "  const I n = e.n;\n  const uint32_t one = 1u - t.first[0];\n",
       "    threefry(k0, k1, x0, x1);\n": "    threefry(k0, k1, x0, x1, one);\n",
       "                                         uint32_t (&x1)[kValues]) {":
           "                                         uint32_t (&x1)[kValues], uint32_t one) {"}
IMAD_ADDS = {
    "        x0[v] += x1[v];\n": "        x0[v] = x1[v] * one + x0[v];\n",
    "      x0[v] += ks[(i + 1) % 3];\n      x1[v] += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);":
        "      x0[v] = ks[(i + 1) % 3] * one + x0[v];\n"
        "      x1[v] = (ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1)) * one + x1[v];"}


def imad_rotations(k: int) -> dict:
    r = "rot[i % 2][j]"
    return {f"        x1[v] = rotl(x1[v], {r}) ^ x0[v];":
            f"        x1[v] = ((((i * 4 + j) * 4 + v) % 8 < {k}) ? (__umulhi(x1[v], one << {r}) | "
            f"(x1[v] * (one << {r}))) : rotl(x1[v], {r})) ^ x0[v];"}


VARIANTS = {"full": {}, "imad_adds": {**ONE, **IMAD_ADDS},
            **{f"rot{k}of8": {**ONE, **imad_rotations(k)} for k in (2, 4, 8)}}
CASES = [("jitter", "uniform", (4, 4096, 48, 1), None),
         ("noise 512^2", "normal", (4, 1, 512, 512), None),
         ("noise 512^2, data=2 rank 1", "normal", (4, 1, 512, 512), {0: (2, 2)}),
         ("jitter, rays=2 rank 1", "uniform", (4, 4096, 48, 1), {1: (2048, 2048)}),
         ("n=2^24+3", "uniform", ((1 << 24) + 3,), None),
         ("n=2^24+3 bits", "bits", ((1 << 24) + 3,), None), ("n=1", "normal", (1,), None)]


def build(out_dir: str) -> dict:
    """{variant: loaded library}, printing ptxas lines and SASS opcode counts."""
    from gnerf_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC, "threefry.cu")) as fh:
        source = fh.read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"threefry_ablation: '{old.strip()}' is not in threefry.cu")
            text = text.replace(old, new)
        src = os.path.join(out_dir, f"threefry_{name}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", src[:-3] + ".so", src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"threefry_ablation: nvcc failed for {name}:\n{out}")
        so = os.path.join(out_dir, f"threefry_{name}.so")
        regs = [line.replace("ptxas info    :", "").strip() for line in out.splitlines()
                if "registers" in line or "spill" in line]
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            if "threefry_table" not in fn.splitlines()[0]:
                continue
            args = ", ".join(re.findall(r"Li(\d+)E", fn.splitlines()[0]))
            ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", fn))
            print(f"{name} threefry_table<{args}>: {sum(ops.values())} instructions, "
                  f"{dict(ops.most_common(10))}", flush=True)
        print(f"{name} ptxas: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(so)
        lib.threefry_launch.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
        lib.threefry_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    import tempfile

    import torch

    import chip_smoke
    from gnerf_tpu_torch.ops import threefry as T
    from gnerf_tpu_torch.training.train import step_key

    chip_smoke.phase_device()
    dev = torch.device("cuda")
    key = step_key(0, 8)
    times = collections.defaultdict(list)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for r in range(args.rounds):
            for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                T._library = lambda lib=libs[name]: lib
                for case, kind, shape, part in CASES:
                    want = T._plain(key, shape, part, dev, kind, *T._bounds(kind, 0.0, 1.0))
                    got = T.threefry_draw(key, shape, part, dev, kind).reshape(want.shape)
                    ok = (float((got - want).abs().max()) <= 1e-6 if kind == "normal"
                          else torch.equal(got, want))
                    if not ok:
                        raise SystemExit(f"threefry_ablation: {name} differs at {case}")
                    ms, _ = chip_smoke.kernel_device_ms(
                        lambda: T.threefry_draw(key, shape, part, dev, kind), args.iters,
                        "threefry_table")
                    times[(case, name)].append(ms)
        for case, kind, shape, part in CASES:
            bound, _ = chip_smoke.threefry_bound_ms(math.prod(T.block_shape(shape, part)), kind)
            print(f"{case}: bound {bound:.4f} ms; " + "; ".join(
                f"{name} {' '.join(f'{t:.4f}' for t in times[(case, name)])}" for name in libs),
                flush=True)
        T._library = lambda lib=libs["full"]: lib
        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader", "-lms", "500"],
                               stdout=subprocess.PIPE, text=True)
        t0, calls = time.perf_counter(), 0
        while time.perf_counter() - t0 < 4:
            for _ in range(100):
                T.threefry_draw(key, ((1 << 24) + 3,), None, dev, "bits")
            torch.cuda.synchronize()
            calls += 100
        smi.terminate()
        samples = smi.communicate()[0].split("\n")
        print(f"{calls} back-to-back 2^24 draws, {(time.perf_counter() - t0) / calls * 1e3:.4f} "
              f"ms each (host clock); SM clock and power: {'; '.join(s for s in samples if s)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
