#!/usr/bin/env python3
"""Where the time of the `osg_decode` kernels goes, on one CUDA card.

    python3 tools/osg_decode_ablation.py [--dtype bfloat16|float32] [--rounds 3] [--iters 50]

Builds `gnerf_tpu_torch/csrc/osg_decode.cu` as it is and in variants that
each leave one part of the tensor-core kernel out (the feature copies, the
layer-1 products, the tf32 split of the fp32 kernel, the layer-2 products, the
softplus, the sigmoid, the output store), then times every variant at the
main-path shape (N=1, M=64*64*96, C=32, D=33) in the chosen feature type, in
turns, `--rounds` times. A variant computes wrong numbers; only its time is
read: what the full kernel loses without a part is what that part costs when
nothing else hides it. For fp32 two more variants are design alternatives,
not parts left out: a 3-stage copy ring, which leaves room for 9 warps per SM
instead of 12, and 14 warps, whose launch bounds leave ptxas 128 registers
instead of 168. Prints the card's name and power limit, ptxas's registers
and spills for each variant's main-shape instance, and one line per variant.
Each substitution must match the source, so an edit of the kernel that moves
a part fails here loudly instead of timing the wrong thing.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NO_FEATURE_COPIES = {
    "cp_async16(dst, live ? plane + r * C : feats, live ? 16 : 0);": "(void)dst;"}
NO_LAYER2_PRODUCTS = {
    "        mma_f16(o[j], ah[kk], bh0, bh1);\n"
    "        mma_f16(o[j], ah[kk], bl0, bl1);\n"
    "        mma_f16(o[j], al[kk], bh0, bh1);":
        "        o[j][0] += __uint_as_float(ah[kk][0] ^ al[kk][1] ^ bh0 ^ bh1 ^ bl0 ^ bl1);"}
NO_SOFTPLUS = {
    "acc[j][e] = softplus_log2(fmaf(acc[j][e], kLog2e / 3.0f, b1r[j][e & 1]));":
        "acc[j][e] = fmaf(acc[j][e], kLog2e / 3.0f, b1r[j][e & 1]);"}
NO_SIGMOID = {
    "(1.0f + 2.0f * 0.001f) * rcp_approx(1.0f + ex2_approx(-v * kLog2e)) - 0.001f;": "v;"}
NO_OUTPUT_STORE = {
    'asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"\n'
    '                     :: "l"(dst), "r"(out_smem), "r"(bytes) : "memory");': "(void)dst;"}

# Per feature type: the variants, and the mangled name of the main-shape
# instance (D = 33) whose registers are printed.
ABLATIONS = {
    "bfloat16": {
        "full": {},
        "no_feature_copies": NO_FEATURE_COPIES,
        "no_layer1_products": {
            "for (int j = 0; j < 8; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);":
                "acc[p][0] += __uint_as_float(a[0] & b[p][0]);"},
        "no_layer2_products": NO_LAYER2_PRODUCTS,
        "no_softplus": NO_SOFTPLUS,
        "no_sigmoid": NO_SIGMOID,
        "no_output_store": NO_OUTPUT_STORE,
    },
    "float32": {
        "full": {},
        "no_feature_copies": NO_FEATURE_COPIES,
        "no_layer1_products": {
            "            mma_tf32(acc[j], ah, bl0, bl1);\n"
            "            mma_tf32(acc[j], al, bh0, bh1);\n"
            "            mma_tf32(acc[j], ah, bh0, bh1);":
                "            acc[j][0] += __uint_as_float(ah[0] ^ al[1] ^ bh0 ^ bh1 ^ bl0 ^ bl1);"},
        "no_split": {
            "            ah[i] = tf32_rna(s);\n"
            "            al[i] = tf32_rna(s - __uint_as_float(ah[i]));":
                "            ah[i] = al[i] = __float_as_uint(s);"},
        "no_layer2_products": NO_LAYER2_PRODUCTS,
        "no_softplus": NO_SOFTPLUS,
        "no_sigmoid": NO_SIGMOID,
        "no_output_store": NO_OUTPUT_STORE,
        "ring_3_stages_9_warps": {
            "static constexpr int kStages = 2;": "static constexpr int kStages = 3;",
            "launch_tc<true, 4, 12>": "launch_tc<true, 4, 9>"},
        "warps_14": {"launch_tc<true, 4, 12>": "launch_tc<true, 4, 14>"},
    },
}
INSTANCE = {"bfloat16": r"osg_decode_tcILi4ELi16E", "float32": r"osg_decode_tf32ILi4ELi\d+E"}


def build(out_dir: str, dtype: str) -> dict:
    from gnerf_tpu_torch.ops.cuda_build import CSRC, NVCC_FLAGS, _nvcc

    with open(os.path.join(CSRC, "osg_decode.cu")) as fh:
        source = fh.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in ABLATIONS[dtype].items():
        text = source
        for old, new in subs.items():
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the kernel source no longer holds {old!r}")
            text = text.replace(old, new)
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", os.path.join(out_dir, f"lib{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if re.search(INSTANCE[dtype], line):
                usage = [x.strip() for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x]
                print(f"[build] {name}: {' | '.join(usage)}", flush=True)
                break
        fn = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")).osg_decode_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(ABLATIONS), default="bfloat16",
                    help="feature type, which selects the kernel")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    from gnerf_tpu_torch.models import OSGDecoder
    from gnerf_tpu_torch.utils import prng

    if not torch.cuda.is_available():
        raise SystemExit("osg_decode_ablation: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    fns = build(os.path.join(ROOT, "gnerf_tpu_torch", "_build", "ablation", args.dtype),
                args.dtype)
    dtype = getattr(torch, args.dtype)

    m, c = 64 * 64 * 96, 32
    gen = torch.Generator().manual_seed(m + c)
    dec = OSGDecoder(n_features=c, decoder_output_dim=32, key=prng.PRNGKey(m + c)).cuda()
    w1, b1, w2, b2 = (w.detach() for w in dec.folded_weights(dtype))
    feats = torch.randn((1, 3, m, c), generator=gen).to("cuda", dtype)
    h, d = w2.shape
    out = torch.empty((1, m, d), device="cuda")
    ptrs = (feats.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), 1, m, c, h, d, int(dtype == torch.bfloat16))

    times = {name: [] for name in fns}
    for rnd in range(args.rounds):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for name in order:
            fn = fns[name]
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(5):
                if fn(*ptrs, stream) != 0:
                    raise SystemExit(f"{name}: launch failed")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                fn(*ptrs, stream)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / args.iters)
    full = statistics.median(times["full"])
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"[ablation] {args.dtype} {name}: ms={' '.join(f'{t:.4f}' for t in ts)} median={med:.4f} "
              f"saves={full - med:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
