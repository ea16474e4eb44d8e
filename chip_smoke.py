#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gnerf_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--frames 8] [--profile FILE]

Phases, each of which fails the run (non-zero exit) when it fails:
  1. device:  requires CUDA; prints the card's name and power limit.
  2. build:   compiles every kernel of the paths from csrc/ with nvcc (one
              process per source, started together); prints ptxas's
              registers and spills per kernel instance.
  3. kernels: each kernel vs its plain PyTorch version on the card, at the
              shapes of the main, server, shape and training paths and of a
              rank's part under the inference mesh (with
              gradients at the G-NeRF and EG3D step's shapes, fp32 and
              bf16, and at Greg's) and at the edge cases, with its time,
              its bound and the plain version's time.
 3b. threefry: the threefry kernel (csrc/threefry.cu) vs its plain version
              (int64 torch ops, then the float steps in torch) on the card
              at the step's draw shapes, a rank's block at data=2 and at
              rays=2 and the edges (n = 0, 1, 5003, past 2^24), as bits,
              uniform and normal draws (bit for bit; normal within 1e-6),
              keys on the host and on the card, split and fold_in pairs;
              its time, its bound and the plain version's time.
  4. small:   a tiny generator on the card (fp32) vs the same weights on
              the CPU, through render + 8XDC, and through `sample_mixed`;
              the tiny G-NeRF train step with rng=None and seeded from a
              step key (D training), and the tiny EG3D Gmain + Dmain
              and Dreg under ADA at p = 0.5 from one key, card vs CPU (stats
              within 1e-3, gradients within 1e-3 of each tensor's largest).
  5. prng:    the threefry key stream (`utils/prng.py`) on the card vs the
              CPU: keys, splits, folds, bits and uniform draws bit for bit,
              normal draws within 1e-6; the full-width G (PRNGKey(0)) and E
              (PRNGKey(1)) of `--seed-init 0` drawn on the card vs built on
              the CPU, leaf by leaf within the init tests' bound; the card's
              seed-init time; a step key's draws at the step's shapes (and a
              rank's block) on the card vs the CPU. The CPU tests hold the
              CPU's to JAX's.
  6. main:    `generate_videos` at the full width of the default
              TriPlaneGenerator and ResNeXt50 encoder (seed-init weights,
              bf16, 96+96 samples, 8XDC to 512^2); every kernel of the path
              must have launched (osg_decode: twice per frame).
  7. timing:  identity prep, render and SR ms, frames/s and peak memory.
 7b. ingest:  published weights into the port without JAX: the full-width G
              and E of phase main (`--seed-init 0`) pickled in the reference
              checkpoint's layout (`tests/_torch_ingest.py`), converted by
              `python -m gnerf_tpu_torch.tools.convert_reference_pkl` in a
              process where `import jax` fails, then `generate_videos` on the
              npz (4 bf16 frames) equal bit for bit to the seed-init frames,
              osg_decode launched twice per frame; a full-width VGG16 LPIPS
              oracle saved with `torch.jit.save`, converted and calibrated on
              the card by `convert_vgg16_lpips`, `load_lpips` of it within
              rtol 5e-3 of the oracle on 4 pairs; a random
              `inception_v3_google` state dict through `convert_inception`
              and `load_inception`, every tensor equal. Conversion seconds and
              npz bytes.
  8. server:  `GNerfService` at the same full width behind a loopback
              ThreadingHTTPServer: /healthz, /encode (seeds, a 512^2 PNG, a
              non-square photo with 68 landmarks), sequential and 4
              concurrent /render (a batch of 4, within +-1 of direct
              renders), /orbit (30 frames; 400 and 404 cases); latencies,
              orbit frames/s, launches and peak memory.
  9. shapes:  `generate_videos(..., gen_shapes=True, shape_res=256)`: the
              .mrc reads back 256^3, finite, not constant inside the mask; a
              mesh with faces; sweep ms and its 16 fp32 launches.
 10. train:   the G-NeRF train step at the full width of the `ffhq` preset
              (ResNeXt50 E in train mode, default G frozen, 48+48 samples,
              8XDC to 512^2, depth D with R1, VGG16-LPIPS at 256^2, batch 4,
              fp32, seed-init weights, SyntheticDataset batches): warm-up,
              then timed steps (ms, images/s, peak memory, losses); every
              loss finite, E, D and the BN buffers moved, G bitwise frozen,
              osg_decode launched twice per step; a full-state save and load
              gives the state back bit for bit, and the next step from both
              agrees within tolerance; the threefry share of one step's
              device time (torch.profiler, the prng calls in ranges).
 11. eg3d:    the EG3D objective at the full width of the `ffhq` preset (all
              of G trained against DualDiscriminator(c_dim=25, 512^2, 3),
              lazy regularization at the CLI's cadence: Gmain + Dmain every
              step, Greg every 4, Dreg every 16; batch 4, fp32,
              seed-init weights, SyntheticDataset batches on the card):
              2 warm-up steps, then 16 timed scheduled steps (16 Gmain+Dmain,
              4 Greg, 1 Dreg); the CUDA-event ms of each phase, the
              amortised step ms, images/s, peak memory and the osg_decode
              launches of each phase (checked exactly); every loss finite,
              G, D, G_ema and w_avg moved; a profile of one Dreg shows no
              convolution double backward; a full-state save and load gives
              the state back bit for bit and the next step from both agrees
              within tolerance; under Freeze-D (2 layers) the frozen layers
              stay bitwise through a main and a Dreg step; the threefry
              share of each phase's device time and of the amortised step.
 12. eg3d_ada: the same EG3D run with `--aug ada` from p = 0.2 (2 warm-up +
              16 timed steps): phase ms, amortised step, images/s, peak
              memory, launches checked exactly; the controller's p after
              each window equals ada_update_p's arithmetic; a Dreg profile
              (R1 through grid_sample's backward, no convolution double
              backward); the pipe's forward ms on a [4, 6, 512, 512] pair;
              the share of 256 samples the pipe changes at p = 0.2 within
              3 sigma of its expected value; the threefry share as in eg3d.
 13. pti:     `make_pti_step` on the full-width G (8XDC to 512^2, 48+48)
              with VGG16-LPIPS at 256^2, batch 4, fp32: 2 warm-up + 8 timed
              steps without and with the locality regularizer (step ms, peak
              memory, losses finite, the SR module bitwise, every weight the
              loss reaches moved, launches per step exact), then `project_w`
              steps (ms per step).
 14. eval:    `run_eval` on a full-width snapshot the phase writes (seed
              weights), 8 items in batches of 4: PSNR / SSIM / LPIPS with E,
              the VGG Frechet distance without; InceptionV3Features at 299^2,
              batch 4, on weights the phase writes, and the host-side Frechet
              distance of 2048-d features (times and finiteness only).
 15. ddp:     the distributed training path (`gnerf_tpu_torch.parallel`) at
              the full width of the `ffhq` preset, batch 4, fp32, seed-init
              weights, SyntheticDataset batches, each run held to the plain
              world-1 step on the same batch and seed (world 1 run twice
              gives the card's run-to-run floor): (a) the G-NeRF step in a
              world-1 NCCL group in this process; two gloo ranks spawned on
              the one card (NCCL refuses two ranks on one device) running
              (b) the G-NeRF step and EG3D Gmain + Dmain at data=2, each
              deterministic and seeded, and EG3D Dreg at data=2, and (c) the
              G-NeRF step at rays=2. Stats, gradients and the untrained tensors within the
              DDP_* tolerances, replicas equal, osg_decode launches exact on
              every rank; the ms per step and peak memory per rank, of two
              processes sharing one card (correctness, not speed). Then three
              planted faults on the same ranks (BatchNorm moments of the local
              rows, minibatch std of the local rows, gradients not averaged),
              each of which the same bounds must catch.
 16. infer_ddp: multi-device inference at the full width of phase main (bf16,
              96+96, 8XDC to 512^2, 8 frames): (a) `generate_videos` in a
              world-1 NCCL group (the mesh path at 1x1), its frames equal to
              phase main's; (b) two gloo ranks spawned on the one card at
              data=2 (with the 256^3 sigma sweep split over both) and at
              rays=2, rank 0's frames within +-1 of phase main's (max gap
              and share of differing values printed), the volume within
              rtol 1e-4 / atol 1e-5 of phase shapes'; (c) `GNerfService`
              with two replicas of G on the card (devices=[cuda:0, cuda:0]),
              frames_per_chunk 4, its orbit within +-1 of one device's at
              the same batch sizes (the 30-frame orbit's gap to one
              device's chunks of 15 printed: bf16 convolutions round
              otherwise at batch 2). osg_decode launches checked exactly on every
              rank: data=2 2 per frame of the rank's 4 plus 16 sweep chunks of
              2^19 points, rays=2 2 per frame at M/2, the server 2 per
              replica's part. ms and peak memory per rank (two processes
              sharing one card: correctness, not speed).
 17. sg3:     StyleGAN3-T at the published FFHQ-U 1024^2 configuration
              (z = w = 512, c_dim 0, 2 mapping layers, channel_base 32768,
              channel_max 512, 14 layers, 2 critical; seed-init weights):
              forward at batch 4 in fp32 and bf16 (shape, finite, ms per
              image, peak memory); a fp32 backward of out.square().mean() at
              batch 1 (every parameter's gradient finite and nonzero); every
              layer's magnitude EMA moved by `updated_magnitude_ema`; the
              card's fp32 output at batch 1 within 1e-3 of the same weights
              on the CPU; a profile of one forward with filtered_lrelu's
              share of device time. It runs no hand-written kernel.
The training phases draw from the CLI's step keys (`train.step_key`). The
threefry kernel's launches are counted per path, each path's count set to
0 just before it; main, train, eg3d and eg3d_ada must launch it.
Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}. `--profile FILE` also writes a torch.profiler
table of one frame to FILE.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

H100_BYTES_PER_S = 3.35e12   # HBM3, NVIDIA data sheet (SXM)
H100_BF16_FLOPS = 989e12     # dense tensor cores
H100_FP32_FLOPS = 67e12      # outside the tensor cores
# Instruction rates of an H100 SXM (132 SMs at 1.98 GHz boost): every SM
# issues 4 warp instructions (128 threads) a clock; its ALU pipe, which runs
# the funnel shifts and the logic (LOP3) operations, takes 64 threads a clock.
H100_ISSUE_OPS = 132 * 128 * 1.98e9
H100_ALU_OPS = 132 * 64 * 1.98e9
# Per value of csrc/threefry.cu, at least: the ALU pipe's 20 rotations and
# 21 xors (20 rounds and the output's), and all 68 instructions (the adds,
# which may also issue on the FMA pipe, besides); a uniform value adds 2 ALU
# (shift, or) and 3 float operations, a normal one ~40 float ones (erfinv,
# log1pf as ~10).
THREEFRY_ALU_OPS, THREEFRY_OPS = 41, 68
UNIFORM_ALU_OPS, UNIFORM_OPS = 2, 5
NORMAL_OPS = 40
FRAMES_DEFAULT = 8
MAIN_M = 64 * 64 * 96        # points per decoder pass at 64^2 rays x 96 samples
TRAIN_M = 64 * 64 * 48       # points per training decoder pass (48 coarse or 48 fine)
TRAIN_BATCH = 4              # the ffhq preset's batch on one card
GREG_M = 2 * 1000            # points of the density regularizer (density_reg_points x 2)
ORBIT_FRAMES = 15            # frames per /orbit chunk (GNerfService.frames_per_chunk)
SHAPE_CHUNK = 1 << 20        # points per shape-sweep chunk (extract_sigma_grid max_batch)
SHAPE_RES = 256              # voxels per side of the shapes phase (512^3 runs through the CLI)
SIDE = 512                   # frame side of the full-width model (8XDC output)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dev_ms(e, attr: str) -> float:
    """A profiler average's device time in ms (`attr` under its CUDA name;
    newer torch names it device)."""
    v = getattr(e, attr.replace("cuda", "device"), None)
    return (getattr(e, attr) if v is None else v) / 1e3


def kernel_device_ms(fn, iters: int, kernel: str) -> tuple[float, float]:
    """(device ms per call, launches per call) of the kernels whose name holds
    `kernel`, from torch.profiler's device events over `iters` calls of `fn`
    after a warm-up: the kernels' own time, without the host's time between
    calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and kernel in e.key]
    total = sum(_dev_ms(e, "self_cuda_time_total") for e in events)
    if not events or total <= 0:
        raise SystemExit(f"chip_smoke: torch.profiler shows no device time for '{kernel}'")
    return total / iters, sum(e.count for e in events) / iters


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a card")
    log(card_line())
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")


def phase_build():
    """Builds the kernels (one nvcc each, started together) and prints
    ptxas's registers and spills for every kernel instance (the line naming
    the instance precedes them)."""
    from gnerf_tpu_torch.ops import cuda_build

    secs = cuda_build.build(["osg_decode", "threefry"])
    for name, out in cuda_build.build_log.items():
        instance = name
        for line in out.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                m = re.search(r"(osg_decode_(?:tc|tf32)|threefry_words)(?:I((?:Li\d+E)+)E)?",
                              entry.group(1))
                args = re.findall(r"Li(\d+)E", m.group(2) or "") if m else []
                instance = (entry.group(1) if not m else
                            f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1))
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name} {instance}: {line.strip()}")
    log(f"[build] built in {secs:.2f} s")


def decoder_bytes(n, m, c, h, d, bf16: bool) -> int:
    """Bytes the decoder must move: every input read once, the output written once."""
    elem = 2 if bf16 else 4
    return n * 3 * m * c * elem + c * h * elem + (h + h * d + d) * 4 + n * m * d * 4


def decoder_bound_ms(n, m, c, h, d, bf16: bool) -> tuple[float, str]:
    """Least time on an H100: `decoder_bytes` at the HBM rate, vs the
    operations at the peak rate of their type (the first product on bf16
    tensor cores when the features are bf16; the plane sum, the second
    product and the rest in fp32)."""
    l1 = 2.0 * n * m * c * h
    fp32_ops = 2.0 * n * m * c + 2.0 * n * m * h * d
    t_ops = l1 / (H100_BF16_FLOPS if bf16 else H100_FP32_FLOPS) + fp32_ops / H100_FP32_FLOPS
    t_bytes = decoder_bytes(n, m, c, h, d, bf16) / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def decode_f64(feats, w1e, b1e, w2e, b2e):
    """The decoder in float64, to judge inputs where fp32 itself rounds."""
    import torch

    f, w1 = feats.double(), w1e.double()
    x = (f[:, 0] @ w1 + f[:, 1] @ w1 + f[:, 2] @ w1) / 3.0 + b1e.double()
    h = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
    o = h @ w2e.double() + b2e.double()
    return torch.cat([o[..., :1], torch.sigmoid(o[..., 1:]) * (1 + 2 * 0.001) - 0.001], -1)


def phase_kernels():
    """osg_decode vs osg_decode_ref on the card. Tolerance rtol 1e-4 /
    atol 1e-5 for fp32 and bf16 alike: the plain version sums in fp32 (TF32
    off); the bf16 kernel takes the same bf16 values exactly into fp32 sums,
    the fp32 kernel keeps ~21-22 bits of its first product in 3xTF32, and
    both keep ~22 bits of h and w2e in the split-fp16 second layer and use
    approximate exp2/log2 (tests/test_torch_fused_decoder.py emulates both on
    the CPU). The x65536 cases ("huge_*", outputs near 1e5, where fp32 itself
    rounds by ~2e-2) take the kernel's per-row scaling; each must be as close
    to float64 as the plain version is, within a factor 4: the tensor cores'
    fp32 sums do not round to nearest (an earlier version of the kernel, with
    sigma on the tensor cores too, read 2.1x)."""
    import torch

    from gnerf_tpu_torch.models import OSGDecoder
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode, osg_decode_ref
    from gnerf_tpu_torch.utils import prng

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, N, M, C, out_dim, lr_mul, dtype, feature scale, timed
        ("main_bf16", 1, MAIN_M, 32, 32, 1.0, bf16, 1.0, True),
        ("main_f32", 1, MAIN_M, 32, 32, 1.0, f32, 1.0, True),
        ("ragged_f32", 2, 5000, 32, 32, 1.0, f32, 1.0, False),  # also the N=2 stride
        ("ragged_bf16", 1, 5000, 32, 32, 1.0, bf16, 1.0, False),
        ("narrow_lr_mul", 1, 4096, 8, 8, 0.5, f32, 1.0, False),
        ("narrow_lr_mul_bf16", 1, 4096, 8, 8, 0.5, bf16, 1.0, False),
        ("m1_bf16", 1, 1, 32, 32, 1.0, bf16, 1.0, False),
        ("m63_bf16", 1, 63, 32, 32, 1.0, bf16, 1.0, False),
        ("m5003_bf16", 1, 5003, 32, 32, 1.0, bf16, 1.0, False),
        ("n2_bf16", 2, 5000, 32, 32, 1.0, bf16, 1.0, False),
        ("main_x20_bf16", 1, MAIN_M, 32, 32, 1.0, bf16, 20.0, False),
        ("huge_bf16", 1, 2048, 32, 32, 1.0, bf16, 65536.0, False),
        ("m1_f32", 1, 1, 32, 32, 1.0, f32, 1.0, False),
        ("m63_f32", 1, 63, 32, 32, 1.0, f32, 1.0, False),
        ("m5003_f32", 1, 5003, 32, 32, 1.0, f32, 1.0, False),
        ("main_x20_f32", 1, MAIN_M, 32, 32, 1.0, f32, 20.0, False),
        ("huge_f32", 1, 2048, 32, 32, 1.0, f32, 65536.0, False),
        # fp32 ring rows of 6, 10, 12, 14 and 16 chunks (every swizzle
        # case), and D > 33 (the kNT2 = 8 instances)
        ("c24_f32", 1, 5003, 24, 32, 1.0, f32, 1.0, False),
        ("c40_f32", 1, 5003, 40, 32, 1.0, f32, 1.0, False),
        ("c48_f32", 1, 5003, 48, 32, 1.0, f32, 1.0, False),
        ("c56_f32", 1, 5003, 56, 32, 1.0, f32, 1.0, False),
        ("c64_d49_f32", 1, 5003, 64, 48, 1.0, f32, 1.0, False),
        ("c64_d49_bf16", 1, 5003, 64, 48, 1.0, bf16, 1.0, False),
        # micro-batch of 4 identities; an orbit chunk (15 frames folded
        # into one point set); a shape-sweep chunk (fp32 planes)
        ("server_mb4_bf16", 4, MAIN_M, 32, 32, 1.0, bf16, 1.0, True),
        ("orbit_chunk_bf16", 1, ORBIT_FRAMES * MAIN_M, 32, 32, 1.0, bf16, 1.0, True),
        ("shape_chunk_f32", 1, SHAPE_CHUNK, 32, 32, 1.0, f32, 1.0, True),
        # a rank's part under the inference mesh: half a frame's points at
        # rays=2; half a sweep chunk over 2 ranks
        ("ray_shard_bf16", 1, MAIN_M // 2, 32, 32, 1.0, bf16, 1.0, True),
        ("sweep_shard_f32", 1, SHAPE_CHUNK // 2, 32, 32, 1.0, f32, 1.0, True),
        # one pass of the train step: 4 identities x 64^2 rays x 48 samples;
        # the same in bf16 (the EG3D step under --dtype bf16); the EG3D
        # density regularizer's points (Greg)
        ("train_f32", TRAIN_BATCH, TRAIN_M, 32, 32, 1.0, f32, 1.0, True),
        ("train_bf16", TRAIN_BATCH, TRAIN_M, 32, 32, 1.0, bf16, 1.0, True),
        ("greg_f32", TRAIN_BATCH, GREG_M, 32, 32, 1.0, f32, 1.0, True),
    ]
    grad_cases = ("train_f32", "train_bf16", "greg_f32")
    results = {}
    for name, n, m, c, out_dim, lr, dtype, scale, timed in cases:
        gen = torch.Generator().manual_seed(m + c)
        dec = OSGDecoder(n_features=c, decoder_output_dim=out_dim, decoder_lr_mul=lr,
                         key=prng.PRNGKey(m + c)).cuda()
        weights = [w.detach() for w in dec.folded_weights(dtype)]
        feats = (torch.randn((n, 3, m, c), generator=gen) * scale).to("cuda", dtype)
        got = osg_decode(feats, *weights)
        want = osg_decode_ref(feats, *weights)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        if name.startswith("huge_"):
            exact = decode_f64(feats, *weights)
            k_err = (got.double() - exact).abs().max().item()
            p_err = (want.double() - exact).abs().max().item()
            ok = finite and k_err <= 4.0 * p_err
            rule = f"vs float64: kernel {k_err:.3e}, plain {p_err:.3e} (kernel <= 4x plain)"
        else:
            ok = finite and torch.allclose(got, want, rtol=1e-4, atol=1e-5)
            rule = "(rtol 1e-4, atol 1e-5)"
        row = {"max_abs_err": err, "shape": [n, 3, m, c], "dtype": str(dtype)}
        msg = (f"[kernel] osg_decode {name} N={n} M={m} C={c} D={out_dim + 1} {dtype} "
               f"x{scale:g}: max_abs_err={err:.3e} {rule}")
        if timed:
            h, d = weights[2].shape
            row["ms"] = cuda_ms(lambda: osg_decode(feats, *weights), iters=50, warmup=5)
            row["plain_ms"] = cuda_ms(lambda: osg_decode_ref(feats, *weights), iters=10, warmup=2)
            row["bound_ms"], row["bound_by"] = decoder_bound_ms(
                n, m, c, h, d, dtype == torch.bfloat16)
            moved = decoder_bytes(n, m, c, h, d, dtype == torch.bfloat16)
            msg += (f" kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                    f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                    f"roofline={row['bound_ms'] / row['ms']:.3f} "
                    f"achieved={moved / row['ms'] / 1e9:.3f} TB/s")
        if name in grad_cases:
            ok = _train_gradients(feats, dec, row) and ok
            rtol = "2^-7 for the feature and fc0 gradients, 1e-4 else" if dtype == bf16 else "1e-4"
            msg += (f" backward_ms={row['backward_ms']:.4f} (plain products) "
                    f"backward_bound_ms={row['backward_bound_ms']:.4f} "
                    f"grad_max_err={row['grad_max_err']:.3e} of the largest (rtol {rtol}, "
                    "atol 1e-5 of the largest)")
        log(msg)
        if not ok:
            raise SystemExit(f"chip_smoke: osg_decode {name} disagrees with its plain version")
        results[name] = row
        del feats, got, want
        torch.cuda.empty_cache()
    return results


def _train_gradients(feats, dec, row) -> bool:
    """Decoder gradients at a training shape through `OSGDecode` (kernel
    forward, plain-product backward) vs autograd through the plain version,
    held to rtol 1e-4 with an atol of 1e-5 of each gradient's largest
    element (bf16 features: the feature and fc0 gradients come back through
    bf16, the features' and w1e's dtype, so rtol 2^-7, one bf16 ulp); and
    the backward's time with its byte bound (features and dL/dout read once,
    the feature gradient written once)."""
    import torch

    from gnerf_tpu_torch.ops.fused_decoder import osg_decode, osg_decode_backward, osg_decode_ref

    dt = feats.dtype
    f = feats.detach().requires_grad_()
    cot = torch.randn(feats.shape[0], feats.shape[2], 33, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(2))
    inputs = [f, dec.fc0.weight, dec.fc0.bias, dec.fc1.weight, dec.fc1.bias]
    through_bf16 = (True, True, False, False, False)
    out = osg_decode(f, *dec.folded_weights(dt))
    if out.grad_fn is None:
        raise SystemExit("chip_smoke: osg_decode returned no grad_fn with inputs requiring grad")
    got = torch.autograd.grad(out, inputs, cot)
    want = torch.autograd.grad(osg_decode_ref(f, *dec.folded_weights(dt)), inputs, cot)
    worst, ok = 0.0, True
    for g, w, bf in zip(got, want, through_bf16):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        rtol = 2 ** -7 if bf and dt == torch.bfloat16 else 1e-4
        worst = max(worst, float((g - w).abs().max()) / scale)
        ok = ok and bool(torch.isfinite(g).all()) and torch.allclose(g, w, rtol=rtol,
                                                                       atol=1e-5 * scale)
    weights = [w.detach() for w in dec.folded_weights(dt)]
    row["grad_max_err"] = worst
    row["backward_ms"] = cuda_ms(lambda: osg_decode_backward(cot, feats, *weights),
                                 iters=10, warmup=2)
    moved = 2 * feats.numel() * feats.element_size() + cot.numel() * 4
    row["backward_bound_ms"] = moved / H100_BYTES_PER_S * 1e3
    del got, want, out
    return ok


def threefry_bound_ms(n: int, kind: str = "bits") -> tuple[float, str]:
    """Least time on an H100 for n values: the larger of the ALU pipe's
    operations (64 lanes an SM), all the instructions at the issue rate (128
    an SM) and the bytes written (4 a value, 8 for pairs)."""
    alu, ops = THREEFRY_ALU_OPS, THREEFRY_OPS
    if kind in ("uniform", "normal"):
        alu, ops = alu + UNIFORM_ALU_OPS, ops + UNIFORM_OPS
    if kind == "normal":
        ops += NORMAL_OPS
    t_ops = max(alu * n / H100_ALU_OPS, ops * n / H100_ISSUE_OPS)
    t_bytes = (8 if kind == "pairs" else 4) * n / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_threefry() -> dict:
    """The threefry kernel (`ops/threefry.py::threefry_draw`, csrc/threefry.cu)
    against its plain version (`threefry2x32` in int64 torch ops, then the
    float steps in torch) on the card, at the step's draw shapes
    (`STEP_DRAWS`: the jitter, the importance u, the 512^2 noise, a rank's
    block at data=2 and at rays=2, n = 0, 1, 5003 and past 2^24), each as
    bits, uniform and normal, with the key on the host and on the card, and
    for the key pairs of split and fold_in: bits, pairs and uniform bit for
    bit, normal within 1e-6 (both take CUDA's log1pf and sqrtf).
    Times the kernel by its device events (torch.profiler: `device_ms`) and
    per call (CUDA events around 20 back-to-back calls:
    `call_ms`, host-bound, as the card idles between calls), and the plain
    version (CUDA events), beside the bound. Returns {name: row} of the
    step's draws as they are made (STEP_DRAWS' kinds)."""
    import torch

    from gnerf_tpu_torch.ops import threefry as T
    from gnerf_tpu_torch.training.train import step_key

    dev = torch.device("cuda")
    key = step_key(0, 8)
    rows, lines, worst = {}, [], 0.0
    cases = [(name, kind, shape, part) for name, kind, shape, part in STEP_DRAWS]
    cases += [("split 7", "pairs", (7,), None),
              ("fold_in 2^32-1", "pairs", (1 << 32,), {0: ((1 << 32) - 1, 1)})]
    for name, draw_kind, shape, part in cases:
        kinds = ("pairs",) if draw_kind == "pairs" else ("bits", "uniform", "normal")
        for kind in kinds:
            want = T._plain(key, shape, part, dev, kind, *T._bounds(kind, 0.0, 1.0))
            for k in (key, key.cuda()):
                got = T.threefry_draw(k, shape, part, dev, kind).reshape(want.shape)
                err = float((got - want).abs().max()) if kind == "normal" and want.numel() else 0
                worst = max(worst, err)
                ok = err <= 1e-6 if kind == "normal" else torch.equal(got, want)
                if not ok:
                    raise SystemExit(f"chip_smoke: the threefry kernel differs from its plain "
                                     f"version at '{name}' {kind} (key on {k.device.type})")
        n = math.prod(T.block_shape(shape, part))
        if n == 0 or draw_kind == "pairs":
            continue
        kind = draw_kind
        span = T._bounds(kind, 0.0, 1.0)
        call_ms = cuda_ms(lambda: T.threefry_draw(key, shape, part, dev, kind), iters=20,
                          warmup=3)
        device_ms, per_call = kernel_device_ms(
            lambda: T.threefry_draw(key, shape, part, dev, kind), 20, "threefry_words")
        plain_ms = cuda_ms(lambda: T._plain(key, shape, part, dev, kind, *span), iters=3,
                           warmup=1)
        bound, by = threefry_bound_ms(n, kind)
        rows[name] = dict(n=n, kind=kind, device_ms=device_ms, call_ms=call_ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                          max_abs_err=worst if kind == "normal" else 0.0)
        lines.append(f"{name} {kind} n={n}: device {device_ms:.4f} ms ({per_call:g} launch a "
                     f"call), call {call_ms:.4f} ms (host-bound), plain {plain_ms:.3f}, bound "
                     f"{bound:.4f} {by} ({bound / device_ms:.2f} of device)")
    log(f"[threefry] kernel == plain version (bits, pairs, uniform bit for bit; normal max abs "
        f"err {worst:.3e}, bound 1e-6; keys on the host and on the card); " + "; ".join(lines))
    return rows


def phase_small():
    """Tiny G rendered on the card vs the same weights on the CPU (fp32,
    TF32 off), and its fields at 2000 points through `sample_mixed`.
    Tolerance atol 1e-4 on [-1, 1] images: cuDNN, cuBLAS and the kernel sum
    in other orders than the CPU, and the importance resampling and two SR
    blocks carry those differences through (the CPU parity tests hold the
    port to the JAX package at the same bound)."""
    import torch

    from gnerf_tpu_torch.infer.gen_videos import orbit_label
    from gnerf_tpu_torch.models import DEFAULT_RENDERING_KWARGS, TriPlaneGenerator
    from gnerf_tpu_torch.utils import prng

    cfg = dict(z_dim=32, c_dim=25, w_dim=32, img_resolution=512, plane_resolution=16,
               channel_base=512, channel_max=64, mapping_layers=2,
               neural_rendering_resolution=8,
               rendering_kwargs=dict(DEFAULT_RENDERING_KWARGS, depth_resolution=6,
                                     depth_resolution_importance=6, sr_input_resolution=16))
    outs = {}
    for dev in ("cpu", "cuda"):
        g = TriPlaneGenerator(**cfg, device=dev, key=prng.PRNGKey(3))
        g.requires_grad_(False)
        z = torch.randn((1, 32), generator=torch.Generator().manual_seed(4)).to(dev)
        c = orbit_label(2, 8, "ffhq", g.rendering_kwargs).to(dev)
        pts = (torch.rand((1, 2000, 3), generator=torch.Generator().manual_seed(5)) - 0.5).to(dev)
        with torch.inference_mode():
            outs[dev] = {k: v.float().cpu() for k, v in g.apply(z, c).items()}
            mixed = g.sample_mixed(pts, torch.zeros_like(pts), g.mapping(z, c))
        outs[dev].update({f"sample_mixed_{k}": mixed[k].cpu() for k in ("sigma", "rgb")})
    for k in outs["cpu"]:
        err = (outs["cuda"][k] - outs["cpu"][k]).abs().max().item()
        log(f"[small] {k} {tuple(outs['cuda'][k].shape)} cuda vs cpu max_abs_err={err:.3e} "
            "(atol 1e-4)")
        if not (err <= 1e-4 and torch.isfinite(outs["cuda"][k]).all()):
            raise SystemExit(f"chip_smoke: tiny {k} on the card disagrees with the CPU")
    _small_train_step()
    _small_train_step(seeded=True)
    _small_eg3d_ada()


PRNG_SEEDS = (0, 1, 42, 2 ** 31 - 1)
PRNG_SHAPES = ((), (7,), (257, 300), (1 << 22,))


def _same(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a, b)


def _init_gaps(got: dict, want: dict, uniform: tuple = ()) -> list:
    """The leaves of `got` outside the init tests' bound around `want`
    (tests/test_torch_init.py): constant and uniform leaves equal, the rest
    within 1e-6 times the leaf's std plus 2e-6 of its magnitude."""
    bad = []
    for name, w in want.items():
        g = got[name]
        if w.numel() == 0 or name in uniform or bool((w == w.flatten()[0]).all()):
            ok = _same(g, w)
        else:
            ok = bool(((g - w).abs() <= 1e-6 * w.std() + 2e-6 * w.abs()).all())
        if not ok:
            bad.append((name, float((g - w).abs().max())))
    return bad


def phase_prng():
    """The threefry key stream on the card against the CPU's: keys, splits,
    folds, bits and uniform draws bit for bit, normal draws within 1e-6;
    then the full-width G (PRNGKey(0)) and E (PRNGKey(1)) of
    `load_networks(None, seed_init=0)` drawn on the card against the same
    built on the CPU, leaf by leaf. The CPU tests hold the CPU's stream and
    inits to JAX's, so this chains the card's weights to JAX's. Prints the
    card-side seed-init time (CUDA events; the first build, then a second)."""
    import torch

    from gnerf_tpu_torch.models import ResNeXt50Encoder, TriPlaneGenerator
    from gnerf_tpu_torch.utils import prng

    t0 = time.perf_counter()
    checks, worst_normal = 0, 0.0
    for seed in PRNG_SEEDS:
        kc, kg = prng.PRNGKey(seed), prng.PRNGKey(seed, device="cuda")
        pairs = [(prng.split(kg, n), prng.split(kc, n)) for n in range(1, 6)]
        pairs += [(prng.fold_in(kg, d), prng.fold_in(kc, d)) for d in (0, 1, 7, 2 ** 31 - 1)]
        for shape in PRNG_SHAPES:
            pairs.append((prng.bits(kg, shape), prng.bits(kc, shape)))
            for lo, hi in ((0.0, 1.0), (-0.3, 2.5)):
                pairs.append((prng.uniform(kg, shape, lo, hi), prng.uniform(kc, shape, lo, hi)))
            got, want = prng.normal(kg, shape), prng.normal(kc, shape)
            if got.device.type != "cuda":
                raise SystemExit("chip_smoke: a key on the card drew off the card")
            err = float((got.cpu() - want).abs().max()) if want.numel() else 0.0
            worst_normal = max(worst_normal, err)
            if not err <= 1e-6:
                raise SystemExit(f"chip_smoke: normal{shape} of seed {seed} on the card is "
                                 f"{err:.3e} from the CPU's (bound 1e-6)")
        for got, want in pairs:
            if got.device.type != "cuda" or not _same(got.cpu(), want):
                raise SystemExit(f"chip_smoke: a threefry draw of seed {seed} on the card "
                                 f"differs from the CPU's: shape {tuple(want.shape)}")
        checks += len(pairs) + len(PRNG_SHAPES)
    log(f"[prng] {checks} draws of seeds {PRNG_SEEDS} (split n 1..5, fold_in, bits / uniform / "
        f"normal at shapes {PRNG_SHAPES}): card == CPU bit for bit but normal, max abs err "
        f"{worst_normal:.3e} (bound 1e-6); {time.perf_counter() - t0:.2f} s host clock")
    _step_draws()

    def build(dev):
        g = TriPlaneGenerator(device=dev, key=prng.PRNGKey(0))
        return g, ResNeXt50Encoder(out_dim=g.z_dim, device=dev, key=prng.PRNGKey(1))

    init_ms = []
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        nets = build("cuda")
        ev[1].record()
        torch.cuda.synchronize()
        init_ms.append(ev[0].elapsed_time(ev[1]))
    n_params = sum(p.numel() for net in nets for p in net.parameters())
    t0 = time.perf_counter()
    cpu_nets = build("cpu")
    cpu_s = time.perf_counter() - t0
    bad, n_leaves = [], sum(len(net.state_dict()) for net in nets)
    for net, ref, uniform in zip(nets, cpu_nets, ((), ("fc.weight", "fc.bias"))):
        want = ref.state_dict()
        got = {k: v.cpu() for k, v in net.state_dict().items()}
        if sorted(got) != sorted(want):
            raise SystemExit("chip_smoke: the card's and the CPU's seed-init leaves differ")
        bad += _init_gaps(got, want, uniform)
    log(f"[prng] seed init of the full-width G (PRNGKey(0)) and E (PRNGKey(1)), {n_params} "
        f"parameters: card {init_ms[0]:.1f} ms first build, {init_ms[1]:.1f} ms second (CUDA "
        f"events); CPU {cpu_s:.2f} s (host clock, {torch.get_num_threads()} threads); "
        f"{n_leaves} leaves, {len(bad)} outside the init bound "
        f"{bad[:4]}")
    if bad:
        raise SystemExit("chip_smoke: the seed-init weights on the card differ from the CPU's")
    del nets, cpu_nets
    torch.cuda.empty_cache()


# The draws of a full-width step (batch 4, 64^2 rays, 48 + 48 samples, 512^2
# SR noise), a rank's part of them at data=2 and at rays=2, and edge sizes:
# (name, sampler, shape, part).
STEP_DRAWS = (
    ("jitter", "uniform", (4, 4096, 48, 1), None),
    ("importance u", "uniform", (16384, 48), None),
    ("noise 512^2", "normal", (4, 1, 512, 512), None),
    ("noise 512^2, data=2 rank 1", "normal", (4, 1, 512, 512), {0: (2, 2)}),
    ("jitter, rays=2 rank 1", "uniform", (4, 4096, 48, 1), {1: (2048, 2048)}),
    ("n=0", "uniform", (0,), None),
    ("n=1", "normal", (1,), None),
    ("n=5003", "bits", (5003,), None),
    ("n=2^24+3", "uniform", ((1 << 24) + 3,), None),
)


def _step_draws():
    """The step's draws from a CPU key (a step key) made on the card and on
    the CPU: bits and uniform bit for bit, normal within 1e-6; the card's
    ms for each (CUDA events) beside the CPU's (host clock)."""
    import torch

    from gnerf_tpu_torch.training.train import step_key
    from gnerf_tpu_torch.utils import prng

    key = step_key(0, 8)
    worst, rows = 0.0, []
    for name, sampler, shape, part in STEP_DRAWS:
        fn = getattr(prng, sampler)
        t0 = time.perf_counter()
        want = fn(key, shape, part=part)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        got = fn(key, shape, part=part, device="cuda")
        ms = cuda_ms(lambda: fn(key, shape, part=part, device="cuda"), iters=3, warmup=1)
        got = got.cpu()
        if sampler == "normal":
            err = float((got - want).abs().max()) if want.numel() else 0.0
            worst = max(worst, err)
            ok = got.shape == want.shape and err <= 1e-6
        else:
            ok = _same(got, want)
        rows.append(f"{name} {sampler}{list(want.shape)} {ms:.3f} ms (CPU {cpu_ms:.1f} ms)")
        if not ok:
            raise SystemExit(f"chip_smoke: the step draw '{name}' on the card differs from the "
                             "CPU's")
    log(f"[prng] a step key's draws on the card == the CPU's (bits / uniform bit for bit, "
        f"normal max abs err {worst:.3e}, bound 1e-6): " + "; ".join(rows))


def _tiny_trainer(dev, **cfg_overrides):
    """The tests' tiny training configuration (tests/test_torch_training.py)
    on `dev`, every weight from fixed seeds."""
    import torch

    from gnerf_tpu_torch.models import (DEFAULT_RENDERING_KWARGS, Discriminator,
                                        ResNeXt50Encoder, TriPlaneGenerator)
    from gnerf_tpu_torch.training import VGG16LPIPS, TrainConfig, init_train_state
    from gnerf_tpu_torch.utils import prng

    rk = dict(DEFAULT_RENDERING_KWARGS, superresolution_module="SuperresolutionHybrid2X",
              depth_resolution=4, depth_resolution_importance=4)
    g = TriPlaneGenerator(z_dim=32, w_dim=32, img_resolution=128, plane_resolution=16,
                          channel_base=512, channel_max=32, neural_rendering_resolution=8,
                          rendering_kwargs=rk, device=dev, key=prng.PRNGKey(1))
    enc = ResNeXt50Encoder(out_dim=32, layers=(1, 1, 1, 1), device=dev, key=prng.PRNGKey(2))
    disc = Discriminator(c_dim=25, img_resolution=8, img_channels=1, channel_base=256,
                         channel_max=32, mbstd_group_size=1, device=dev, key=prng.PRNGKey(3))
    vgg = VGG16LPIPS(resize_to=32, device=dev, key=prng.PRNGKey(4))
    cfg = TrainConfig(batch_size=2, neural_rendering_resolution=8, **cfg_overrides)
    return init_train_state(g, enc, disc, vgg, cfg), cfg


def _grad_gaps(runs, devices):
    """(max relative stat gap, max gradient gap of each tensor's largest)
    between the runs {device: (stats, {name: gradient})} of `devices`."""
    (want, want_g), (got, got_g) = runs[devices[0]], runs[devices[1]]
    stat_err = max(abs(got[k] - v) / max(abs(v), 1e-3) for k, v in want.items())
    grad_err = max(float((got_g[k] - g).abs().max() / g.abs().max().clamp_min(1e-12))
                   for k, g in want_g.items())
    return stat_err, grad_err, len(want), len(want_g)


def _small_train_step(devices=("cpu", "cuda"), seeded: bool = False):
    """One tiny train step on the card vs the CPU, with rng=None or, seeded,
    from one key (the CLI's step key of seed 0: every draw made on each
    device from the same CPU key): every stat within rtol 1e-3, and every
    gradient the optimizers took (Adam's first moment over 1 - beta1)
    within 1e-3 of its tensor's largest element: cuDNN, cuBLAS and
    grid_sample's atomic backward sum in other orders, and Adam's first
    step maps each gradient to +-lr, so the updated weights themselves are
    not compared. The seeded step trains D alone (E and G frozen; every draw
    of the synthesis still feeds the stats and D's inputs): on the seeded
    step E's gradients (a BatchNorm scale after ReLUs at 2^2 maps) and G's
    noise-strength gradients (sums of random-sign terms) differ between the
    card and the CPU by 5.24e-3 and 2.38e-3 of their largest, also when the
    CPU step takes the card's draws and initial weights bit for bit
    (`tools/small_step_probe.py --card-draws` on the H100: PERF.md): the
    gap comes from the step's sums, not from the draws, and a 1e-3 bound on
    the largest element cannot tell it from a fault. The rng=None step
    holds E's training."""
    import numpy as np
    import torch
    from PIL import Image

    from gnerf_tpu_torch.training import SyntheticDataset, collate, make_train_step
    from gnerf_tpu_torch.training.train import step_key

    items = [SyntheticDataset(resolution=16, depth_resolution=8, size=4)[i] for i in range(2)]
    batch = collate(items)
    rs = np.random.RandomState(0)
    batch["condition_image"] = np.stack([np.asarray(Image.fromarray(
        rs.randint(0, 256, (8, 8, 3), np.uint8)).resize((64, 64), Image.BILINEAR))
        .transpose(2, 0, 1) for _ in range(2)])
    runs = {}
    for dev in devices:
        state, cfg = _tiny_trainer(dev, train_en=False) if seeded else _tiny_trainer(dev)
        _, stats = make_train_step(cfg)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            step_key(0, 0) if seeded else None)
        grads = {}
        for name in ("opt_g", "opt_d"):
            opt = getattr(state, name)
            for i, p in enumerate(p for grp in (opt.param_groups if opt else ())
                                  for p in grp["params"]):
                if p in opt.state:
                    grads[f"{name}.{i}"] = opt.state[p]["exp_avg"].cpu() / 0.1
        runs[dev] = ({k: float(v) for k, v in stats.items()}, grads)
    stat_err, grad_err, n_stats, n_grads = _grad_gaps(runs, devices)
    what = "seeded (step key of seed 0; D trains)" if seeded else "rng=None"
    log(f"[small] tiny train step, {what}, {devices[1]} vs {devices[0]}: {n_stats} stats "
        f"max_rel_err={stat_err:.3e} (1e-3), {n_grads} gradients max_err={grad_err:.3e} "
        "of each tensor's largest (1e-3)")
    if not (stat_err <= 1e-3 and grad_err <= 1e-3):
        raise SystemExit("chip_smoke: the tiny train step on the card disagrees with the CPU")


def _small_eg3d_ada(devices=("cpu", "cuda"), aug_p: float = 0.5):
    """The tiny EG3D phases under ADA at p = aug_p (Gmain + Dmain on a step
    key's ks, Dreg on fold_in(ks, 2), as the CLI keys them: the pose swap,
    the synthesis noise, the render's draws and the pipe's 32 keys per D
    call) on the card vs the CPU, with the bound of `_small_train_step` on
    the stats and on each phase's gradients (the lazy Adams' b1 is 0, so
    the first moments are the gradients)."""
    import torch

    from gnerf_tpu_torch.models import DualDiscriminator
    from gnerf_tpu_torch.training import SyntheticDataset, collate, make_eg3d_phase_steps
    from gnerf_tpu_torch.training.eg3d_loss import EG3DLossConfig, init_eg3d_state
    from gnerf_tpu_torch.training.train import step_key
    from gnerf_tpu_torch.utils import prng

    items = collate([SyntheticDataset(resolution=16, size=4)[i] for i in range(2)])
    runs = {}
    for dev in devices:
        state, _ = _tiny_trainer(dev)
        g = state.g
        d = DualDiscriminator(c_dim=25, img_resolution=16, img_channels=3, channel_base=256,
                              channel_max=32, mbstd_group_size=2, device=dev,
                              key=prng.PRNGKey(5))
        cfg = EG3DLossConfig(neural_rendering_resolution=8, density_reg_points=16,
                             aug="ada", aug_p=aug_p, style_mixing_prob=0.5)
        st = init_eg3d_state(g, d, cfg, lazy=True)
        main, _, dreg = make_eg3d_phase_steps(cfg)
        c = torch.from_numpy(items["loss_c"]).float().to(dev)
        kz, ks = prng.split(step_key(0, 0))
        batch = {"z": prng.normal(prng.fold_in(kz, 0), (2, 32), device=dev), "c": c,
                 "real_image": torch.from_numpy(items["loss_image"]).to(dev).float()
                 / 127.5 - 1.0, "real_c": c}
        stats, grads = {}, {}
        for name, fn in (("main", lambda: main(st, batch, ks, 0.0, aug_p, res=8)),
                         ("dreg", lambda: dreg(st, batch, prng.fold_in(ks, 2), 0.0, aug_p,
                                               res=8))):
            stats.update({f"{name}/{k}": float(v) for k, v in fn()[1].items()})
            for oname in ("opt_g", "opt_d"):
                o = getattr(st, oname)
                for i, p in enumerate(p for grp in o.param_groups for p in grp["params"]):
                    if p in o.state:
                        grads[f"{name}.{oname}.{i}"] = o.state[p]["exp_avg"].cpu().clone()
        runs[dev] = (stats, grads)
    stat_err, grad_err, n_stats, n_grads = _grad_gaps(runs, devices)
    log(f"[small] tiny EG3D Gmain + Dmain and Dreg under ADA at p={aug_p}, seeded, "
        f"{devices[1]} vs {devices[0]}: {n_stats} stats max_rel_err={stat_err:.3e} (1e-3), "
        f"{n_grads} gradients max_err={grad_err:.3e} of each tensor's largest (1e-3)")
    if not (stat_err <= 1e-3 and grad_err <= 1e-3):
        raise SystemExit("chip_smoke: the tiny seeded EG3D ADA phases on the card disagree "
                         "with the CPU")


def phase_main(frames: int):
    import torch

    from gnerf_tpu_torch.infer.gen_videos import generate_videos
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode

    with tempfile.TemporaryDirectory() as tmp:
        osg_decode.launches = 0
        t0 = time.perf_counter()
        res = generate_videos(None, seed_init=0, frames=frames, res=64,
                              video_out_path=tmp, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = osg_decode.launches
        video_ok = os.path.exists(res["video"]) and os.path.exists(res["video_raw"])
    f = res["frames"]
    log(f"[main] generate_videos: {frames} frames {f.shape} {f.dtype} in {wall:.2f} s "
        f"(first call, setup and warm-up included); finite={res['finite']} "
        f"video={os.path.basename(res['video'])} osg_decode launches={launches}")
    if f.shape != (frames, 512, 512, 3) or f.dtype.name != "uint8":
        raise SystemExit(f"chip_smoke: frames are {f.shape} {f.dtype}")
    if res["frames_raw"].shape != (frames, 64, 64, 3):
        raise SystemExit(f"chip_smoke: raw frames are {res['frames_raw'].shape}")
    if not res["finite"] or not video_ok or f.std() == 0:
        raise SystemExit("chip_smoke: non-finite frames, constant frames or no video")
    if launches != 2 * frames:
        raise SystemExit(f"chip_smoke: osg_decode launched {launches} times, "
                         f"want {2 * frames}")
    return launches, f


def phase_timing(frames: int, profile: Optional[str]):
    import torch

    from gnerf_tpu_torch.infer import gen_videos as gv

    torch.cuda.reset_peak_memory_stats()
    g, enc = gv.load_networks(None, seed_init=0, device="cuda")
    ids = gv._load_images(None, None)
    dtype = torch.bfloat16
    prep_ms = cuda_ms(lambda: gv.prepare_identity(g, enc, ids, dtype=dtype), iters=3, warmup=1)
    ws, planes = gv.prepare_identity(g, enc, ids, dtype=dtype)
    labels = [gv.orbit_label(i, frames, "ffhq", g.rendering_kwargs).cuda() for i in range(frames)]

    with torch.inference_mode():
        feats = {}

        def render(i):
            feats[i] = g.render_planes(planes, labels[i], ws, neural_rendering_resolution=64,
                                       dtype=dtype, superres=False)["feature_image"]

        def sr(i):
            x = feats[i]
            return g.superresolution(x[:, :3], x, ws, noise_mode="none", dtype=dtype)

        for i in range(frames):  # warm-up
            render(i)
            sr(i)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        render_ms = sr_ms = 0.0
        for i in range(frames):
            ev[0].record()
            render(i)
            ev[1].record()
            sr(i)
            ev[2].record()
            torch.cuda.synchronize()
            render_ms += ev[0].elapsed_time(ev[1]) / frames
            sr_ms += ev[1].elapsed_time(ev[2]) / frames

    def chunk():  # the generate_videos loop body: frames + one host copy
        outs = [gv.render_frame(g, planes, ws, labels[i], 64, dtype)[0] for i in range(frames)]
        return torch.stack(outs).cpu()

    chunk()
    fps_runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk()
        fps_runs.append(frames / (time.perf_counter() - t0))
    fps = sorted(fps_runs)[1]
    peak = torch.cuda.max_memory_allocated()
    log(f"[timing] identity_prep_ms={prep_ms:.3f} render_ms={render_ms:.3f} "
        f"sr_ms={sr_ms:.3f} frames_per_s={fps:.3f} (median of "
        f"{', '.join(f'{x:.3f}' for x in fps_runs)}; chunks of {frames}, uint8 on host) "
        f"max_memory_allocated={peak} bytes")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            gv.render_frame(g, planes, ws, labels[0], 64, dtype)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        os.makedirs(os.path.dirname(os.path.abspath(profile)), exist_ok=True)
        with open(profile, "w") as fh:
            fh.write(table)
        log("[profile] one frame, top device ops:\n" + "\n".join(table.splitlines()[:18]))


INGEST_FRAMES = 4
LPIPS_RTOL = 5e-3  # the converter's calibration bound


def _ingest_helpers():
    """tests/_torch_ingest.py (torch and numpy only): the reference-layout
    stand-ins and the JAX-blocked runner."""
    sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import _torch_ingest

    return _torch_ingest


def phase_ingest() -> int:
    """Published weights into the port without JAX (see the module
    docstring). Returns the osg_decode launches of the converted npz's
    render."""
    import numpy as np
    import torch

    from gnerf_tpu_torch.infer import gen_videos as gv
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode
    from gnerf_tpu_torch.training.inception import load_inception
    from gnerf_tpu_torch.training.losses import load_lpips

    ingest = _ingest_helpers()
    with tempfile.TemporaryDirectory() as tmp:
        g, enc = gv.load_networks(None, seed_init=0, device="cuda", double_sampling=False)
        pkl, npz = os.path.join(tmp, "network.pkl"), os.path.join(tmp, "gnerf.npz")
        n_params = sum(v.numel() for net in (g, enc) for v in net.state_dict().values())
        t0 = time.perf_counter()
        ingest.write_reference_pickle(pkl, g, SIDE, enc)
        pickle_s = time.perf_counter() - t0
        del g, enc
        t0 = time.perf_counter()
        out = ingest.run_without_jax("gnerf_tpu_torch.tools.convert_reference_pkl", "--pkl", pkl,
                                     "--reference", tmp, "--out", npz).stdout.strip()
        convert_s = time.perf_counter() - t0
        pkl_bytes, npz_bytes = os.path.getsize(pkl), os.path.getsize(npz)
        os.remove(pkl)

        common = dict(frames=INGEST_FRAMES, res=64, device="cuda")
        osg_decode.launches = 0
        got = gv.generate_videos(npz, video_out_path=os.path.join(tmp, "npz"), **common)
        torch.cuda.synchronize()
        launches = osg_decode.launches
        want = gv.generate_videos(None, seed_init=0, video_out_path=os.path.join(tmp, "seed"),
                                  **common)
        gap = max(int(np.abs(got[k].astype(int) - want[k].astype(int)).max())
                  for k in ("frames", "frames_raw"))
        shapes_ok = (got["frames"].shape == (INGEST_FRAMES, SIDE, SIDE, 3)
                     and got["frames"].dtype == np.uint8 and got["finite"])

        oracle = ingest.LPIPSOracle()
        pt, lnpz = os.path.join(tmp, "vgg16.pt"), os.path.join(tmp, "lpips_vgg16.npz")
        torch.jit.save(torch.jit.script(oracle), pt)
        t0 = time.perf_counter()
        ingest.run_without_jax("gnerf_tpu_torch.tools.convert_vgg16_lpips", "--pt", pt,
                               "--out", lnpz)
        lpips_s = time.perf_counter() - t0
        net, meta = load_lpips(lnpz, device="cuda")
        oracle = oracle.cuda()
        rng = np.random.RandomState(7)
        a = torch.from_numpy(rng.rand(4, 3, 128, 128).astype(np.float32) * 255).cuda()
        b = (a + torch.from_numpy(rng.randn(4, 3, 128, 128).astype(np.float32) * 40).cuda()
             ).clamp(0, 255)
        with torch.no_grad():
            d_got = (net.apply(a) - net.apply(b)).square().sum(1)
            d_want = (oracle(a, resize_images=True, return_lpips=True)
                      - oracle(b, resize_images=True, return_lpips=True)).square().sum(1)
        lpips_err = float(((d_got - d_want).abs() / d_want.abs()).max())

        state = ingest.random_inception_state(seed=0)
        ipt, inpz = os.path.join(tmp, "inception_v3_google.pth"), os.path.join(tmp, "fid.npz")
        torch.save(state, ipt)
        t0 = time.perf_counter()
        ingest.run_without_jax("gnerf_tpu_torch.tools.convert_inception", "--pt", ipt,
                               "--out", inpz)
        inception_s = time.perf_counter() - t0
        loaded = load_inception(inpz, device="cuda").state_dict()
        inception_ok = all(torch.equal(v.cpu(), state[k]) for k, v in loaded.items())

    log(f"[ingest] reference pickle of the full-width G + E ({n_params} parameters, "
        f"{pkl_bytes} bytes, written in {pickle_s:.2f} s) -> npz of {npz_bytes} bytes in "
        f"{convert_s:.2f} s by convert_reference_pkl with JAX blocked (process wall, start-up "
        f"included): {out.splitlines()[-1]}; generate_videos on it: {INGEST_FRAMES} bf16 frames "
        f"{got['frames'].shape}, max gap to the seed-init frames {gap} (want 0), osg_decode "
        f"launches {launches}; LPIPS: full-width VGG16 oracle converted and calibrated on the "
        f"card in {lpips_s:.2f} s (resize_to={meta['resize_to']}, "
        f"antialias={meta['antialias']}, whitening={meta['whitening']}, calibration err "
        f"{meta['calibration_err']:.3e}), load_lpips vs oracle on 4 pairs: max rel err "
        f"{lpips_err:.3e} (bound {LPIPS_RTOL:g}); Inception: {len(loaded)} tensors converted in "
        f"{inception_s:.2f} s, equal={inception_ok}")
    if not shapes_ok or gap != 0:
        raise SystemExit("chip_smoke: the converted checkpoint's frames differ from the "
                         "seed-init frames")
    if launches != 2 * INGEST_FRAMES:
        raise SystemExit(f"chip_smoke: osg_decode launched {launches} times on the converted "
                         f"npz, want {2 * INGEST_FRAMES}")
    if not lpips_err <= LPIPS_RTOL:
        raise SystemExit("chip_smoke: the converted LPIPS net disagrees with its oracle")
    if not inception_ok:
        raise SystemExit("chip_smoke: the converted Inception weights differ from the source")
    return launches


def _smooth_photo(h: int, w: int, seed: int):
    """Low-frequency synthetic RGB photo [h, w, 3] uint8."""
    import numpy as np
    from PIL import Image

    small = np.random.RandomState(seed).randint(0, 256, (h // 16 + 2, w // 16 + 2, 3), np.uint8)
    return np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR))


def _face_landmarks(cx: float, cy: float, iod: float):
    """68 points whose eye rings and mouth corners (the only points the
    FFHQ alignment reads) sit on an upright face centred at (cx, cy)."""
    import numpy as np

    lm = np.tile([cx, cy + 0.6 * iod], (68, 1)).astype(np.float64)
    ring = np.stack([3 * np.cos(np.linspace(0, 2 * np.pi, 6, False)),
                     1.5 * np.sin(np.linspace(0, 2 * np.pi, 6, False))], -1)
    lm[36:42] = ring + [cx - iod / 2, cy]
    lm[42:48] = ring + [cx + iod / 2, cy]
    lm[48] = [cx - 0.35 * iod, cy + 1.1 * iod]
    lm[54] = [cx + 0.35 * iod, cy + 1.1 * iod]
    return lm


def _png_b64(arr) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def phase_server():
    """GNerfService at full width (seed-init weights, bf16, 96+96, 8XDC to
    512^2, micro-batches of 4) behind a loopback ThreadingHTTPServer. The
    concurrent burst is sent up to 8 times, until 2 batches of 4 have
    formed (the first batch of 4 pays the first-call cost of that shape, so
    the second one is the warm reading; a burst whose requests miss the 4 ms
    window forms smaller batches). Every burst's frames must be within +-1
    per uint8 pixel of direct single-identity renders: cuDNN may pick other
    algorithms at batch 4 than at batch 1. osg_decode must launch
    exactly twice per render batch and twice per orbit chunk."""
    import numpy as np
    import torch
    from http.server import ThreadingHTTPServer
    from PIL import Image

    from gnerf_tpu_torch.infer import gen_videos as gv
    from gnerf_tpu_torch.infer.server import GNerfService, make_handler
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode
    from gnerf_tpu_torch.utils import camera

    g, enc = gv.load_networks(None, seed_init=0, device="cuda")
    service = GNerfService(g, enc, microbatch=4, device="cuda")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload, expect=200):
        t0 = time.perf_counter()
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                code, body, ctype = r.status, r.read(), r.headers["Content-Type"]
        except urllib.error.HTTPError as err:
            code, body, ctype = err.code, err.read(), err.headers["Content-Type"]
        if code != expect:
            raise SystemExit(f"chip_smoke: {path} answered {code} (want {expect}): {body[:200]}")
        return body, ctype, (time.perf_counter() - t0) * 1e3

    def frame_of(body):
        return np.asarray(Image.open(io.BytesIO(body)))

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        osg_decode.launches = 0
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            if not json.loads(r.read())["ok"]:
                raise SystemExit("chip_smoke: /healthz is not ok")
        enc_ms, ids = [], []
        for seed in range(4):
            body, _, ms = post("/encode", {"seed": seed})
            ids.append(json.loads(body)["identity"])
            enc_ms.append(ms)
        body, _, ms = post("/encode", {"image": _png_b64(_smooth_photo(512, 512, 1))})
        enc_ms.append(ms)
        photo_id = json.loads(body)["identity"]
        body, _, ms = post("/encode", {"image": _png_b64(_smooth_photo(480, 640, 2)),
                                       "landmarks": _face_landmarks(320, 210, 90).tolist(),
                                       "align_size": 512})
        enc_ms.append(ms)
        ids.append(json.loads(body)["identity"])
        log(f"[server] /encode x{len(enc_ms)} (4 seeds, a 512^2 PNG, a 640x480 photo + "
            f"landmarks): median_ms={statistics.median(enc_ms):.3f} max_ms={max(enc_ms):.3f} "
            f"(first call included; in order {', '.join(f'{x:.3f}' for x in enc_ms)})")

        render_ms = []
        for i in range(8):
            body, ctype, ms = post("/render", {"identity": ids[i % 2], "yaw": 1.2 + 0.1 * i})
            f = frame_of(body)
            if ctype != "image/png" or f.shape != (SIDE, SIDE, 3) or f.std() == 0:
                raise SystemExit(f"chip_smoke: /render gave {ctype} {f.shape}")
            render_ms.append(ms)
        direct_frame_ms = []
        for i in range(8):  # the same requests without HTTP and PNG encoding
            t0 = time.perf_counter()
            service.render_frame(ids[i % 2], yaw=1.2 + 0.1 * i)
            direct_frame_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"[server] /render x8 sequential: median_ms={statistics.median(render_ms):.3f} "
            f"max_ms={max(render_ms):.3f} (first call included; each waits the 4 ms window); "
            f"render_frame without HTTP/PNG: median_ms={statistics.median(direct_frame_ms):.3f} "
            f"max_ms={max(direct_frame_ms):.3f}")

        poses = [(1.3, 1.5), (1.6, 1.7), (1.9, 1.4), (1.45, 1.6)]
        burst_ids = ids[:3] + [photo_id]
        burst_ms, worst, formed = [], 0, 0
        for attempt in range(8):
            got, errs = [None] * 4, []
            before = service.batch_sizes[4]

            def client(k):
                try:
                    got[k] = frame_of(post("/render", {"identity": burst_ids[k],
                                                        "yaw": poses[k][0],
                                                        "pitch": poses[k][1]})[0])
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            burst_ms.append((time.perf_counter() - t0) * 1e3)
            if errs:
                raise SystemExit(f"chip_smoke: concurrent /render failed: {errs[0]!r}")
            for k in range(4):
                ws, planes = service._get(burst_ids[k])
                c = camera.pose_to_label(camera.lookat_sample(*poses[k], radius=2.7),
                                         camera.FFHQ_INTRINSICS).cuda()
                want = service._run_frame_batch([(ws, planes, c)])[0]
                worst = max(worst, int(np.abs(got[k].astype(int) - want.astype(int)).max()))
            formed += service.batch_sizes[4] > before
            if formed == 2:  # the first batch of 4 includes the shapes' first-call cost
                break
        else:
            raise SystemExit("chip_smoke: 4 concurrent /render did not form 2 batches of 4")
        log(f"[server] /render x4 concurrent on 4 identities: 2 batches of 4 in {attempt + 1} "
            f"bursts, wall_ms={burst_ms[-1]:.3f} (every burst: "
            f"{', '.join(f'{x:.3f}' for x in burst_ms)}), max |batched - direct|={worst} "
            f"(bound 1)")
        if worst > 1:
            raise SystemExit("chip_smoke: micro-batched frames differ from direct renders by > 1")

        orbit_ms = []
        for _ in range(2):
            body, ctype, ms = post("/orbit", {"identity": ids[0], "frames": 30})
            if ctype != "video/avi" or body[:4] != b"RIFF" or b"MJPG" not in body:
                raise SystemExit(f"chip_smoke: /orbit gave {ctype} {body[:16]!r}")
            orbit_ms.append(ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = service.render_orbit(ids[0], frames=30)
        direct_ms = (time.perf_counter() - t0) * 1e3
        if len(frames) != 30 or frames[0].shape != (SIDE, SIDE, 3) or frames[7].std() == 0:
            raise SystemExit("chip_smoke: render_orbit gave bad frames")
        post("/orbit", {"identity": ids[0], "frames": 100000}, expect=400)
        post("/render", {"identity": "nope"}, expect=404)
        post("/orbit", {"identity": "nope", "frames": 2}, expect=404)
        torch.cuda.synchronize()
        launches = osg_decode.launches
        batches = dict(service.batch_sizes)
        want_launches = 2 * sum(batches.values()) + 2 * 3 * 2  # + 3 orbits of 2 chunks
        peak = torch.cuda.max_memory_allocated()
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    log(f"[server] /orbit 30 frames (MJPEG over HTTP): {30e3 / orbit_ms[0]:.3f} / "
        f"{30e3 / orbit_ms[1]:.3f} frames/s (first, second call); render_orbit without "
        f"HTTP/JPEG: {30e3 / direct_ms:.3f} frames/s; chunks of {service.frames_per_chunk}")
    log(f"[server] osg_decode launches={launches} (want {want_launches}: 2 per render batch, "
        f"batches by size {batches}, 2 per orbit chunk) max_memory_allocated={peak} bytes")
    if launches != want_launches:
        raise SystemExit(f"chip_smoke: server path launched osg_decode {launches} times, "
                         f"want {want_launches}")
    return launches


def phase_shapes():
    """`generate_videos` with --gen_shapes at full width: 2 frames, then the
    fp32 sigma sweep. The volume reads back with the right shape, finite and
    not constant inside the border mask; marching tetrahedra at the middle of
    its range gives a mesh with faces. A second sweep of the same identity
    is timed alone."""
    import numpy as np
    import torch

    from gnerf_tpu_torch.infer import gen_videos as gv
    from gnerf_tpu_torch.infer import shape_utils
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode

    shape_res = SHAPE_RES
    chunks = -(-shape_res ** 3 // SHAPE_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        osg_decode.launches = 0
        t0 = time.perf_counter()
        res = gv.generate_videos(None, seed_init=0, frames=2, gen_shapes=True,
                                 shape_res=shape_res, video_out_path=tmp, outdir=tmp,
                                 device="cuda")
        wall = time.perf_counter() - t0
        launches = osg_decode.launches
        vol = shape_utils.read_mrc(res["mrc"])
        pad, pad_top = int(30 * shape_res / 256), int(38 * shape_res / 256)
        inner = vol[pad:-pad, pad:-pad_top, pad:-pad]
        lo, hi = float(inner.min()), float(inner.max())
        t1 = time.perf_counter()
        verts, faces = shape_utils.marching_tetrahedra(vol, level=(lo + hi) / 2)
        ply = os.path.join(tmp, "shape.ply")
        shape_utils.write_ply(ply, verts, faces)
        mesh_s = time.perf_counter() - t1
        ply_bytes = os.path.getsize(ply)
    log(f"[shapes] generate_videos(gen_shapes) {shape_res}^3: {wall:.2f} s (2 frames + sweep, "
        f"first call); osg_decode launches={launches} (want {2 * 2} + {chunks}); volume "
        f"{vol.shape} finite={bool(np.isfinite(vol).all())} inside mask [{lo:.4g}, {hi:.4g}]; "
        f"mesh at {(lo + hi) / 2:.4g}: {len(verts)} vertices, {len(faces)} faces, "
        f"{ply_bytes} PLY bytes, {mesh_s:.2f} s on the host")
    if vol.shape != (shape_res,) * 3 or not np.isfinite(vol).all() or not hi > lo:
        raise SystemExit("chip_smoke: bad sigma volume")
    if len(faces) == 0 or launches != 2 * 2 + chunks:
        raise SystemExit(f"chip_smoke: {len(faces)} faces, {launches} osg_decode launches")

    g, enc = gv.load_networks(None, seed_init=0, device="cuda")
    ws, _ = gv.prepare_identity(g, enc, gv._load_images(None, None))
    shape_utils.extract_sigma_grid(g, ws[:1], voxel_resolution=64, cube_length=1.0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    osg_decode.launches = 0
    t0 = time.perf_counter()
    again = shape_utils.extract_sigma_grid(g, ws[:1], voxel_resolution=shape_res,
                                           cube_length=g.rendering_kwargs["box_warp"])
    sweep_ms = (time.perf_counter() - t0) * 1e3
    sweep_launches = osg_decode.launches
    peak = torch.cuda.max_memory_allocated()

    from gnerf_tpu_torch.render.renderer import run_model

    with torch.inference_mode():  # one chunk of the sweep loop, on the device timeline
        planes = g.backbone_planes(ws[:1], noise_mode="const")
        opts = dict(g.rendering_kwargs)

        def chunk():
            coords = shape_utils.grid_points(shape_res, 0, SHAPE_CHUNK, 1.0,
                                             device=planes.device)[None]
            dirs = torch.zeros_like(coords)
            dirs[..., 2] = -1.0
            return run_model(planes, g.decoder, coords, dirs, opts)["sigma"]

        chunk_ms = cuda_ms(chunk, iters=10, warmup=2)
    log(f"[shapes] extract_sigma_grid {shape_res}^3 alone: total_ms={sweep_ms:.3f} "
        f"({chunks} chunks of {SHAPE_CHUNK} points, planes built once, volume copied to the "
        f"host; {sweep_ms / chunks:.3f} ms per chunk) one chunk on the device: "
        f"chunk_ms={chunk_ms:.3f} launches={sweep_launches} max_memory_allocated={peak} bytes; "
        f"max |again - first|={float(np.abs(again - vol).max()):.3e}")
    if sweep_launches != chunks or not np.allclose(again, vol, rtol=1e-4, atol=1e-5):
        raise SystemExit("chip_smoke: the sweep is not repeatable or launched wrongly")
    return launches, vol


def _state_tensors(state) -> dict:
    """Every tensor a train state (G-NeRF or EG3D) holds: module state_dicts
    and Adam states."""
    out = {}
    for name in ("g", "g_ema", "enc", "disc", "vgg"):
        module = getattr(state, name, None)
        if module is not None:
            out.update({f"{name}.{k}": v for k, v in module.state_dict().items()})
    for name in ("opt_g", "opt_d"):
        opt = getattr(state, name)
        for i, p in enumerate(p for grp in opt.param_groups for p in grp["params"]):
            out.update({f"{name}.{i}.{k}": v for k, v in opt.state.get(p, {}).items()})
    return out


def _full_width_g_cfg() -> dict:
    """The `ffhq` preset's G at full width, as `gnerf_tpu_torch.training.train`
    builds it: its constructor arguments (the rest are the defaults)."""
    from gnerf_tpu_torch.training.train import RENDERING_PRESETS, _rendering_kwargs

    rk = _rendering_kwargs(RENDERING_PRESETS["ffhq"], False, 1.0, "none", 0.25, 1.0, "")
    return dict(img_resolution=SIDE, rendering_kwargs=rk)


def _full_width_g(seed: int):
    """That G on the card, drawn from PRNGKey(seed)."""
    from gnerf_tpu_torch.models import TriPlaneGenerator
    from gnerf_tpu_torch.utils import prng

    return TriPlaneGenerator(**_full_width_g_cfg(), device="cuda", key=prng.PRNGKey(seed))


def _full_width_trainer(seed: int):
    """The `ffhq` preset's networks at full width on the card, as
    `gnerf_tpu_torch.training.train` builds them from `--seed` (the JAX
    CLI's weights for that seed)."""
    from gnerf_tpu_torch.training import TrainConfig, init_train_state
    from gnerf_tpu_torch.training.train import gnerf_networks

    cfg = TrainConfig(batch_size=TRAIN_BATCH)
    g, enc, disc, vgg, _ = gnerf_networks(seed, cfg, 512, 512, SIDE,
                                          _full_width_g_cfg()["rendering_kwargs"], device="cuda")
    return init_train_state(g, enc, disc, vgg, cfg), cfg


def _draw_share(tag, calls: dict) -> dict:
    """Each of `calls` {name: fn} once under torch.profiler, with every
    outermost call into `utils.prng` (split, fold_in, bits, uniform, normal,
    randint) inside a record_function range "prng_draw": {name: (the call's
    device ms, the ranges' device ms, the number of prng calls)}, printed
    with the share and the call's CUDA-event ms. The device ms are the
    kernels' own (the profile's device events, each counted once); the
    ranges' are the kernels launched inside them."""
    import functools

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from gnerf_tpu_torch.utils import prng

    depth, count = [0], [0]
    names = ("split", "fold_in", "bits", "uniform", "normal", "randint")
    orig = {n: getattr(prng, n) for n in names}

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            if depth[0]:
                return fn(*a, **k)
            depth[0] += 1
            count[0] += 1
            try:
                with record_function("prng_draw"):
                    return fn(*a, **k)
            finally:
                depth[0] -= 1
        return inner

    out = {}
    for n in names:
        setattr(prng, n, wrap(orig[n]))
    try:
        for name, fn in calls.items():
            count[0] = 0
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                ev[0].record()
                fn()
                ev[1].record()
                torch.cuda.synchronize()
            ka = prof.key_averages()
            total = sum(_dev_ms(e, "self_cuda_time_total") for e in ka
                        if e.device_type == DeviceType.CUDA)
            draws = sum(_dev_ms(e, "cuda_time_total") for e in ka if e.key == "prng_draw")
            out[name] = (total, draws, count[0])
            log(f"[{tag}] threefry share of one {name}: {count[0]} prng calls, {draws:.3f} ms "
                f"of {total:.3f} ms of kernel time ({100 * draws / max(total, 1e-9):.2f} %); "
                f"{ev[0].elapsed_time(ev[1]):.3f} ms by CUDA events (profiled)")
    finally:
        for n in names:
            setattr(prng, n, orig[n])
    return out


def phase_train(warmup: int = 2, steps: int = 6):
    """The full-width G-NeRF train step on the card (see the module
    docstring). Step times are CUDA-event times of whole steps (data already
    on the card), median and spread over `steps`."""
    import numpy as np
    import torch

    from gnerf_tpu_torch.ops.fused_decoder import osg_decode
    from gnerf_tpu_torch.training import (SyntheticDataset, data_iterator, load_train_state,
                                          make_train_step, save_train_state)
    from gnerf_tpu_torch.training.train import step_key

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, cfg = _full_width_trainer(0)
    step = make_train_step(cfg)
    build_s = time.perf_counter() - t0
    batches = data_iterator(SyntheticDataset(resolution=SIDE, depth_resolution=64),
                            batch_size=TRAIN_BATCH, seed=0)
    host = [next(batches) for _ in range(warmup + steps + 1)]
    dev = [{k: torch.from_numpy(np.asarray(v)).cuda() for k, v in b.items()} for b in host]
    before = {k: v.clone() for k, v in _state_tensors(state).items()
              if k.split(".")[0] in ("g", "enc", "disc")}

    osg_decode.launches = 0
    losses, ev = [], [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    for i in range(warmup + steps):
        if i == warmup:
            ev[0].record()
        _, stats = step(state, dev[i], step_key(0, state.cur_nimg))
        if i >= warmup:
            ev[i - warmup + 1].record()
        losses.append(stats)
    torch.cuda.synchronize()
    launches = osg_decode.launches
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    peak = torch.cuda.max_memory_allocated()
    losses = [{k: float(v) for k, v in s.items()} for s in losses]
    after = _state_tensors(state)
    moved = {name: any(not torch.equal(after[k], v) for k, v in before.items()
                       if k.startswith(name + "."))
             for name in ("enc", "disc")}
    bn_moved = any(not torch.equal(after[k], v) for k, v in before.items()
                   if k.startswith("enc.") and k.endswith((".mean", ".var")))
    trained_g = {f"g.{n}" for n, p in state.g.named_parameters() if p.requires_grad}
    g_frozen = all(torch.equal(after[k], v) for k, v in before.items()
                   if k.startswith("g.") and k not in trained_g)
    finite = all(np.isfinite(v) for s in losses for v in s.values())
    want_launches = 2 * (warmup + steps) * (2 if cfg.remat_synthesis else 1)
    med = statistics.median(step_ms)
    log(f"[train] full width fp32, batch {TRAIN_BATCH}: build {build_s:.2f} s; step_ms median="
        f"{med:.3f} min={min(step_ms):.3f} max={max(step_ms):.3f} (each: "
        f"{', '.join(f'{x:.3f}' for x in step_ms)}) images_per_s={TRAIN_BATCH * 1e3 / med:.3f} "
        f"max_memory_allocated={peak} bytes; remat_synthesis={cfg.remat_synthesis} "
        f"remat_lpips={cfg.remat_lpips}; osg_decode launches={launches} (want {want_launches})")
    log("[train] losses, last step: " + " ".join(f"{k}={v:.5f}" for k, v in losses[-1].items()))
    log(f"[train] finite={finite} E moved={moved['enc']} D moved={moved['disc']} "
        f"BN buffers moved={bn_moved} G bitwise frozen={g_frozen} (outside the "
        f"{len(trained_g)} G tensors it trains)")
    if not (finite and moved["enc"] and moved["disc"] and bn_moved and g_frozen):
        raise SystemExit("chip_smoke: the train step did not update as it should")
    if launches != want_launches:
        raise SystemExit(f"chip_smoke: train path launched osg_decode {launches} times")
    _draw_share("train", {"step": lambda: step(state, dev[0], step_key(0, state.cur_nimg))})

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "training-state.npz")
        t0 = time.perf_counter()
        save_train_state(path, state, config={"chip_smoke": True}, best_ssim=0.5)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        del before, after
        again, _ = _full_width_trainer(1)
        t0 = time.perf_counter()
        load_train_state(path, again)
        load_s = time.perf_counter() - t0
    a, b = _state_tensors(state), _state_tensors(again)
    bitwise = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k].to(a[k].device)) for k in a)
    del a, b
    nxt = dev[warmup + steps]
    outs = []
    for st in (state, again):
        _, s2 = make_train_step(cfg)(st, nxt, step_key(0, st.cur_nimg))
        outs.append({k: float(v) for k, v in s2.items()})
    err = max(abs(outs[0][k] - v) / max(abs(v), 1e-3) for k, v in outs[1].items())
    log(f"[train] full-state save {size} bytes in {save_s:.2f} s, load in {load_s:.2f} s: "
        f"bitwise={bitwise}; next step saved vs loaded: max rel stat err={err:.3e} (1e-3; "
        "grid_sample's backward uses atomics)")
    if not bitwise or err > 1e-3:
        raise SystemExit("chip_smoke: the full-state checkpoint does not give the state back")
    del state, again, dev
    torch.cuda.empty_cache()
    return launches


def _full_width_eg3d(seed: int, **cfg_overrides):
    """The `ffhq` preset's G and the 512^2 dual D on the card, with the
    EG3DLossConfig and lazy optimizers `gnerf_tpu_torch.training.train`
    builds for `--objective eg3d --batch 4` (seed-init weights)."""
    import dataclasses

    from gnerf_tpu_torch.training import TrainConfig, init_eg3d_state
    from gnerf_tpu_torch.training.train import eg3d_loss_config, eg3d_networks

    g, disc = eg3d_networks(seed, 512, 512, SIDE, _full_width_g_cfg()["rendering_kwargs"],
                            device="cuda")
    cfg = eg3d_loss_config(g.rendering_kwargs, TrainConfig(batch_size=TRAIN_BATCH),
                           g.neural_rendering_resolution)
    cfg = dataclasses.replace(cfg, **cfg_overrides)
    return init_eg3d_state(g, disc, cfg, lazy=True), cfg


def _eg3d_batches(n: int) -> list:
    """n batches of SyntheticDataset at 512^2 on the card, z drawn on the
    card as the CLI draws it for cur_nimg = 4 i (fold_in(kz, 0))."""
    import numpy as np
    import torch

    from gnerf_tpu_torch.training import SyntheticDataset, data_iterator
    from gnerf_tpu_torch.training.train import step_key
    from gnerf_tpu_torch.utils import prng

    it = data_iterator(SyntheticDataset(resolution=SIDE), batch_size=TRAIN_BATCH, seed=0)
    out = []
    for i in range(n):
        raw = next(it)
        c = torch.from_numpy(np.asarray(raw["loss_c"], np.float32)).cuda()
        kz = prng.split(step_key(0, TRAIN_BATCH * i))[0]
        z = prng.normal(prng.fold_in(kz, 0), (TRAIN_BATCH, 512), device="cuda")
        real = torch.from_numpy(np.asarray(raw["loss_image"])).cuda().float() / 127.5 - 1.0
        out.append({"z": z, "c": c, "real_image": real, "real_c": c})
    return out


def _eg3d_step(phases, state, batch, seed=0, aug_p=0.0):
    """One scheduled EG3D step as the CLI runs it: Gmain + Dmain, Greg when
    sched_idx % 4 == 0, Dreg when sched_idx % 16 == 0, D's inputs augmented
    at strength `aug_p` under aug='ada'. Returns ({phase: (start event, end
    event, osg_decode launches)}, stats)."""
    import torch

    from gnerf_tpu_torch.ops.fused_decoder import osg_decode
    from gnerf_tpu_torch.training.train import step_key
    from gnerf_tpu_torch.utils import prng

    main, greg, dreg = phases
    cur = state.cur_nimg
    sched = cur // TRAIN_BATCH
    ks = prng.split(step_key(seed, cur))[1]
    runs = [("main", lambda: main(state, batch, ks, 0.0, aug_p))]
    if sched % 4 == 0:
        runs.append(("greg", lambda: greg(state, batch, prng.fold_in(ks, 1))))
    if sched % 16 == 0:
        runs.append(("dreg", lambda: dreg(state, batch, prng.fold_in(ks, 2), 0.0, aug_p)))
    marks, stats = {}, {}
    for name, fn in runs:
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        before = osg_decode.launches
        ev[0].record()
        stats.update(fn()[1])
        ev[1].record()
        marks[name] = (ev[0], ev[1], osg_decode.launches - before)
    return marks, stats


def _eg3d_run(tag, phases, state, cfg, batches, warmup, steps, ada=None):
    """`warmup` + `steps` scheduled EG3D steps (see `_eg3d_step`), the ADA
    strength from `ada` (an AdaController) when given. Checks osg_decode's
    launches per phase exactly (Gmain's 2 passes with grad, again in the
    recompute under remat, the D phase's 2 regenerated without; Greg's one
    sample_mixed pass; none in Dreg) and the phases run; prints per-phase
    CUDA-event ms, the amortised step, images/s and peak memory. Returns
    (launches, per-step stats, the p each step ran at)."""
    import numpy as np
    import torch

    from gnerf_tpu_torch.ops.fused_decoder import osg_decode

    osg_decode.launches = 0
    runs, losses, ps = [], [], []
    window = [torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)]
    p = ada.p if ada is not None else 0.0
    for i in range(warmup + steps):
        if i == warmup:
            window[0].record()
        marks, stats = _eg3d_step(phases, state, batches[i], aug_p=p)
        ps.append(p)
        if ada is not None:
            p = ada.report(stats["Loss/signs/real"])
        runs.append(marks)
        losses.append(stats)
    window[1].record()
    torch.cuda.synchronize()
    launches = osg_decode.launches
    peak = torch.cuda.max_memory_allocated()
    window_ms = window[0].elapsed_time(window[1])
    want = {"main": 2 * (2 if cfg.remat_synthesis else 1) + 2, "greg": 1, "dreg": 0}
    by_phase = {}
    for i, marks in enumerate(runs):
        for name, (a, b, n) in marks.items():
            if n != want[name]:
                raise SystemExit(f"chip_smoke: {tag} {name} launched osg_decode {n} times "
                                 f"in step {i}, want {want[name]}")
            if i >= warmup:
                by_phase.setdefault(name, []).append(a.elapsed_time(b))
    counts = {k: len(v) for k, v in by_phase.items()}
    if counts != {"main": steps, "greg": steps // 4, "dreg": 1}:
        raise SystemExit(f"chip_smoke: the {tag} window ran {counts}")
    amortised = window_ms / steps
    for name, ms in by_phase.items():
        log(f"[{tag}] {name}: n={len(ms)} median_ms={statistics.median(ms):.3f} "
            f"min={min(ms):.3f} max={max(ms):.3f} (each: {', '.join(f'{x:.3f}' for x in ms)}) "
            f"osg_decode launches per call={want[name]}")
    total_launches = sum(n for marks in runs for _, _, n in marks.values())
    log(f"[{tag}] full width fp32, batch {TRAIN_BATCH}, lazy (Greg / 4, Dreg / 16), aug="
        f"{cfg.aug}: {steps} scheduled steps in {window_ms:.3f} ms: amortised step_ms="
        f"{amortised:.3f} images_per_s={TRAIN_BATCH * 1e3 / amortised:.3f} "
        f"max_memory_allocated={peak} bytes; remat_synthesis={cfg.remat_synthesis}; "
        f"osg_decode launches={launches} (per phase summed: {total_launches})")
    if launches != total_launches:
        raise SystemExit(f"chip_smoke: {tag} launched osg_decode outside its phases")
    losses = [{k: float(v) for k, v in s.items()} for s in losses]
    log(f"[{tag}] losses, last step: " + " ".join(f"{k}={v:.5f}" for k, v in losses[-1].items()))
    if not all(np.isfinite(v) for s in losses for v in s.values()):
        raise SystemExit(f"chip_smoke: non-finite {tag} losses")
    return launches, losses, ps


def phase_eg3d(warmup: int = 2, steps: int = 16):
    """The full-width EG3D objective on the card (see the module docstring).
    Phase times are CUDA-event times with the batches already on the card."""
    import torch

    from gnerf_tpu_torch.training import make_eg3d_phase_steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, cfg = _full_width_eg3d(0)
    phases = make_eg3d_phase_steps(cfg)
    log(f"[eg3d] build {time.perf_counter() - t0:.2f} s")
    batches = _eg3d_batches(warmup + steps + 1)
    before = {k: v.clone() for k, v in _state_tensors(state).items()
              if k.split(".")[0] in ("g", "g_ema", "disc")}
    launches, _, _ = _eg3d_run("eg3d", phases, state, cfg, batches, warmup, steps)
    after = _state_tensors(state)
    moved = {name: any(not torch.equal(after[k], v) for k, v in before.items()
                       if k.startswith(name + "."))
             for name in ("g", "g_ema", "disc")}
    key = "g.backbone.mapping.w_avg"
    moved["w_avg"] = not torch.equal(after[key], before[key])
    log("[eg3d] moved: " + " ".join(f"{k}={v}" for k, v in moved.items()))
    if not all(moved.values()):
        raise SystemExit("chip_smoke: the eg3d steps did not update as they should")
    del before, after
    _eg3d_draw_share("eg3d", phases, state, batches[0])

    _eg3d_dreg_profile(phases, state, batches[0])
    _eg3d_save_load(phases, state, batches[warmup + steps])
    _eg3d_freeze(batches[0])
    del state, batches
    torch.cuda.empty_cache()
    return launches


def _eg3d_draw_share(tag, phases, state, batch, aug_p=0.0):
    """The threefry share of each phase (`_draw_share`) and of the lazy
    schedule's amortised step (Gmain + Dmain + Greg / 4 + Dreg / 16)."""
    from gnerf_tpu_torch.utils import prng

    main, greg, dreg = phases
    ks = prng.PRNGKey(state.cur_nimg)
    out = _draw_share(tag, {"Gmain + Dmain": lambda: main(state, batch, ks, 0.0, aug_p),
                            "Greg": lambda: greg(state, batch, prng.fold_in(ks, 1)),
                            "Dreg": lambda: dreg(state, batch, prng.fold_in(ks, 2), 0.0, aug_p)})
    weights = {"Gmain + Dmain": 1.0, "Greg": 0.25, "Dreg": 1 / 16}
    total = sum(out[k][0] * w for k, w in weights.items())
    draws = sum(out[k][1] * w for k, w in weights.items())
    log(f"[{tag}] threefry share of the amortised step: {draws:.3f} ms of {total:.3f} ms "
        f"device time ({100 * draws / max(total, 1e-9):.2f} %)")
    return out


def _ada_share(pipe, p: float, n: int = 256, chunk: int = 32):
    """The share of n random 6-channel 512^2 pairs the bgc pipe changes at
    strength p (bitwise against the same draws at p = 0, where no gate
    opens), and its expected value: a sample is left alone when every
    augmentation's gate stays shut or draws the identity (x-flip and
    luma flip 1/2, rotate90 1/4 of the time; each rotation fires with
    p_rot = 1 - sqrt(1 - p))."""
    import torch

    from gnerf_tpu_torch.utils import prng

    changed = 0
    for k in range(n // chunk):
        x = prng.uniform(prng.PRNGKey(100 + k), (chunk, 6, SIDE, SIDE), -1.0, 1.0,
                         device="cuda")
        with torch.no_grad():
            a = pipe(prng.PRNGKey(k), x, p=p)
            b = pipe(prng.PRNGKey(k), x, p=0.0)
        changed += int((a != b).flatten(1).any(dim=1).sum())
        del x, a, b
    p_rot = 1 - (1 - p) ** 0.5
    keep = (1 - 0.5 * p) ** 2 * (1 - 0.75 * p) * (1 - p) ** 8 * (1 - p_rot) ** 2
    return changed / n, 1 - keep


def phase_eg3d_ada(warmup: int = 2, steps: int = 16, p0: float = 0.2):
    """The eg3d run under --aug ada from p = p0 (see the module docstring)."""
    import torch

    from gnerf_tpu_torch.training import (AdaController, make_augment_pipe,
                                          make_eg3d_phase_steps)
    from gnerf_tpu_torch.utils import prng

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, cfg = _full_width_eg3d(0, aug="ada", aug_p=p0)
    phases = make_eg3d_phase_steps(cfg)
    batches = _eg3d_batches(warmup + steps)
    ada = AdaController(cfg, TRAIN_BATCH, cfg.aug_p)
    launches, losses, ps = _eg3d_run("eg3d_ada", phases, state, cfg, batches, warmup, steps,
                                     ada=ada)
    # The controller against its arithmetic: after each window of
    # ada_interval steps, p + sign(mean sign(D(real)) - target) * B * interval
    # / (ada_kimg * 1000), clipped to [0, 1].
    interval, want, windows = cfg.ada_interval, p0, []
    for w in range(len(ps) // interval):
        rt = float(torch.tensor([s["Loss/signs/real"] for s in losses[w * interval:
                                                                   (w + 1) * interval]]).mean())
        step = TRAIN_BATCH * interval / (cfg.ada_kimg * 1000.0)
        want = min(max(want + (step if rt > cfg.ada_target else -step
                               if rt < cfg.ada_target else 0.0), 0.0), 1.0)
        got = ps[(w + 1) * interval] if (w + 1) * interval < len(ps) else ada.p
        windows.append((rt, got, want))
    log("[eg3d_ada] controller p after each window (r_t, p, expected): "
        + "; ".join(f"{rt:+.4f} {got!r} {want!r}" for rt, got, want in windows))
    if len(windows) < 2 or any(got != want for _, got, want in windows):
        raise SystemExit("chip_smoke: the ADA controller's p disagrees with its arithmetic")
    _eg3d_draw_share("eg3d_ada", phases, state, batches[0], aug_p=ada.p)
    _eg3d_dreg_profile(phases, state, batches[0], aug_p=ada.p, tag="eg3d_ada")

    pipe = make_augment_pipe(cfg)
    pair = torch.cat([batches[0]["real_image"], batches[1]["real_image"]], dim=1)
    pipe_ms = cuda_ms(lambda: pipe(prng.PRNGKey(0), pair, p=p0), iters=10, warmup=2)
    del state, batches
    torch.cuda.empty_cache()
    share, expect = _ada_share(pipe, p0)
    sigma = (expect * (1 - expect) / 256) ** 0.5
    log(f"[eg3d_ada] pipe forward on {list(pair.shape)} fp32 at p={p0}: {pipe_ms:.3f} ms; "
        f"share of 256 samples changed at p={p0}: {share:.4f} (expected {expect:.4f}, "
        f"3 sigma {3 * sigma:.4f})")
    if abs(share - expect) > 3 * sigma:
        raise SystemExit("chip_smoke: the ADA pipe changes the wrong share of samples")
    return launches


def _eg3d_dreg_profile(phases, state, batch, aug_p=None, tag="eg3d"):
    """One Dreg (R1 through both inputs of the 512^2 D, and its weight
    gradient; with `aug_p`, through the ADA pipe too) under torch.profiler:
    no `aten::_convolution_double_backward`; with the pipe, grid_sample's
    backward in R1's graph."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnerf_tpu_torch.utils import prng

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        phases[2](state, batch, prng.fold_in(prng.PRNGKey(state.cur_nimg), 2), 0.0,
                  aug_p or 0.0)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    keys = {e.key: e.count for e in avg}
    convs = keys.get("aten::convolution", 0)
    grid = {k: keys.get(k, 0) for k in ("aten::grid_sampler_2d", "aten::grid_sampler_2d_backward")}
    log(f"[{tag}] Dreg profile: {convs} convolutions, _convolution_double_backward calls="
        f"{keys.get('aten::_convolution_double_backward', 0)}, grid_sample calls {grid}; "
        "top device ops:\n"
        + "\n".join(avg.table(sort_by="cuda_time_total", row_limit=12).splitlines()[:16]))
    if "aten::_convolution_double_backward" in keys:
        raise SystemExit("chip_smoke: R1 through the dual D ran a convolution double backward")
    if aug_p is not None and grid["aten::grid_sampler_2d_backward"] == 0:
        raise SystemExit("chip_smoke: R1 did not differentiate through the pipe's warp")


def _eg3d_save_load(phases, state, batch):
    """Full-state save and load into a second full-width state: bitwise; the
    next scheduled step from both agrees within 1e-3 (grid_sample's backward
    uses atomics)."""
    import torch

    from gnerf_tpu_torch.training import load_train_state, save_train_state

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "training-state.npz")
        t0 = time.perf_counter()
        save_train_state(path, state, config={"chip_smoke": True, "aug_p_live": 0.0})
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        again, _ = _full_width_eg3d(1)
        t0 = time.perf_counter()
        _, config, _ = load_train_state(path, again)
        load_s = time.perf_counter() - t0
    a, b = _state_tensors(state), _state_tensors(again)
    bitwise = a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k].to(a[k].device)) for k in a)
    del a, b
    outs = []
    for st in (state, again):
        _, s2 = _eg3d_step(phases, st, batch)
        outs.append({k: float(v) for k, v in s2.items()})
    err = max(abs(outs[0][k] - v) / max(abs(v), 1e-3) for k, v in outs[1].items())
    log(f"[eg3d] full-state save {size} bytes in {save_s:.2f} s, load in {load_s:.2f} s: "
        f"bitwise={bitwise} aug_p_live={config['aug_p_live']}; next step saved vs loaded: "
        f"max rel stat err={err:.3e} (1e-3)")
    if not bitwise or err > 1e-3 or sorted(outs[0]) != sorted(outs[1]):
        raise SystemExit("chip_smoke: the eg3d full-state checkpoint does not give the state back")


def _eg3d_freeze(batch):
    """--freezed 2 at full width: b512's fromrgb and conv0 stay bitwise
    through a main and a Dreg step; every other D tensor moves."""
    import torch

    from gnerf_tpu_torch.training import make_eg3d_phase_steps
    from gnerf_tpu_torch.training.train import step_key
    from gnerf_tpu_torch.utils import prng

    state, cfg = _full_width_eg3d(2, freeze_d_layers=2)
    main, _, dreg = make_eg3d_phase_steps(cfg)
    before = {k: v.clone() for k, v in state.disc.state_dict().items()}
    ks = prng.split(step_key(2, 0))[1]
    main(state, batch, ks)
    dreg(state, batch, prng.fold_in(ks, 2))
    top = f"b{state.disc.block_resolutions[0]}"  # b512, D's first block
    frozen = (f"{top}.fromrgb.", f"{top}.conv0.")
    wrong = [k for k, v in state.disc.state_dict().items()
             if torch.equal(v, before[k]) != k.startswith(frozen)]
    n_frozen = sum(k.startswith(frozen) for k in before)
    log(f"[eg3d] --freezed 2: {n_frozen} D tensors frozen bitwise, the other "
        f"{len(before) - n_frozen} moved: {not wrong}")
    if wrong:
        raise SystemExit(f"chip_smoke: Freeze-D moved or froze the wrong tensors: {wrong[:4]}")


def _pti_batch(g, n: int = TRAIN_BATCH):
    """n SyntheticDataset targets at 512^2 on the card, and pivot ws from
    seeded z (the CLI's default pivot is the encoder's)."""
    import numpy as np
    import torch

    from gnerf_tpu_torch.training import SyntheticDataset, collate

    items = collate([SyntheticDataset(resolution=SIDE)[i] for i in range(n)])
    c = torch.from_numpy(np.asarray(items["loss_c"], np.float32)).cuda()
    z = torch.randn((n, g.z_dim), generator=torch.Generator().manual_seed(11)).cuda()
    with torch.no_grad():
        ws = g.mapping(z, c)
    image = torch.from_numpy(np.asarray(items["loss_image"], np.float32)).cuda() / 127.5 - 1.0
    return {"ws": ws, "loss_image": image, "loss_c": c}


def phase_pti(warmup: int = 2, steps: int = 8, project_steps: int = 6):
    """PTI at full width on the card (see the module docstring): step times
    are CUDA-event times of whole steps with the batch on the card."""
    import numpy as np
    import torch

    from gnerf_tpu_torch.ops.fused_decoder import osg_decode
    from gnerf_tpu_torch.training import (PTIConfig, VGG16LPIPS, init_pti_state, make_pti_step,
                                          project_w)
    from gnerf_tpu_torch.utils import prng

    g = _full_width_g(0).requires_grad_(False).eval()
    vgg = VGG16LPIPS(device="cuda", key=prng.PRNGKey(7))
    batch = _pti_batch(g)
    osg_decode.launches = 0
    for locality in (False, True):
        cfg = PTIConfig(neural_rendering_resolution=g.neural_rendering_resolution,
                        use_locality_reg=locality)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = init_pti_state(g, vgg, cfg)
        step = make_pti_step(cfg)
        rng = prng.PRNGKey(0, device="cuda")
        before = {n: p.detach().clone() for n, p in state.g.named_parameters()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(warmup + steps + 1)]
        launches, losses = [], []
        for i in range(warmup + steps):
            n0 = osg_decode.launches
            ev[i].record()
            rng, key = prng.split(rng)
            losses.append(step(state, batch, key)[1])
            ev[i + 1].record()
            launches.append(osg_decode.launches - n0)
        torch.cuda.synchronize()
        step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(warmup, warmup + steps)]
        peak = torch.cuda.max_memory_allocated()
        want = 2 + (4 if locality else 0)  # 2 passes with grad; the original G's 2 without
        trained = {id(p) for p in state.opt.state if state.opt.state[p]["exp_avg"].any()}
        sr_bitwise = all(torch.equal(p, before[n]) for n, p in state.g.named_parameters()
                         if n.startswith("superresolution."))
        reached = [(n, p) for n, p in state.g.named_parameters() if id(p) in trained]
        moved = all(not torch.equal(p, before[n]) for n, p in reached)
        still = sum(1 for n, p in state.g.named_parameters()
                    if id(p) not in trained and not n.startswith("superresolution.")
                    and torch.equal(p, before[n]))
        losses = [{k: float(v) for k, v in s.items()} for s in losses]
        finite = all(np.isfinite(v) for s in losses for v in s.values())
        med = statistics.median(step_ms)
        tag = "locality" if locality else "plain"
        log(f"[pti] {tag}: full width fp32, batch {TRAIN_BATCH}, LPIPS at {vgg.resize_to}^2: "
            f"step_ms median={med:.3f} min={min(step_ms):.3f} max={max(step_ms):.3f} (each: "
            f"{', '.join(f'{x:.3f}' for x in step_ms)}) images_per_s="
            f"{TRAIN_BATCH * 1e3 / med:.3f} max_memory_allocated={peak} bytes; osg_decode "
            f"launches per step {sorted(set(launches))} (want {want})")
        log(f"[pti] {tag}: losses first / last step: "
            + " ".join(f"{k}={losses[0][k]:.5f}/{v:.5f}" for k, v in losses[-1].items())
            + f"; finite={finite} SR bitwise={sr_bitwise}; {len(reached)} weights the loss "
            f"reaches, all moved={moved}; {still} others (zero gradient) unchanged")
        if not (finite and sr_bitwise and moved and reached) or set(launches) != {want}:
            raise SystemExit(f"chip_smoke: the {tag} PTI step did not update as it should")
        del state, step, before
        torch.cuda.empty_cache()

    torch.cuda.synchronize()
    project_w(g, vgg, batch["loss_image"], batch["loss_c"], num_steps=2, start_ws=batch["ws"])
    torch.cuda.synchronize()
    n0 = osg_decode.launches
    t0 = time.perf_counter()
    ws, hist = project_w(g, vgg, batch["loss_image"], batch["loss_c"],
                         num_steps=project_steps, start_ws=batch["ws"])
    torch.cuda.synchronize()
    proj_ms = (time.perf_counter() - t0) * 1e3 / project_steps
    n_proj = osg_decode.launches - n0
    log(f"[pti] project_w: {project_steps} steps at {proj_ms:.3f} ms per step (host clock, "
        f"one loss read back per step, the 600 w_avg draws included); loss {hist[0]:.5f} -> "
        f"{hist[-1]:.5f}; ws {tuple(ws.shape)}; osg_decode launches={n_proj} "
        f"(want {2 * project_steps})")
    if n_proj != 2 * project_steps or not np.isfinite(hist).all():
        raise SystemExit("chip_smoke: project_w launched wrongly or gave non-finite losses")
    return osg_decode.launches


def phase_eval(max_items: int = 8, batch: int = 4):
    """run_eval at full width through both routes, then the FID parts (see
    the module docstring). FID values on random weights mean nothing; only
    times and finiteness are read."""
    import numpy as np
    import torch

    from gnerf_tpu_torch.models import ResNeXt50Encoder
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode
    from gnerf_tpu_torch.training import (InceptionV3Features, feature_statistics,
                                          frechet_distance, load_inception)
    from gnerf_tpu_torch.training.eval import run_eval
    from gnerf_tpu_torch.utils import checkpoint as ckpt
    from gnerf_tpu_torch.utils import prng

    g = _full_width_g(0)
    enc = ResNeXt50Encoder(out_dim=g.z_dim, device="cuda", key=prng.PRNGKey(1))
    config = {"generator": json.loads(json.dumps(_full_width_g_cfg()))}
    osg_decode.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        full, gen_only = os.path.join(tmp, "full.npz"), os.path.join(tmp, "g.npz")
        ckpt.save_checkpoint(full, {"G_ema": g, **ckpt.encoder_trees(enc)}, config=config)
        ckpt.save_checkpoint(gen_only, {"G_ema": g}, config=config)
        del g, enc
        for name, path, keys in (("reconstruction", full, ("psnr", "ssim", "lpips")),
                                 ("generative", gen_only, ("frechet_vgg",))):
            torch.cuda.synchronize()
            n0 = osg_decode.launches
            t0 = time.perf_counter()
            summary = run_eval(network=path, max_items=max_items, batch=batch, device="cuda")
            wall = time.perf_counter() - t0
            n = osg_decode.launches - n0
            want = 2 * (max_items // batch)
            log(f"[eval] {name}: {wall:.2f} s for {max_items} items in batches of {batch} "
                f"(checkpoint load and first calls included); summary {summary}; osg_decode "
                f"launches={n} (want {want})")
            if n != want or summary["num_items"] != max_items or not all(
                    np.isfinite(summary[k]) for k in keys):
                raise SystemExit(f"chip_smoke: the {name} eval route failed")
        launches = osg_decode.launches
        inc_path = os.path.join(tmp, "inception.npz")
        ckpt.save_checkpoint(inc_path, {"inception": ckpt.module_params(InceptionV3Features(
            device="cuda", key=prng.PRNGKey(3)))})
        net = load_inception(inc_path, device="cuda")
    x = torch.rand((batch, 3, 299, 299), device="cuda") * 2 - 1
    feats = net.features(x)
    inc_ms = cuda_ms(lambda: net.features(x), iters=10, warmup=2)
    rs = np.random.RandomState(0)
    a, b = rs.randn(4096, 2048), rs.randn(4096, 2048) * 1.1 + 0.05
    t0 = time.perf_counter()
    (mu_a, sig_a), (mu_b, sig_b) = feature_statistics(a), feature_statistics(b)
    stats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fd = frechet_distance(mu_a, sig_a, mu_b, sig_b)
    fd_s = time.perf_counter() - t0
    log(f"[eval] InceptionV3Features at 299^2, batch {batch}, fp32 (weights written by this "
        f"phase): {inc_ms:.3f} ms, features {tuple(feats.shape)} finite="
        f"{bool(torch.isfinite(feats).all())}; host Frechet distance of 2048-d features "
        f"(4096 per side): statistics {stats_s:.3f} s, sqrtm and traces {fd_s:.3f} s, "
        f"finite={np.isfinite(fd)}")
    if feats.shape != (batch, 2048) or not torch.isfinite(feats).all() or not np.isfinite(fd):
        raise SystemExit("chip_smoke: the FID parts failed")
    del net, x, feats
    torch.cuda.empty_cache()
    return launches


DDP_TIMED_STEPS = 2   # timed calls of each distributed part after the compared one
# A distributed step is held to the plain world-1 step from the same state on the
# same global batch, tensor by tensor: its stats within max(1e-3 of their size,
# 3x the floor's), the gradients of each of E, G and D (Adam's first moments) in
# L2 relative to world 1's within max(DDP_GRAD_TOL, 3x the floor's), every tensor
# that is not trained (buffers, frozen weights) within 1e-5 + 1e-4 of its size.
# A trained weight is held through its gradient: after Adam's first step it has
# moved by about lr * sign(gradient) in either run, so its own gap says little.
# The floor is world 1 against itself: seeded, run twice (grid_sample's
# backward uses atomics); with rng=None, the larger gap of a run on the batch's
# rows shifted by one (exact arithmetic gives the same step) and of one on every
# float input nudged by one ulp. A seeded data=2 run is held to the larger of
# that floor and the seeded run's own: run twice and with inputs nudged (the
# draws stay those of the seed). A data shard runs its layers at other batch
# sizes, so its sums round otherwise; the encoder's E[x^2] - E[x]^2 BatchNorm
# moments and the render's sampling amplify such rounding.
DDP_STATS_TOL, DDP_GRAD_TOL = 1e-3, 1e-2


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ddp_snapshot(state, stats) -> dict:
    """On the host: the stats, every tensor of G, E and D, and for each
    trained parameter its Adam first moment."""
    out = {"stats": {k: float(v) for k, v in stats.items()}, "tensors": {}, "moments": {}}
    for name in ("g", "enc", "disc"):
        module = getattr(state, name, None)
        if module is None:
            continue
        for k, v in module.state_dict().items():
            out["tensors"][f"{name}.{k}"] = v.detach().cpu().clone()
        for opt in (state.opt_g, state.opt_d):
            for pn, p in module.named_parameters():
                if opt is not None and p in opt.state:
                    out["moments"][f"{name}.{pn}"] = opt.state[p]["exp_avg"].detach().cpu().clone()
    return out


def _ddp_gaps(got: dict, want: dict) -> dict:
    """How far a snapshot is from world 1's: stats_err (relative), grad_l2
    (each module's L2 gradient error relative to its norm), grad_gap (the
    worst tensor's max gradient error relative to its largest), param_err
    (max abs), bitwise, and the untrained tensors past their bound."""
    import torch

    stats_err = max(abs(got["stats"][k] - v) / max(abs(v), 1e-3) for k, v in want["stats"].items())
    sq = {}
    grad_gap = 0.0
    for k, m in want["moments"].items():
        d = (got["moments"][k].double() - m.double())
        module = k.split(".")[0]
        num, den = sq.get(module, (0.0, 0.0))
        sq[module] = (num + float(d.square().sum()), den + float(m.double().square().sum()))
        grad_gap = max(grad_gap, float(d.abs().max() / max(float(m.abs().max()), 1e-8)))
    grad_l2 = {mod: (num / max(den, 1e-30)) ** 0.5 for mod, (num, den) in sq.items()}
    param_err, bad, bitwise = 0.0, [], True
    for k, v in want["tensors"].items():
        d = (got["tensors"][k].double() - v.double()).abs()
        bitwise &= torch.equal(got["tensors"][k], v)
        param_err = max(param_err, float(d.max()) if d.numel() else 0.0)
        if k not in want["moments"] and bool((d > 1e-5 + 1e-4 * v.double().abs()).any()):
            bad.append(f"{k} {float(d.max()):.3e}")
    return dict(stats_err=stats_err, grad_l2=grad_l2, grad_gap=grad_gap, param_err=param_err,
                bitwise=bitwise, bad=bad[:5])


def _ddp_floor(*gaps) -> dict:
    """The larger gap of each kind (stats, each module's gradients)."""
    out = {"stats_err": max(g["stats_err"] for g in gaps), "grad_l2": {}}
    for g in gaps:
        for k, v in g["grad_l2"].items():
            out["grad_l2"][k] = max(out["grad_l2"].get(k, 0.0), v)
    return out


def _ddp_verdict(gap: dict, floor: dict) -> bool:
    """The bounds of DDP_* against `floor`."""
    grads_ok = all(v <= max(DDP_GRAD_TOL, 3 * floor["grad_l2"].get(k, 0.0))
                   for k, v in gap["grad_l2"].items())
    stats_ok = gap["stats_err"] <= max(DDP_STATS_TOL, 3 * floor["stats_err"])
    return stats_ok and grads_ok and not gap["bad"]


def _ddp_text(gap: dict) -> str:
    l2 = " ".join(f"{k}={v:.3e}" for k, v in gap["grad_l2"].items())
    return (f"bitwise={gap['bitwise']} stats_err={gap['stats_err']:.3e} grad_l2[{l2}] "
            f"grad_gap={gap['grad_gap']:.3e} max_abs_err={gap['param_err']:.3e}"
            + (f" OFF {gap['bad']}" if gap["bad"] else ""))


def _shifted(batch: dict) -> dict:
    """The batch with its rows cyclically shifted by one (the pose swap's roll
    and the minibatch-std group of the whole batch are unchanged by it)."""
    import torch

    return {k: torch.roll(v, 1, dims=0) for k, v in batch.items()}


def _nudged(batch: dict) -> dict:
    """The batch with every float input moved by one ulp."""
    import torch

    return {k: torch.nextafter(v, torch.full_like(v, float("inf")))
            if v.is_floating_point() else v for k, v in batch.items()}


def _timed(fn, n: int) -> list:
    """CUDA-event ms of n calls fn(i)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    for i in range(n):
        ev[i].record()
        fn(i)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]


def _ddp_gnerf(mesh, batch, seeded: bool, timed: int) -> dict:
    """The full-width G-NeRF step under `mesh` (None: the plain step) from
    the seed-0 state on `batch` (this rank's rows), the CLI's step keys of
    seed 0 when `seeded`, then `timed` timed steps: snapshot after the
    first, launches, ms, peak memory."""
    import torch

    from gnerf_tpu_torch.ops.fused_decoder import osg_decode
    from gnerf_tpu_torch.training import make_train_step
    from gnerf_tpu_torch.training.train import step_key

    torch.cuda.reset_peak_memory_stats()
    state, cfg = _full_width_trainer(0)
    step = make_train_step(cfg, mesh=mesh)

    def rng():
        return step_key(0, state.cur_nimg) if seeded else None

    osg_decode.launches = 0
    _, stats = step(state, batch, rng())
    torch.cuda.synchronize()
    out = dict(snapshot=_ddp_snapshot(state, stats), launches=osg_decode.launches)
    if timed:
        out["ms"] = _timed(lambda i: step(state, batch, rng()), timed)
    out.update(timed_launches=osg_decode.launches - out["launches"],
               peak=torch.cuda.max_memory_allocated(), state=state)
    return out


def _ddp_eg3d(mesh, batch, phase: str, timed: int = 0, seeded: bool = False) -> dict:
    """One EG3D phase ('main': Gmain + Dmain, 'dreg') at full width under
    `mesh` (None: plain) from the seed-0 state, the CLI's key of seed 0 for
    the phase when `seeded` (else rng=None), then `timed` timed calls of it."""
    import torch

    from gnerf_tpu_torch.ops.fused_decoder import osg_decode
    from gnerf_tpu_torch.training import make_eg3d_phase_steps
    from gnerf_tpu_torch.training.train import step_key
    from gnerf_tpu_torch.utils import prng

    torch.cuda.reset_peak_memory_stats()
    state, cfg = _full_width_eg3d(0)
    main_fn, _, dreg_fn = make_eg3d_phase_steps(cfg, mesh=mesh)
    fn = main_fn if phase == "main" else dreg_fn

    def rng():
        if not seeded:
            return None
        ks = prng.split(step_key(0, state.cur_nimg))[1]
        return ks if phase == "main" else prng.fold_in(ks, 2)

    osg_decode.launches = 0
    stats = fn(state, batch, rng(), 0.0, 0.0)[1]
    torch.cuda.synchronize()
    out = dict(snapshot=_ddp_snapshot(state, stats), launches=osg_decode.launches)
    if timed:
        out["ms"] = _timed(lambda i: fn(state, batch, rng(), 0.0, 0.0), timed)
    out.update(timed_launches=osg_decode.launches - out["launches"],
               peak=torch.cuda.max_memory_allocated(), state=state)
    return out


# Planted faults, each a global-batch behaviour dropped on purpose at data=2:
# (name, the run it breaks, module, attribute, what stands in for it).
def _planted_faults():
    from gnerf_tpu_torch.models import encoder, stylegan2
    from gnerf_tpu_torch.parallel import use_mesh
    from gnerf_tpu_torch.training import train_loop

    mbstd, pmean = stylegan2.minibatch_std, train_loop.pmean_grads

    def mbstd_local(*args, **kwargs):
        with use_mesh(None):
            return mbstd(*args, **kwargs)

    return (("BatchNorm moments of the local rows", "gnerf", encoder, "data_mean",
             lambda x: x),
            ("gradients not averaged over the ranks", "gnerf", train_loop, "pmean_grads",
             lambda grads, group: pmean(grads, None)),
            ("minibatch std of the local rows", "main", stylegan2, "minibatch_std",
             mbstd_local))


def _ddp_rank(rank: int, world: int, port: int, tmp: str, batch_host: dict, gan_host: dict,
              timed: int) -> None:
    """One of the gloo ranks sharing cuda:0: the G-NeRF step at data=2
    (rng=None, then seeded) and at rays=2 (seeded), EG3D Gmain + Dmain
    (rng=None, then seeded) and Dreg (rng=None) at data=2, each from the
    seed-0 state on its rows of the global batch, then timed; then each
    planted fault once; writes its results to tmp/rank{rank}.pt (rank 0's
    snapshots)."""
    from unittest import mock

    import numpy as np
    import torch
    import torch.distributed as dist

    from gnerf_tpu_torch.parallel import check_replica_consistency, local_rows, make_mesh
    from gnerf_tpu_torch.utils.device import resolve_device

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.cuda.set_device(0)
    resolve_device("cuda")  # TF32 off, as in the parent
    dist.init_process_group("gloo", rank=rank, world_size=world)

    def finish(res, mesh, n_timed):
        state = res.pop("state")
        try:
            res["consistent"] = check_replica_consistency(
                [(f"{n}.{k}", v) for n in ("g", "g_ema", "enc", "disc")
                 if getattr(state, n, None) is not None
                 for k, v in getattr(state, n).state_dict().items()], mesh.group)
        except AssertionError as e:  # raised on every rank alike
            res["consistent"] = False
            res["diverged"] = str(e)
        res["timed"] = n_timed
        if rank != 0:
            res.pop("snapshot")
        del state
        torch.cuda.empty_cache()
        return res

    meshes, local = {}, {}
    for data, rays in ((2, 1), (1, 2)):
        meshes[data, rays] = mesh = make_mesh(data=data, rays=rays)
        local[data, rays] = {k: local_rows(torch.from_numpy(np.asarray(v)).cuda(), mesh)
                             for k, v in batch_host.items()}
    dp = meshes[2, 1]
    gan = {k: local_rows(v.cuda(), dp) for k, v in gan_host.items()}

    def gnerf(key, seeded, n_timed):
        return finish(_ddp_gnerf(meshes[key], local[key], seeded, n_timed), meshes[key], n_timed)

    def eg3d(phase, n_timed, seeded=False):
        return finish(_ddp_eg3d(dp, gan, phase, n_timed, seeded), dp, n_timed)

    out = {"dp": gnerf((2, 1), False, timed), "dp_seed": gnerf((2, 1), True, 0),
           "sp": gnerf((1, 2), True, timed), "main": eg3d("main", timed),
           "main_seed": eg3d("main", 0, True), "dreg": eg3d("dreg", timed), "faults": []}
    for _, run, module, attr, stand_in in _planted_faults():
        with mock.patch.object(module, attr, stand_in):
            out["faults"].append(gnerf((2, 1), False, 0) if run == "gnerf" else eg3d(run, 0))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()
    # Skip the interpreter's teardown: gloo's threads abort it (std::terminate)
    # while the other rank still holds connections to this one.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def phase_ddp(timed: int = DDP_TIMED_STEPS):
    """The distributed training path (gnerf_tpu_torch.parallel) at full
    width on the one card; see the module docstring. Returns the osg_decode
    launches of its distributed runs, all ranks summed."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from gnerf_tpu_torch.parallel import make_mesh
    from gnerf_tpu_torch.training import SyntheticDataset, data_iterator

    batch_host = next(data_iterator(SyntheticDataset(resolution=SIDE, depth_resolution=64),
                                    batch_size=TRAIN_BATCH, seed=0))
    batch_host = {k: np.asarray(v) for k, v in batch_host.items()}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_host.items()}

    def plain(run, *args):
        res = run(None, *args)
        del res["state"]
        torch.cuda.empty_cache()
        return res

    def ms(xs):
        return ", ".join(f"{x:.3f}" for x in xs)

    ref_seed = plain(_ddp_gnerf, batch, True, timed)
    floor_seed = _ddp_gaps(plain(_ddp_gnerf, batch, True, 0)["snapshot"], ref_seed["snapshot"])
    ref = plain(_ddp_gnerf, batch, False, 0)
    floor = _ddp_floor(*(_ddp_gaps(plain(_ddp_gnerf, b, False, 0)["snapshot"], ref["snapshot"])
                         for b in (_shifted(batch), _nudged(batch))))
    nudged_seed = _ddp_gaps(plain(_ddp_gnerf, _nudged(batch), True, 0)["snapshot"],
                            ref_seed["snapshot"])
    log(f"[ddp] world 1 (the plain G-NeRF step, full width fp32, batch {TRAIN_BATCH}, from the "
        f"seed-0 state): seeded, run twice: {_ddp_text(floor_seed)}; rng=None, the larger gap "
        f"of rows shifted and inputs nudged: stats_err={floor['stats_err']:.3e} grad_l2["
        + " ".join(f"{k}={v:.3e}" for k, v in floor["grad_l2"].items()) +
        f"]; seeded, inputs nudged: {_ddp_text(nudged_seed)}; plain step_ms "
        f"{ms(ref_seed['ms'])}")

    # (a) the distributed path in a world-1 NCCL group, in this process.
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        res_a = _ddp_gnerf(make_mesh(data=1, rays=1), batch, True, timed)
        del res_a["state"]
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    gap_a = _ddp_gaps(res_a["snapshot"], ref_seed["snapshot"])
    launches_a = res_a["launches"] + res_a["timed_launches"]
    good = _ddp_verdict(gap_a, floor_seed) and launches_a == 2 * (1 + timed)
    ok = good
    log(f"[ddp] (a) G-NeRF step through the distributed path in a world-1 NCCL group vs the "
        f"plain step, seeded: {_ddp_text(gap_a)}; step_ms {ms(res_a['ms'])} (plain in this call: "
        f"{ms(ref_seed['ms'])}); max_memory_allocated={res_a['peak']} bytes; osg_decode "
        f"launches {launches_a} (want {2 * (1 + timed)})" + ("" if good else " FAILED"))

    gan = _eg3d_batches(1)[0]
    eg_ref, eg_floor = {}, {}
    for phase in ("main", "dreg"):
        eg_ref[phase] = plain(_ddp_eg3d, gan, phase)
        eg_floor[phase] = _ddp_floor(*(
            _ddp_gaps(plain(_ddp_eg3d, b, phase)["snapshot"], eg_ref[phase]["snapshot"])
            for b in (_shifted(gan), _nudged(gan))))
        if phase == "main":
            eg_ref["main_seed"] = plain(_ddp_eg3d, gan, "main", 0, True)
            twice, nudged = (_ddp_gaps(plain(_ddp_eg3d, b, "main", 0, True)["snapshot"],
                                       eg_ref["main_seed"]["snapshot"])
                             for b in (gan, _nudged(gan)))
            eg_floor["main_seed"] = _ddp_floor(eg_floor["main"], twice, nudged)
            log(f"[ddp] world 1 EG3D main seeded: run twice: {_ddp_text(twice)}; inputs "
                f"nudged: {_ddp_text(nudged)}")
        log(f"[ddp] world 1 EG3D {phase} (plain, rng=None, from the seed-0 state), the larger "
            f"gap of rows shifted and inputs nudged: stats_err="
            f"{eg_floor[phase]['stats_err']:.3e} grad_l2["
            + " ".join(f"{k}={v:.3e}" for k, v in eg_floor[phase]["grad_l2"].items()) + "]")
    gan_host = {k: v.cpu() for k, v in gan.items()}
    del gan, batch
    torch.cuda.empty_cache()

    # (b) and (c): two gloo ranks sharing the one card (NCCL refuses two ranks
    # on one device), 2 rows each at data=2, or all 4 rows each at rays=2.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_ddp_rank, args=(2, _free_port(), tmp, batch_host, gan_host, timed),
                 nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    total = launches_a
    floor_dp_seed = _ddp_floor(floor, floor_seed, nudged_seed)
    parts = (("dp", "(b) G-NeRF step, data=2, rng=None", ref, floor, 2),
             ("dp_seed", "(b) G-NeRF step, data=2, seeded (rng=None and seeded floors)",
              ref_seed,
              floor_dp_seed, 2),
             ("sp", "(c) G-NeRF step, rays=2, seeded", ref_seed, floor_seed, 2),
             ("main", "(b) EG3D Gmain + Dmain, data=2, rng=None", eg_ref["main"],
              eg_floor["main"], 4),
             ("main_seed", "(b) EG3D Gmain + Dmain, data=2, seeded (rng=None and seeded floors)",
              eg_ref["main_seed"], eg_floor["main_seed"], 4),
             ("dreg", "(b) EG3D Dreg, data=2, rng=None", eg_ref["dreg"], eg_floor["dreg"], 0))
    for part, title, want, fl, per_call in parts:
        gap = _ddp_gaps(ranks[0][part]["snapshot"], want["snapshot"])
        launches = [(r[part]["launches"], r[part]["timed_launches"]) for r in ranks]
        want_launches = [(per_call, per_call * r[part]["timed"]) for r in ranks]
        total += sum(sum(x) for x in launches)
        good = (_ddp_verdict(gap, fl) and launches == want_launches
                and all(r[part]["consistent"] for r in ranks))
        ok &= good
        times = ("; ms per call and rank (two processes sharing one card) " + "; ".join(
            f"rank {i}: {ms(r[part]['ms'])}" for i, r in enumerate(ranks))
                 if "ms" in ranks[0][part] else "")
        log(f"[ddp] {title}, two gloo ranks sharing one card vs world 1: {_ddp_text(gap)}; "
            f"replicas equal={all(r[part]['consistent'] for r in ranks)}{times}; "
            f"max_memory_allocated per rank {[r[part]['peak'] for r in ranks]} bytes; "
            f"osg_decode launches per rank (first, timed) {launches} (want {want_launches})"
            + ("" if good else " FAILED"))
    # The controls: the same bounds must refuse each planted fault.
    refs = {"gnerf": (ref, floor), "main": (eg_ref["main"], eg_floor["main"])}
    for i, (name, run, *_) in enumerate(_planted_faults()):
        want, fl = refs[run]
        res = [r["faults"][i] for r in ranks]
        gap = _ddp_gaps(res[0]["snapshot"], want["snapshot"])
        within, equal = _ddp_verdict(gap, fl), all(r["consistent"] for r in res)
        caught = not (within and equal)
        ok &= caught
        log(f"[ddp] planted fault ({name}; "
            f"{'G-NeRF step' if run == 'gnerf' else 'EG3D Gmain + Dmain'}, data=2, rng=None) "
            f"vs world 1: {_ddp_text(gap)}; within the bounds={within}; replicas equal={equal}"
            + (f" ({res[0]['diverged']})" if not equal else "")
            + ("; caught" if caught else "; NOT CAUGHT: the bounds are too loose"))
    log(f"[ddp] bounds: stats max({DDP_STATS_TOL} of their size, 3x the floor); each module's "
        f"gradients max({DDP_GRAD_TOL} in L2, 3x the floor); untrained tensors 1e-5 + 1e-4 of "
        "their size; launches of the planted faults are not counted. The two ranks share one "
        "card over gloo because NCCL refuses two ranks on one device: their times are of two "
        "processes sharing one card (correctness, not speed), not a multi-card number; spawn "
        f"to join {spawn_s:.1f} s")
    if not ok:
        raise SystemExit("chip_smoke: the distributed path does not hold to world 1")
    return total


INFER_DDP_RUNS = (("data=2", 1, True), ("rays=2", 2, False))  # name, ray_shards, gen_shapes


def _infer_rank(rank: int, world: int, port: int, tmp: str, frames: int) -> None:
    """One of the gloo ranks sharing cuda:0: `generate_videos` over the
    (data=2) mesh with the 256^3 sweep split over both ranks, then over the
    (rays=2) mesh; writes each run's wall ms, launches and peak memory (and
    rank 0's frames and volume) to tmp/rank{rank}.pt."""
    import torch
    import torch.distributed as dist

    from gnerf_tpu_torch.infer import shape_utils
    from gnerf_tpu_torch.infer.gen_videos import generate_videos
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode
    from gnerf_tpu_torch.utils.device import resolve_device

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.cuda.set_device(0)
    resolve_device("cuda")  # TF32 off, as in the parent
    dist.init_process_group("gloo", rank=rank, world_size=world)
    out = {}
    for name, rays, shapes in INFER_DDP_RUNS:
        run_dir = os.path.join(tmp, f"{name}-rank{rank}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        osg_decode.launches = 0
        t0 = time.perf_counter()
        res = generate_videos(None, seed_init=0, frames=frames, res=64, ray_shards=rays,
                              gen_shapes=shapes, shape_res=SHAPE_RES, video_out_path=run_dir,
                              outdir=run_dir, device="cuda")
        torch.cuda.synchronize()
        row = {"ms": (time.perf_counter() - t0) * 1e3, "launches": osg_decode.launches,
               "peak": torch.cuda.max_memory_allocated()}
        if res is not None:
            row.update(frames=res["frames"], finite=res["finite"])
            if shapes:
                row["volume"] = shape_utils.read_mrc(res["mrc"])
        out[name] = row
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()
    # Skip the interpreter's teardown: gloo's threads abort it (std::terminate)
    # while the other rank still holds connections to this one.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _frame_gap(got, want) -> tuple[int, float]:
    """(max |got - want| in uint8 levels, share of differing values)."""
    import numpy as np

    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float((diff > 0).mean())


def phase_infer_ddp(frames: int, main_frames, volume):
    """Multi-device inference at full width on the one card (see the module
    docstring): (a) `generate_videos` in a world-1 NCCL group, equal to
    phase main's frames; (b) two gloo ranks sharing the card at data=2 (with
    the 256^3 sweep over both) and at rays=2, rank 0's frames within +-1 of
    phase main's and the volume within rtol 1e-4 / atol 1e-5 of phase
    shapes'; (c) `GNerfService` with two replicas on the card, its orbit
    within +-1 of one device's at the same batch sizes (its 30-frame orbit's
    gap to one device's chunks of 15 printed). osg_decode launches are
    checked exactly on every rank. Returns them, all ranks summed."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from gnerf_tpu_torch.infer import gen_videos as gv
    from gnerf_tpu_torch.infer.server import GNerfService
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode

    ok = True
    # (a) the mesh path in a world-1 NCCL group, in this process.
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            osg_decode.launches = 0
            t0 = time.perf_counter()
            res = gv.generate_videos(None, seed_init=0, frames=frames, res=64,
                                     video_out_path=tmp, device="cuda")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches_a = osg_decode.launches
    finally:
        dist.destroy_process_group()
    equal = bool(np.array_equal(res["frames"], main_frames))
    good = equal and res["finite"] and launches_a == 2 * frames
    ok &= good
    log(f"[infer_ddp] (a) generate_videos in a world-1 NCCL group (mesh 1x1): {frames} frames "
        f"equal to phase main's={equal}; wall_ms={wall:.3f} (set-up included); osg_decode "
        f"launches={launches_a} (want {2 * frames})" + ("" if good else " FAILED"))

    # (b) two gloo ranks sharing the one card (NCCL refuses two ranks on one device).
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_infer_rank, args=(2, _free_port(), tmp, frames), nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    total = launches_a
    chunks = -(-SHAPE_RES ** 3 // SHAPE_CHUNK)
    per_rank = math.ceil(min(8, frames) / 2)
    want_launches = {"data=2": 2 * per_rank * math.ceil(frames / (2 * per_rank)) + chunks,
                     "rays=2": 2 * frames}
    for name, _, shapes in INFER_DDP_RUNS:
        row0 = ranks[0][name]
        gap, share = _frame_gap(row0["frames"], main_frames)
        launches = [r[name]["launches"] for r in ranks]
        total += sum(launches)
        good = (row0["frames"].shape == main_frames.shape and gap <= 1 and row0["finite"]
                and launches == [want_launches[name]] * 2)
        msg = (f"[infer_ddp] (b) generate_videos, {name}, two gloo ranks sharing one card: "
               f"rank 0's {row0['frames'].shape[0]} frames vs phase main's: max_abs_gap={gap} "
               f"(bound 1), differing share={share:.3e}")
        if shapes:
            vol = row0["volume"]
            err = float(np.abs(vol - volume).max())
            close = vol.shape == volume.shape and np.allclose(vol, volume, rtol=1e-4, atol=1e-5)
            good &= close
            msg += (f"; the {SHAPE_RES}^3 sweep over both ranks vs phase shapes' volume: "
                    f"max_abs_err={err:.3e} (rtol 1e-4, atol 1e-5)")
        ok &= good
        log(msg + f"; wall_ms per rank (the call, set-up included; two processes sharing one "
            f"card) {[round(r[name]['ms'], 3) for r in ranks]}; max_memory_allocated per rank "
            f"{[r[name]['peak'] for r in ranks]} bytes; osg_decode launches per rank {launches} "
            f"(want {want_launches[name]})" + ("" if good else " FAILED"))
    log(f"[infer_ddp] (b) spawn to join {spawn_s:.1f} s")

    # (c) the server with two replicas of G on the one card.
    g, enc = gv.load_networks(None, seed_init=0, device="cuda")
    orbits, times, parts, one_28 = {}, {}, {}, None
    for n in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        service = GNerfService(g, enc, microbatch=0, devices=["cuda:0"] * n)
        try:
            ident = service.encode_seed(0)
            service.render_orbit(ident, frames=30)  # warm-up at the same chunk shapes
            torch.cuda.synchronize()
            osg_decode.launches = 0
            t0 = time.perf_counter()
            orbits[n] = np.stack(service.render_orbit(ident, frames=30))
            times[n] = ((time.perf_counter() - t0) * 1e3, osg_decode.launches,
                        torch.cuda.max_memory_allocated(), service.frames_per_chunk)
            # The same frames at the same batch sizes on both sides: the
            # replicas' parts of chunks of 4 (2 frames each) and one device's
            # chunks of 2; 28 frames, so no chunk of 2 is split 1 + 1. bf16
            # convolutions round otherwise at batch 2 than at 15 (cuDNN picks
            # its algorithms by shape), which the 30-frame gap also carries.
            if n == 1:
                one_28 = np.stack(service.render_orbit(ident, frames=28))
                service.frames_per_chunk = 2
            parts[n] = np.stack(service.render_orbit(ident, frames=28))
        finally:
            service.close()
    fpc = times[2][3]
    want_c = 2 * sum(min(2, len(range(s, min(s + fpc, 30)))) for s in range(0, 30, fpc))
    gap, share = _frame_gap(orbits[2], orbits[1])
    part_gap, part_share = _frame_gap(parts[2], parts[1])
    batch_gap, batch_share = _frame_gap(parts[1], one_28)
    total += times[2][1]
    good = fpc == 4 and part_gap <= 1 and orbits[2].shape == (30, SIDE, SIDE, 3) and \
        times[2][1] == want_c
    ok &= good
    log(f"[infer_ddp] (c) GNerfService(devices=[cuda:0, cuda:0]): frames_per_chunk={fpc} "
        f"(want 4); 28-frame render_orbit vs one device's at the same batches of 2: "
        f"max_abs_gap={part_gap} (bound 1), differing share={part_share:.3e}; the 30-frame orbit "
        f"vs one device's chunks of {times[1][3]}: max_abs_gap={gap}, share={share:.3e} (one "
        f"device alone, batches of 2 vs {times[1][3]}: max_abs_gap={batch_gap}, share="
        f"{batch_share:.3e}); ms {times[2][0]:.3f} (one device: {times[1][0]:.3f}); "
        f"max_memory_allocated {times[2][2]} bytes (one device: {times[1][2]}); osg_decode "
        f"launches={times[2][1]} (want {want_c}: 2 per replica's part)"
        + ("" if good else " FAILED"))
    if not ok:
        raise SystemExit("chip_smoke: multi-device inference does not hold to one device")
    return total


SG3_CFG = dict(z_dim=512, c_dim=0, w_dim=512, img_resolution=1024, img_channels=3,
               mapping_layers=2, channel_base=32768, channel_max=512, num_layers=14)
SG3_CPU_BOUND = 1e-3  # max |card - CPU| of the fp32 output (about +-1 at output_scale 0.25)


def phase_sg3(batch: int = 4):
    """StyleGAN3-T at the published FFHQ-U 1024^2 configuration (seed-init
    weights): forward at `batch` in fp32 and bf16 (shape, finite, ms per
    image, peak memory); a fp32 backward of out.square().mean() at batch 1
    (every parameter's gradient finite and nonzero); the magnitude EMAs
    moved by `updated_magnitude_ema` in a forward; the card's fp32 output at
    batch 1 against the same weights on the CPU; a profile of one forward,
    with filtered_lrelu's share of device time."""
    import copy
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gnerf_tpu_torch.models import stylegan3
    from gnerf_tpu_torch.utils import prng

    g = stylegan3.Generator(**SG3_CFG, device="cuda", key=prng.PRNGKey(0)).requires_grad_(False)
    z = torch.randn((batch, SG3_CFG["z_dim"]), generator=torch.Generator().manual_seed(1))
    z = z.cuda()
    n_params = sum(p.numel() for p in g.parameters())
    ok = True
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            out = g(z, None, dtype=dtype)
            ms = cuda_ms(lambda: g(z, None, dtype=dtype), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        side = SG3_CFG["img_resolution"]
        good = tuple(out.shape) == (batch, 3, side, side) and bool(torch.isfinite(out).all())
        ok &= good
        outs[dtype] = out
        log(f"[sg3] StyleGAN3-T {side}^2 ({n_params} parameters) forward, batch {batch}, {dtype}: "
            f"{tuple(out.shape)} finite={good} std={out.std().item():.4f}; ms={ms:.3f} "
            f"({ms / batch:.3f} ms per image); max_memory_allocated={peak} bytes")
    gap = (outs[torch.bfloat16] - outs[torch.float32]).abs().max().item()
    log(f"[sg3] max |bf16 - fp32| of the output: {gap:.3e}")
    del outs, out

    # The fp32 backward at batch 1: every parameter's gradient.
    g.requires_grad_(True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def step():
        g.zero_grad(set_to_none=True)
        g(z[:1], None).square().mean().backward()

    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    missing, bad, zero = [], [], []
    for name, p in g.named_parameters():
        if p.grad is None:
            missing.append(name)
        elif not bool(torch.isfinite(p.grad).all()):
            bad.append(name)
        elif not bool((p.grad != 0).any()):
            zero.append(name)
    ms = cuda_ms(step, iters=2, warmup=0)
    good = not (missing or bad or zero)
    ok &= good
    log(f"[sg3] fp32 forward + backward of out.square().mean(), batch 1: ms={ms:.3f}; "
        f"max_memory_allocated={peak} bytes; gradients of {len(list(g.parameters()))} "
        f"parameters: none missing={not missing} all finite={not bad} all nonzero={not zero}"
        + ("" if good else f" FAILED (missing {missing[:4]}, non-finite {bad[:4]}, "
                          f"zero {zero[:4]})"))
    g.requires_grad_(False)
    g.zero_grad(set_to_none=True)

    # The magnitude EMAs, updated from each layer's input as the reference
    # does before the layer reads its input gain.
    layers = [getattr(g.synthesis, n) for n in g.synthesis.layer_names]

    def update_ema(layer, args):
        layer.magnitude_ema.copy_(layer.updated_magnitude_ema(args[0]))

    hooks = [layer.register_forward_pre_hook(update_ema) for layer in layers]
    try:
        with torch.no_grad():
            moved = g(z, None)
    finally:
        for h in hooks:
            h.remove()
    emas = [float(layer.magnitude_ema) for layer in layers]
    good = all(math.isfinite(e) and e != 1.0 for e in emas) and bool(torch.isfinite(moved).all())
    ok &= good
    log(f"[sg3] updated_magnitude_ema in one forward: every layer's EMA moved from 1 "
        f"={good} (range {min(emas):.6f} .. {max(emas):.6f})")

    # The card against the CPU, fp32, batch 1, the same weights.
    g_cpu = copy.deepcopy(g).cpu()
    with torch.no_grad():
        want_card = g(z[:1], None).cpu()
        t0 = time.perf_counter()
        want_cpu = g_cpu(z[:1].cpu(), None)
        cpu_s = time.perf_counter() - t0
    err = (want_card - want_cpu).abs().max().item()
    good = err <= SG3_CPU_BOUND
    ok &= good
    del g_cpu
    log(f"[sg3] fp32 batch 1, card vs CPU at {side}^2: max_abs_err={err:.3e} (bound "
        f"{SG3_CPU_BOUND:g}, output std {want_cpu.std().item():.4f}); the CPU forward took "
        f"{cpu_s:.1f} s" + ("" if good else " FAILED"))

    # filtered_lrelu's share of one forward's device time.
    real = stylegan3.filtered_lrelu

    def traced(*args, **kwargs):
        with record_function("filtered_lrelu"):
            return real(*args, **kwargs)

    with mock.patch.object(stylegan3, "filtered_lrelu", traced), torch.no_grad():
        g(z, None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("sg3_forward"):
                g(z, None)
            torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    by_key = {e.key: device_us(e) for e in events}
    total, flr = by_key.get("sg3_forward", 0), by_key.get("filtered_lrelu", 0)
    kernels = sorted(((getattr(e, "self_device_time_total", 0) or
                       getattr(e, "self_cuda_time_total", 0), e.key) for e in events
                      if e.key not in ("sg3_forward", "filtered_lrelu")), reverse=True)[:8]
    log(f"[sg3] profile of one fp32 forward, batch {batch}: device time "
        + (f"{total / 1e3:.3f} ms, filtered_lrelu {flr / 1e3:.3f} ms = {flr / total:.3f} of it"
           if total else "not measured (no device time in the trace)")
        + "; top ops by self device ms: "
        + ", ".join(f"{k[:60]} {us / 1e3:.3f}" for us, k in kernels))
    if not ok:
        raise SystemExit("chip_smoke: the StyleGAN3 phase failed")


def main(argv=None) -> int:
    start = time.perf_counter()
    ap = argparse.ArgumentParser(description="Smoke run of gnerf_tpu_torch on one CUDA card")
    ap.add_argument("--frames", type=int, default=FRAMES_DEFAULT)
    ap.add_argument("--profile", metavar="FILE", default=None,
                    help="write a torch.profiler table of one frame to FILE")
    args = ap.parse_args(argv)

    phase_device()
    import torch

    from gnerf_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # TF32 off for fp32 products
    phase_build()
    kern = phase_kernels()
    fry = phase_threefry()
    phase_small()
    phase_prng()
    from gnerf_tpu_torch.ops.threefry import threefry_draw

    launches, fry_launches = {}, {}

    def path(name, fn, *a):
        """Runs a path with the threefry count set to 0 just before it; keeps
        what it launched."""
        threefry_draw.launches = 0
        out = fn(*a)
        fry_launches[name] = threefry_draw.launches
        return out

    launches["main"], main_frames = path("main", phase_main, args.frames)
    phase_timing(args.frames, args.profile)
    launches["ingest"] = path("ingest", phase_ingest)
    launches["server"] = path("server", phase_server)
    launches["shapes"], volume = path("shapes", phase_shapes)
    launches["train"] = path("train", phase_train)
    launches["eg3d"] = path("eg3d", phase_eg3d)
    launches["eg3d_ada"] = path("eg3d_ada", phase_eg3d_ada)
    launches["pti"] = path("pti", phase_pti)
    launches["eval"] = path("eval", phase_eval)
    launches["ddp"] = path("ddp", phase_ddp)
    launches["infer_ddp"] = phase_infer_ddp(args.frames, main_frames, volume)
    phase_sg3()
    log(f"[threefry] launches by path (this process): {fry_launches}")
    idle = [p for p in ("main", "train", "eg3d", "eg3d_ada") if not fry_launches[p]]
    if idle:
        raise SystemExit(f"chip_smoke: the threefry kernel never launched on {idle}")

    log(f"[wall] chip_smoke.py: {time.perf_counter() - start:.1f} s from start to the results "
        "(host clock, the kernels' build included)")
    log(card_line())  # again beside the results: the run's output is long
    main_row = kern["main_bf16"]
    timed = ("main_f32", "server_mb4_bf16", "orbit_chunk_bf16", "shape_chunk_f32", "train_f32",
             "train_bf16", "greg_f32", "ray_shard_bf16", "sweep_shard_f32")
    print(json.dumps({"kernels": [{
        "name": "osg_decode", "route": "cuda",
        "source": "gnerf_tpu_torch/csrc/osg_decode.cu",
        "replaces": "gnerf_tpu/ops/fused_decoder.py:45",
        "launches": launches["main"], "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
        "launches_by_path": launches,
        "shapes": {k: kern[k] for k in timed},
    }, {
        "name": "threefry", "route": "cuda",
        "source": "gnerf_tpu_torch/csrc/threefry.cu",
        "replaces": "none: JAX leaves threefry to XLA (gnerf_tpu's jax.random draws)",
        "launches": fry_launches["main"], "max_abs_err": fry["jitter"]["max_abs_err"],
        "ms": fry["jitter"]["device_ms"], "call_ms": fry["jitter"]["call_ms"],
        "plain_ms": fry["jitter"]["plain_ms"],
        "bound_ms": fry["jitter"]["bound_ms"], "bound_by": fry["jitter"]["bound_by"],
        "library_ms": None,
        "launches_by_path": fry_launches,
        "shapes": fry,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
