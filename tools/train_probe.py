#!/usr/bin/env python3
"""The full-width train steps of `gnerf_tpu_torch`, measured on one CUDA card.

    python3 tools/train_probe.py [--objective gnerf|eg3d|ada|ddp] [--steps 5] [--profile FILE]

Builds the networks of the `ffhq` preset as `chip_smoke.py`'s train (or
eg3d) phase does (seed-init weights, batch 4, SyntheticDataset batches) and
prints, after the card's name and power limit:

  - gnerf (fp32): for each rematerialisation setting (synthesis, fakes' VGG
    pass: off/off, on/off, off/on, on/on) the median step ms over `--steps`
    steps after two warm-up steps, the spread, images/s and the peak memory
    allocated; the step split by CUDA events (no remat): the forward of E
    (train mode), G's mapping, the backbone's planes, the 48+48 render, the
    8XDC SR, the reconstruction losses with LPIPS and D on the fake depth;
    the backward of the G loss; the D loss with R1, forward and backward;
    both Adam steps and the G_ema update;
  - eg3d (the 512^2 dual D, lazy regularization): for fp32 and bf16
    (`--dtype bf16`: G's synthesis and both D stacks), each with the
    synthesis remat off and on, the median ms of Gmain + Dmain over
    `--steps` steps after two warm-up steps, of a Greg and of a Dreg, and
    the peak memory allocated; then for each dtype (no remat) the phases
    split by CUDA events: G forward, D on the fakes, G backward with Adam
    and w_avg, D main (fakes regenerated without a graph, reals, backward,
    Adam), G_ema, Greg, Dreg;
  - ada (the eg3d run's augment pipe, bgc at p = 0.2, on [4, 6, 512, 512]
    fp32 pairs): the median ms of its geometric parts alone (reflect pad,
    FIR upsample, warp, FIR downsample), of the whole pipe's forward and of
    its forward with the input backward;
  - ddp (fp32): the G-NeRF step through the distributed path in a world-1
    NCCL group and the plain step, on one state and batch, in turns (plain,
    distributed, distributed, plain, ...): the median ms of each over
    `--steps` pairs after two warm-up steps each, by CUDA events and by the
    host's clock; then one profiled step of each and the ops whose device or
    host time differs most between them;
  - with `--profile FILE`, a torch.profiler table of one step (no remat,
    fp32; for eg3d one Gmain + Dmain, Greg and Dreg; for ada one ADA Gmain
    + Dmain and Dreg), sorted by device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _split(state, cfg, batch, rng):
    """One step, its parts bracketed by CUDA events; returns {part: ms}."""
    import torch
    import torch.nn.functional as F

    from gnerf_tpu_torch.ops.interpolate import interpolate_bilinear
    from gnerf_tpu_torch.training import losses as L
    from gnerf_tpu_torch.utils.misc import ema_update, nan_to_num

    g, enc, disc, vgg = state.g, state.enc, state.disc, state.vgg
    res = cfg.neural_rendering_resolution
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    z = enc.apply(batch["condition_image"].float() / 127.5 - 1.0, train=True)
    mark("E forward")
    c = batch["loss_c"].float()
    ws = g.mapping(z, c)
    mark("mapping")
    planes = g.backbone_planes(ws, noise_mode="random", rng=rng)
    mark("backbone planes")
    raw = g.render_planes(planes, c, ws, neural_rendering_resolution=res, noise_mode="random",
                          rng=rng, superres=False)
    mark("render 48+48")
    fi = raw["feature_image"]
    image, image_raw = g.superresolution(fi[:, :3], fi, ws, noise_mode="none")
    mark("SR 8XDC")
    loss_image = batch["loss_image"].float()
    real = loss_image / 127.5 - 1.0
    real_raw = interpolate_bilinear(loss_image, res, res, antialias=True) / 127.5 - 1.0
    total = 0.0
    for r, f in ((real_raw, image_raw), (real, image)):
        total = total + (r - f).abs().mean() + (1 - L.ssim(r * 0.5 + 0.5, f * 0.5 + 0.5))

    def to256(x):
        return interpolate_bilinear(x, vgg.resize_to, vgg.resize_to, antialias=True)

    total = total + L.lpips_training_distance(  # targets and fakes as two batches of 2N
        vgg, torch.cat([to256(real_raw), to256(real)]),
        torch.cat([to256(image_raw), to256(image)])).mean()
    mark("L1 + SSIM + LPIPS")
    depth = raw["image_depth"]
    total = total + 1.2 * L.g_nonsaturating_loss(disc.apply(depth, c))
    mark("D on fake depth")
    params = [p for grp in state.opt_g.param_groups for p in grp["params"]]
    grads = torch.autograd.grad(total, params)
    mark("G loss backward")
    d_params = list(disc.parameters())
    depth_real = interpolate_bilinear(batch["c_depth_image"].float(), res, res, antialias=True)
    cond = batch["condition_c"].float()
    loss_d = (F.softplus(disc.apply(depth.detach(), c)).mean()
              + F.softplus(-disc.apply(depth_real, cond)).mean()
              + (L.r1_penalty(lambda x: disc.apply(x, cond), depth_real) * 0.5).mean())
    d_grads = torch.autograd.grad(loss_d, d_params)
    mark("D loss + R1, fwd + bwd")
    for opt, ps, gs in ((state.opt_g, params, grads), (state.opt_d, d_params, d_grads)):
        for p, gr in zip(ps, gs):
            p.grad = gr
        nan_to_num(gs)
        opt.step()
        opt.zero_grad(set_to_none=True)
    ema_update(state.g_ema.state_dict(), g.state_dict(), 0.99)
    mark("Adam x2 + G_ema")
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev) for i, (name, ev) in enumerate(marks) if i}


def _eg3d_split(state, cfg, phases, batch, seed, cur):
    """One scheduled EG3D step with Greg and Dreg, its parts bracketed by
    CUDA events, composed from `eg3d_loss`'s own pieces as its main step
    composes them; returns {part: ms}."""
    import torch
    import torch.nn.functional as F

    from gnerf_tpu_torch.training import eg3d_loss as E
    from gnerf_tpu_torch.training.train import step_generator

    run_g, run_d = E._make_runners(cfg)
    res = cfg.neural_rendering_resolution
    rng = step_generator(seed, cur, "cuda")
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    gen_img, ws = run_g(state.g, batch["z"], batch["c"], rng, state.cur_nimg, res)
    mark("G forward")
    loss_g = F.softplus(-run_d(state.disc, gen_img, batch["c"])).mean()
    mark("D on the fakes")
    E._adam_step(state.opt_g, loss_g)
    E._update_w_avg(state.g, ws[:, 0].detach())
    del gen_img, ws, loss_g
    mark("G backward + Adam + w_avg")
    loss_d, _, _ = E._d_main(run_g, run_d, state, batch, rng, 0.0, 0, res)
    E._adam_step(state.opt_d, loss_d)
    del loss_d
    mark("D main + Adam")
    E._finish_main(state, int(batch["z"].shape[0]))
    mark("G_ema")
    phases[1](state, batch, step_generator(seed, cur, "cuda", 1))
    mark("Greg")
    phases[2](state, batch, step_generator(seed, cur, "cuda", 2))
    mark("Dreg")
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev) for i, (name, ev) in enumerate(marks) if i}


def _probe_eg3d(args) -> int:
    import dataclasses

    import torch

    import chip_smoke
    from gnerf_tpu_torch.training import make_eg3d_phase_steps
    from gnerf_tpu_torch.training.train import step_generator

    n = args.steps + 2
    batches = chip_smoke._eg3d_batches(n)
    state, cfg = chip_smoke._full_width_eg3d(0)

    def timed(fn):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        return ev

    for dtype in (torch.float32, torch.bfloat16):
        for remat in (False, True):
            c = dataclasses.replace(cfg, dtype=dtype, remat_synthesis=remat)
            main, greg, dreg = make_eg3d_phase_steps(c)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            evs = {"main": [], "greg": [], "dreg": []}
            for i, b in enumerate(batches):
                cur = state.cur_nimg
                evs["main"].append(timed(lambda: main(state, b, step_generator(0, cur, "cuda"))))
                if i in (0, n - 1):  # one regularizer call of each kind warms up
                    evs["greg"].append(timed(
                        lambda: greg(state, b, step_generator(0, cur, "cuda", 1))))
                    evs["dreg"].append(timed(
                        lambda: dreg(state, b, step_generator(0, cur, "cuda", 2))))
            torch.cuda.synchronize()
            ms = [a.elapsed_time(e) for a, e in evs["main"][2:]]
            greg_ms, dreg_ms = (evs[k][-1][0].elapsed_time(evs[k][-1][1])
                                for k in ("greg", "dreg"))
            med = statistics.median(ms)
            print(f"[eg3d {str(dtype).split('.')[-1]} remat_synthesis={remat}] Gmain+Dmain "
                  f"median_ms={med:.3f} min={min(ms):.3f} max={max(ms):.3f} images_per_s="
                  f"{chip_smoke.TRAIN_BATCH * 1e3 / med:.3f}; Greg_ms={greg_ms:.3f} "
                  f"Dreg_ms={dreg_ms:.3f}; lazy step (main + Greg/4 + Dreg/16) ms="
                  f"{med + greg_ms / 4 + dreg_ms / 16:.3f}; max_memory_allocated="
                  f"{torch.cuda.max_memory_allocated()} bytes", flush=True)

    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, dtype=dtype)
        phases = make_eg3d_phase_steps(c)
        parts = [_eg3d_split(state, c, phases, b, 0, state.cur_nimg) for b in batches]
        parts = parts[2:]
        whole = sum(statistics.median(p[k] for p in parts) for k in parts[0])
        print(f"[eg3d split {str(dtype).split('.')[-1]}] medians over {len(parts)} steps with "
              f"Greg and Dreg (no remat), sum {whole:.3f} ms:", flush=True)
        for k in parts[0]:
            v = statistics.median(p[k] for p in parts)
            print(f"[eg3d split]   {k:26s} {v:9.3f} ms  {100 * v / whole:5.1f}%", flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        main, greg, dreg = make_eg3d_phase_steps(cfg)
        b, cur = batches[0], state.cur_nimg
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            main(state, b, step_generator(0, cur, "cuda"))
            greg(state, b, step_generator(0, cur, "cuda", 1))
            dreg(state, b, step_generator(0, cur, "cuda", 2))
            torch.cuda.synchronize()
        _write_profile(prof, args.profile, "one Gmain + Dmain, Greg and Dreg (fp32)")
    return 0


def _probe_ada(args) -> int:
    """The ADA pipe at the EG3D step's D input ([4, 6, 512, 512] fp32 pairs,
    bgc at p = 0.2): its geometric parts alone (reflect pad, FIR upsample,
    warp, FIR downsample) and the whole pipe forward, and forward + input
    backward, by CUDA events (medians of `--steps` after 2 warm-ups);
    `--profile` also writes the op table of one ADA Gmain + Dmain and Dreg."""
    import numpy as np
    import torch

    import chip_smoke
    from gnerf_tpu_torch.ops.upfirdn2d import downsample2d, setup_filter, upsample2d
    from gnerf_tpu_torch.training import augment as A
    from gnerf_tpu_torch.training import make_augment_pipe, make_eg3d_phase_steps
    from gnerf_tpu_torch.training.train import step_generator

    state, cfg = chip_smoke._full_width_eg3d(0, aug="ada", aug_p=0.2)
    pipe = make_augment_pipe(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((4, 6, 512, 512), device="cuda", generator=gen) * 2 - 1
    hz = setup_filter(A.WAVELETS["sym6"], device="cuda")
    m = int(np.ceil(pipe.pad_fraction * 512)) + hz.shape[0] // 2
    padded = A.reflect_pad(x, m)
    up = upsample2d(padded, hz, up=2)
    out = (512 + hz.shape[0] // 2) * 2
    grid = torch.rand((4, out, out, 2), device="cuda", generator=gen) * 1.6 - 0.8
    warped = A.warp(up, grid)

    def backward_of(fn):
        def run():
            xi = x.detach().requires_grad_(True)
            torch.autograd.grad(fn(xi).square().sum(), xi)
        return run

    parts = {"reflect pad": lambda: A.reflect_pad(x, m),
             "FIR upsample x2": lambda: upsample2d(padded, hz, up=2),
             "warp (grid_sample)": lambda: A.warp(up, grid),
             "FIR downsample x2": lambda: downsample2d(warped, hz, down=2,
                                                       padding=-hz.shape[0] // 2,
                                                       flip_filter=True),
             "pipe forward": lambda: pipe(x, p=0.2, generator=gen),
             "pipe forward + input backward": backward_of(lambda xi: pipe(xi, p=0.2,
                                                                          generator=gen))}
    for name, fn in parts.items():
        ms = [chip_smoke.cuda_ms(fn, iters=1, warmup=2 if i == 0 else 0)
              for i in range(args.steps)]
        print(f"[ada] {name:30s} median_ms={statistics.median(ms):.3f} min={min(ms):.3f} "
              f"max={max(ms):.3f}", flush=True)
    del padded, up, warped, grid

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        main, _, dreg = make_eg3d_phase_steps(cfg)
        b = chip_smoke._eg3d_batches(1)[0]
        main(state, b, step_generator(0, 0, "cuda"), 0.0, 0.2)  # warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            main(state, b, step_generator(0, 4, "cuda"), 0.0, 0.2)
            dreg(state, b, step_generator(0, 4, "cuda", 2), 0.0, 0.2)
            torch.cuda.synchronize()
        _write_profile(prof, args.profile, "one ADA Gmain + Dmain and Dreg (fp32, p = 0.2)")
    return 0


def _op_times(prof) -> dict:
    """{op: (self device ms, self host ms, calls)} of a profile."""
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        out[e.key] = (dev / 1e3, e.self_cpu_time_total / 1e3, e.count)
    return out


def _probe_ddp(args) -> int:
    """The G-NeRF step in a world-1 NCCL group against the plain step (see
    the module docstring)."""
    import socket
    import time

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from gnerf_tpu_torch.parallel import make_mesh
    from gnerf_tpu_torch.training import SyntheticDataset, data_iterator, make_train_step
    from gnerf_tpu_torch.training.train import step_generator

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        data = SyntheticDataset(resolution=chip_smoke.SIDE, depth_resolution=64)
        raw = next(data_iterator(data, batch_size=chip_smoke.TRAIN_BATCH, seed=0))
        batch = {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in raw.items()}
        state, cfg = chip_smoke._full_width_trainer(0)
        steps = {"plain": make_train_step(cfg), "distributed": make_train_step(
            cfg, mesh=make_mesh(data=1, rays=1))}

        def run(kind):
            steps[kind](state, batch, step_generator(0, state.cur_nimg, "cuda"))

        for kind in ("plain", "distributed", "plain", "distributed"):
            run(kind)
        torch.cuda.synchronize()
        times = {k: ([], []) for k in steps}
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for i in range(args.steps):
            for kind in (("plain", "distributed") if i % 2 == 0 else ("distributed", "plain")):
                t0 = time.perf_counter()
                ev[0].record()
                run(kind)
                ev[1].record()
                torch.cuda.synchronize()
                times[kind][0].append(ev[0].elapsed_time(ev[1]))
                times[kind][1].append(1e3 * (time.perf_counter() - t0))
        for kind, (dev_ms, host_ms) in times.items():
            print(f"[ddp {kind}] step_ms (CUDA events) median={statistics.median(dev_ms):.3f} "
                  f"min={min(dev_ms):.3f} max={max(dev_ms):.3f}; host clock median="
                  f"{statistics.median(host_ms):.3f}", flush=True)
        ops, profs = {}, {}
        for kind in steps:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(kind)
                torch.cuda.synchronize()
            ops[kind], profs[kind] = _op_times(prof), prof
        a, b = ops["plain"], ops["distributed"]
        zero = (0.0, 0.0, 0)
        for col, what in ((0, "device"), (1, "host")):
            total = [sum(v[col] for v in o.values()) for o in (a, b)]
            print(f"[ddp profile] self {what} ms summed over ops: plain {total[0]:.3f}, "
                  f"distributed {total[1]:.3f}; the ops that differ most (distributed - plain, "
                  f"ms; calls plain / distributed):", flush=True)
            diff = sorted(set(a) | set(b),
                          key=lambda k: -abs(b.get(k, zero)[col] - a.get(k, zero)[col]))
            for k in diff[:12]:
                print(f"[ddp profile]   {b.get(k, zero)[col] - a.get(k, zero)[col]:+10.3f}  "
                      f"{a.get(k, zero)[2]:5d} / {b.get(k, zero)[2]:5d}  {k[:90]}", flush=True)
        if args.profile:
            for kind, prof in profs.items():
                root, ext = os.path.splitext(args.profile)
                _write_profile(prof, f"{root}_{kind}{ext}", f"one {kind} step (world 1)")
    finally:
        dist.destroy_process_group()
    return 0


def _write_profile(prof, path, what):
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(table)
    print(f"[profile] {what}, top device ops:\n" + "\n".join(table.splitlines()[:30]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--objective", choices=("gnerf", "eg3d", "ada", "ddp"), default="gnerf",
                    help="ada: the EG3D step's augment pipe by part (and a profile); ddp: "
                         "the G-NeRF step in a world-1 NCCL group against the plain one")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--profile", metavar="FILE", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    import chip_smoke
    from gnerf_tpu_torch.training import SyntheticDataset, data_iterator, make_train_step
    from gnerf_tpu_torch.training.train import step_generator
    from gnerf_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    if args.objective == "eg3d":
        return _probe_eg3d(args)
    if args.objective == "ada":
        return _probe_ada(args)
    if args.objective == "ddp":
        return _probe_ddp(args)
    batches = data_iterator(SyntheticDataset(resolution=512, depth_resolution=64),
                            batch_size=chip_smoke.TRAIN_BATCH, seed=0)
    dev = [{k: torch.from_numpy(np.asarray(v)).cuda() for k, v in next(batches).items()}
           for _ in range(args.steps + 2)]
    state, cfg = chip_smoke._full_width_trainer(0)
    for remat_synthesis, remat_lpips in ((False, False), (True, False), (False, True),
                                         (True, True)):
        c = dataclasses.replace(cfg, remat_synthesis=remat_synthesis, remat_lpips=remat_lpips)
        step = make_train_step(c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(args.steps + 1)]
        for i, b in enumerate(dev):
            if i == 2:
                ev[0].record()
            step(state, b, step_generator(0, state.cur_nimg, "cuda"))
            if i >= 2:
                ev[i - 1].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(args.steps)]
        med = statistics.median(ms)
        print(f"[remat synthesis={remat_synthesis} lpips={remat_lpips}] step_ms median={med:.3f} "
              f"min={min(ms):.3f} max={max(ms):.3f} images_per_s="
              f"{chip_smoke.TRAIN_BATCH * 1e3 / med:.3f} max_memory_allocated="
              f"{torch.cuda.max_memory_allocated()} bytes", flush=True)

    parts = [_split(state, cfg, b, step_generator(0, 4 * i, "cuda")) for i, b in enumerate(dev)]
    parts = parts[2:]
    whole = sum(statistics.median(p[k] for p in parts) for k in parts[0])
    print(f"[split] medians over {len(parts)} steps (no remat), sum {whole:.3f} ms:", flush=True)
    for k in parts[0]:
        v = statistics.median(p[k] for p in parts)
        print(f"[split]   {k:26s} {v:9.3f} ms  {100 * v / whole:5.1f}%", flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        step = make_train_step(cfg)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, dev[0], step_generator(0, state.cur_nimg, "cuda"))
            torch.cuda.synchronize()
        _write_profile(prof, args.profile, "one step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
