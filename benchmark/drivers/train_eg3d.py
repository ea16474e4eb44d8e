"""Closed loop: EG3D's adversarial training step as `_train_eg3d` drives it.

Set-up builds one trainer (the tri-plane G and the 512^2 dual D loaded
through `load_jax_params` from seeded weights, `init_eg3d_state`,
`make_eg3d_phase_steps` on the configuration's `eg3d_loss_config`), sets its
clock to the mix's `start_kimg`, and feeds it `data_iterator(SyntheticDataset
(...))` batches through the program's `eg3d_loop_step`, the function the
CLI's loop calls: the step's key, z, the blur, resolution and pose-swap
schedules, Gmain + Dmain, Greg and Dreg at their `sched_idx` cadence and
the ADA report. In the first `checked_steps` steps the state is copied to
the host before each phase (Gmain, Dmain, the finish that moves G_ema and
the clock, Greg, Dreg) and after the last, with each phase's loss. Then
`warmup_steps` more steps, and the same trainer goes on into the window.
`train_images_per_s` is the images stepped over the window's time, the
input pipeline included; the window counts the Gmain, Greg and Dreg runs
in it.

Once the window has closed, the frozen reference (`reference/eg3d_train.py`)
takes the same weights, batches and keys and follows the checked steps,
each phase started from the program's state before that phase and its
optimizer stepped with the program's gradient, so that no phase inherits
the gaps of the ones before it (`Teacher`; `check` says what is held).
Mix parameters (traffic/<mix>.json): batch, dataset_size, start_kimg,
checked_steps, warmup_steps, trace_seconds, span_seconds.

In a traced run the benchmark's spans wrap Gmain (`eg3d_loss.gmain_phase`),
Dmain (`eg3d_loss.dmain_phase`), Greg and Dreg, and CUDA events on the
stream before and after each call time the phase on the device, its
backward's kernels (launched from autograd's own thread) included; the
window adds them up by phase (`<phase>_device_s`, `<phase>_calls`).
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from benchmark import roofline, trace, weights
from benchmark.drivers.train import seeds
from benchmark.gnerf_infer import DTYPES
from benchmark.reference import eg3d_train as ref_eg3d
from benchmark.reference import gnerf as ref
from benchmark.reference import train as ref_train

# phase: (the network it trains and its optimizer, the loop's stats key of its loss)
PHASES = {"gmain": ("G", "opt_g", "Loss/G/total"), "dmain": ("D", "opt_d", "Loss/D/total"),
          "greg": ("G", "opt_g", "Loss/G/density_reg"), "dreg": ("D", "opt_d", "Loss/D/reg")}
GAPS = ("loss_gap", "grad_gap", "update_gap", "cadence_gap")


def reference_modules(cfg: dict):
    """(G, dual D) of the frozen reference on `meta`."""
    g, d = cfg["generator"], cfg["discriminator"]
    gen = ref.Generator(
        z_dim=g["z_dim"], c_dim=g["c_dim"], w_dim=g["w_dim"],
        plane_resolution=g["plane_resolution"], plane_channels=g["plane_channels"],
        mapping_layers=g["mapping_layers"], channel_base=g["channel_base"],
        channel_max=g["channel_max"], neural_res=g["neural_rendering_resolution"],
        depth_resolution=g["depth_resolution"],
        depth_resolution_importance=g["depth_resolution_importance"],
        ray_start=g["ray_start"], ray_end=g["ray_end"], box_warp=g["box_warp"])
    disc = ref_eg3d.DualD(res=d["img_resolution"], channel_base=d["channel_base"],
                          channel_max=d["channel_max"], c_dim=g["c_dim"],
                          img_channels=d["img_channels"] // 2)
    return gen, disc


def program(cfg: dict, host: dict, device: str):
    """(trainer state, (main, greg, dreg), the loss configuration) of the
    program under test."""
    from gnerf_tpu_torch.models import DualDiscriminator, TriPlaneGenerator
    from gnerf_tpu_torch.models.triplane import DEFAULT_RENDERING_KWARGS
    from gnerf_tpu_torch.training.eg3d_loss import init_eg3d_state, make_eg3d_phase_steps
    from gnerf_tpu_torch.training.train import eg3d_loss_config
    from gnerf_tpu_torch.training.train_loop import TrainConfig
    from gnerf_tpu_torch.utils.checkpoint import load_jax_params
    from gnerf_tpu_torch.utils.device import resolve_device

    resolve_device(device)  # on CUDA it turns TF32 off, the configuration's fp32 policy
    g, d, t = cfg["generator"], cfg["discriminator"], cfg["training"]
    rk = dict(DEFAULT_RENDERING_KWARGS)
    rk.update(cfg["rendering_kwargs"])
    rk["avg_camera_pivot"] = tuple(rk["avg_camera_pivot"])
    gen = TriPlaneGenerator(
        z_dim=g["z_dim"], c_dim=g["c_dim"], w_dim=g["w_dim"],
        img_resolution=g["img_resolution"], plane_resolution=g["plane_resolution"],
        plane_channels=g["plane_channels"], mapping_layers=g["mapping_layers"],
        channel_base=g["channel_base"], channel_max=g["channel_max"],
        neural_rendering_resolution=g["neural_rendering_resolution"], rendering_kwargs=rk,
        device="meta")
    disc = DualDiscriminator(c_dim=g["c_dim"], img_resolution=d["img_resolution"],
                             img_channels=d["img_channels"] // 2,
                             channel_base=d["channel_base"], channel_max=d["channel_max"],
                             mbstd_group_size=d["mbstd_group_size"], device="meta")
    for net, root in ((gen, "G"), (disc, "D")):
        load_jax_params(net, host[root], device=device)
    tcfg = TrainConfig(batch_size=int(t["batch"]), r1_gamma=t["r1_gamma"],
                       dtype=DTYPES[cfg["dtype"]["all"]])
    lcfg = eg3d_loss_config(rk, tcfg, g["neural_rendering_resolution"],
                            style_mixing_prob=t["style_mixing_prob"],
                            density_reg_every=t["g_reg_interval"],
                            d_reg_interval=t["d_reg_interval"])
    lcfg = dataclasses.replace(lcfg, glr=t["glr"], dlr=t["dlr"],
                               density_reg_p_dist=t["density_reg_p_dist"],
                               density_reg_points=t["density_reg_points"])
    return init_eg3d_state(gen, disc, lcfg, lazy=True), make_eg3d_phase_steps(lcfg), lcfg


def _device_timed(obj, method: str, phase: str, events: list) -> None:
    """Record a CUDA event on the stream before and after every call of
    `obj.method`, appending (phase, start, end) to `events`."""
    inner = getattr(obj, method)

    def run(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        events.append((phase, start, end))
        return out

    setattr(obj, method, run)


class Driver:
    def __init__(self, cell, log):
        self.cell, self.log = cell, log
        self.t = cell.traffic
        self.attempted = self.failed = 0
        self.setup_parts: dict = {}
        self.counters: dict = {}
        self.flops: dict = {}
        self.readings: dict = {}
        self.events: list = []

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from benchmark.harness import process_age_s

        cell, dev = self.cell, self.cell.device
        self.setup_parts = {"import_s": process_age_s()}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            if dev == "cuda":
                torch.cuda.synchronize()
            now = time.perf_counter()
            self.setup_parts[name] = now - t
            t = now

        # The loop's own step first: a program without it fails here, at once.
        from gnerf_tpu_torch.training.train import eg3d_loop_step

        from gnerf_tpu_torch.ops import cuda_build
        from gnerf_tpu_torch.training.dataset import SyntheticDataset, data_iterator
        from gnerf_tpu_torch.training.eg3d_loss import AdaController

        lap("program_import_s")
        if dev == "cuda":
            cuda_build.build(["osg_decode", "threefry", "upfirdn2d"])
        lap("build_s")
        self.run_seed, data_seed, order_seed = seeds(cell.seed)
        gen, disc = reference_modules(cell.config)
        trees = weights.draw({"G": gen, "D": disc}, cell.seed, dev)
        self.host = weights.to_host(trees)
        del trees
        lap("weights_s")
        self.state, phases, self.cfg = program(cell.config, self.host, dev)
        self.phases = types.SimpleNamespace(main=phases[0], greg=phases[1], dreg=phases[2])
        self.loop_step = eg3d_loop_step
        self.start_nimg = int(round(float(self.t["start_kimg"]) * 1000))
        self.state.cur_nimg = self.start_nimg
        self.batch = int(self.t["batch"])
        self.ada = AdaController(self.cfg, self.batch, 0.0)
        self.aug_p = 0.0
        g = cell.config["generator"]
        self.data_args = (data_seed, order_seed, self.batch, int(self.t["dataset_size"]),
                          g["img_resolution"], g["neural_rendering_resolution"])
        dataset = SyntheticDataset(resolution=g["img_resolution"],
                                   depth_resolution=g["neural_rendering_resolution"],
                                   size=int(self.t["dataset_size"]), seed=data_seed)
        self.batches = data_iterator(dataset, batch_size=self.batch, seed=order_seed)
        lap("load_s")
        self._checked_steps()
        for _ in range(int(self.t["warmup_steps"])):
            self._one()
        lap("warmup_s")
        if cell.trace:
            from gnerf_tpu_torch.training import eg3d_loss

            for obj, method, span in ((eg3d_loss, "gmain_phase", "gmain"),
                                      (eg3d_loss, "dmain_phase", "dmain"),
                                      (self.phases, "greg", "greg"),
                                      (self.phases, "dreg", "dreg")):
                if dev == "cuda":
                    _device_timed(obj, method, span, self.events)
                trace.wrap(obj, method, span)

    def _one(self, phases=None):
        """One step as the loop makes it; returns (stats, host s waiting for data)."""
        t = time.perf_counter()
        host = next(self.batches)
        wait = time.perf_counter() - t
        ph = phases or self.phases
        stats, self.aug_p = self.loop_step(self.state, (ph.main, ph.greg, ph.dreg), self.cfg,
                                           host, self.run_seed, self.aug_p, self.ada,
                                           batch=self.batch, device=self.cell.device)
        return stats, wait

    def _snapshot(self) -> dict:
        """G, D and G_ema by state_dict name, and the Adam state of G's and
        D's parameters by name, copied to the host."""
        st = self.state

        def host(tensors):
            return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}

        def opt(o, module):
            names = {id(p): k for k, p in module.named_parameters()}
            return {names[id(p)]: host(s) for p, s in o.state.items()}

        return {"G": host(st.g.state_dict()), "D": host(st.disc.state_dict()),
                "Gema": host(st.g_ema.state_dict()),
                "opt_g": opt(st.opt_g, st.g), "opt_d": opt(st.opt_d, st.disc)}

    def _checked_steps(self) -> None:
        """The checked steps, with the state before each phase, the state
        after the last, and each step's phase losses in `self.readings`."""
        from gnerf_tpu_torch.training import eg3d_loss

        records, step = [], [0]

        def before(fn, phase):
            def run(*args, **kwargs):
                records.append((step[0], phase, self._snapshot()))
                return fn(*args, **kwargs)
            return run

        patched = [(eg3d_loss, "gmain_phase", "gmain"), (eg3d_loss, "dmain_phase", "dmain"),
                   (eg3d_loss, "_finish_main", "finish")]
        saved = [getattr(obj, name) for obj, name, _ in patched]
        ph = self.phases
        read = types.SimpleNamespace(main=ph.main, greg=ph.greg and before(ph.greg, "greg"),
                                     dreg=ph.dreg and before(ph.dreg, "dreg"))
        losses = []
        try:
            for obj, name, phase in patched:
                setattr(obj, name, before(getattr(obj, name), phase))
            for i in range(int(self.t["checked_steps"])):
                step[0] = i
                stats, _ = self._one(read)
                losses.append({phase: float(stats[key]) for phase, (_, _, key) in PHASES.items()
                               if key in stats})
        finally:
            for (obj, name, _), fn in zip(patched, saved):
                setattr(obj, name, fn)
        records.append((len(losses), "end", self._snapshot()))
        self.readings = {"records": records, "losses": losses}

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        sync = torch.cuda.synchronize if self.cell.device == "cuda" else (lambda: None)
        sync()
        self.events.clear()
        t0 = time.perf_counter()
        steps = greg = dreg = 0
        wait = 0.0
        while time.perf_counter() - t0 < seconds:
            stats, w = self._one()
            steps, wait = steps + 1, wait + w
            greg += PHASES["greg"][2] in stats
            dreg += PHASES["dreg"][2] in stats
        sync()
        elapsed = time.perf_counter() - t0
        images = steps * self.batch
        self.attempted = steps
        self.counters = {"steps": steps, "greg": greg, "dreg": dreg, "data_wait_s": wait}
        for phase, start, end in self.events:
            self.counters[f"{phase}_device_s"] = (self.counters.get(f"{phase}_device_s", 0.0)
                                                  + start.elapsed_time(end) / 1e3)
            self.counters[f"{phase}_calls"] = self.counters.get(f"{phase}_calls", 0) + 1
        self.log(f"window {elapsed:.3f} s: {steps} steps ({greg} Greg, {dreg} Dreg), {images} "
                 f"images, {1e3 * elapsed / max(steps, 1):.2f} ms a step, data wait "
                 f"{1e3 * wait:.1f} ms")
        return {"train_images_per_s": images / elapsed}

    def release(self) -> None:
        self.state = self.phases = self.batches = None
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def reference_gaps(self, count_flops: bool = False) -> dict:
        """The reference over the checked steps from the same weights,
        batches and keys, taught by the program's records (`Teacher`); the
        gaps as `summarise` gives them."""
        dev, cfg = self.cell.device, self.cell.config
        gen, disc = reference_modules(cfg)
        ref.load_state(gen, self.host["G"], dev)
        ref.load_state(disc, self.host["D"], dev)
        t, rk = cfg["training"], cfg["rendering_kwargs"]
        step = ref_eg3d.Step(
            gen, disc, self.batch, cfg["generator"]["z_dim"], glr=t["glr"], dlr=t["dlr"],
            r1_gamma=t["r1_gamma"], density_reg=t["density_reg"],
            p_dist=t["density_reg_p_dist"], points=t["density_reg_points"],
            g_interval=t["g_reg_interval"], d_interval=t["d_reg_interval"],
            gpc_prob=rk["gpc_reg_prob"], gpc_fade_kimg=rk["gpc_reg_fade_kimg"],
            blur_init_sigma=rk["blur_init_sigma"], blur_fade_kimg=rk["blur_fade_kimg"],
            ema_kimg=t["ema_kimg"])
        step.cur_nimg = self.start_nimg

        def count(fn, *args):
            flops, out = roofline.count_flops(fn, *args)
            self.flops[fn.__name__] = flops
            return out

        teacher = Teacher(step, self.readings["records"], self.readings["losses"], dev)
        data = ref_train.batches(*self.data_args)
        for i in range(len(self.readings["losses"])):
            step(next(data), self.run_seed, dev, count if count_flops and i == 0 else None,
                 teacher)
        return summarise(teacher, len(self.readings["losses"]))

    def check(self) -> list:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gaps = self.reference_gaps(count_flops=self.cell.trace)
        limits = self.cell.config["limits"]
        self.log(" ".join(f"{k} {gaps[k]!r}" for k in GAPS) + "; by phase: " + " ".join(
            f"{phase} loss {g['loss']:.3g} grad {g['grad'][0]:.3g} ({g['grad'][1]}) "
            f"update {g['update'][0]:.3g} ({g['update'][1]})"
            for phase, g in gaps["phases"].items()))
        return [[name, gaps[name], float(limits[name])] for name in GAPS]

    def reading(self, tr: trace.Trace) -> dict:
        from gnerf_tpu_torch.utils import profiling

        seen: dict = {}
        for name, *_ in profiling.take():
            if name.startswith(("eg3d.", "ddp.", "disc")):
                seen[name] = seen.get(name, 0) + 1
        self.log(f"program spans in the traced windows: {seen}")
        g, b = self.cell.config["generator"], self.batch
        c = self.counters
        m = g["neural_rendering_resolution"] ** 2 * g["depth_resolution"]
        points = 2 * int(self.cell.config["training"]["density_reg_points"])

        def bound(n, m_):
            return roofline.decoder_bound_s(n, m_, g["plane_channels"], 64, 33, False)

        return {"trace": tr, "counters": c, "flops": self.flops,
                "decoder_launches": 4 * c.get("steps", 0) + c.get("greg", 0),
                "decoder_bound_total_s": (4 * c.get("steps", 0) * bound(b, m)
                                          + c.get("greg", 0) * bound(b, points)),
                "reg_intervals": (self.cfg.g_reg_interval, self.cfg.d_reg_interval),
                "peak_flops": roofline.PEAK_FLOPS["fp32"]}


class Teacher:
    """Runs each phase of the reference from the program's state before it
    and steps the reference's optimizer with the program's gradient, so
    that every phase is held alone: a gap does not carry into the phases
    after it (Adam with beta1 = 0 moves every element by about its rate,
    so an element whose gradient is below rounding moves either way, and
    a phase started from the reference's own state inherits that). The
    program's gradient is Adam's first moment after the phase, which is
    the gradient when beta1 is 0, as in both optimizers here.

    After each phase it reads, against the program's records: the loss
    (relative), each leaf's gradient, and each leaf of G, D and G_ema
    after the phase (`worst_leaf`); a phase the program did not run reads a
    loss gap of 1. Phase "finish" moves G_ema and the clock."""

    def __init__(self, step, records: list, losses: list, device):
        self.step, self.dev, self.records, self.losses = step, device, records, losses
        self.at = {(i, phase): k for k, (i, phase, _) in enumerate(records)}
        self.modules = {"G": step.g, "D": step.disc, "Gema": step.g_ema}
        self.opts = {"opt_g": (step.opt_g, step.g), "opt_d": (step.opt_d, step.disc)}
        self.i, self.current, self.grads = -1, None, None
        self.ran: list = []
        self.gaps: dict = {}  # (step, phase) -> {"loss", "grad", "update"}

    def before(self, phase: str) -> None:
        self.i += phase == "gmain"
        self.ran.append((self.i, phase))
        self.current = self.at.get((self.i, phase))
        if self.current is None:
            self.gaps[(self.i, phase)] = {"loss": 1.0}
            return
        snap = self.records[self.current][2]
        with torch.no_grad():
            for net, module in self.modules.items():
                for k, v in module.state_dict().items():
                    v.copy_(snap[net][k])
        for key, (opt, module) in self.opts.items():
            opt.state.clear()
            for k, p in module.named_parameters():
                if k in snap[key]:
                    opt.state[p] = {n: v.to(self.dev if n != "step" else v.device, copy=True)
                                    for n, v in snap[key][k].items()}

    def _program_grads(self, phase: str) -> dict:
        net, key, _ = PHASES[phase]
        moments = self.records[self.current + 1][2][key]
        return {k: moments[k]["exp_avg"] if k in moments else None
                for k, _ in self.modules[net].named_parameters()}

    def gradient(self, phase: str, grads: list) -> list:
        if self.current is None:
            return grads
        self.grads = grads
        return [torch.zeros_like(want) if got is None else got.to(self.dev, copy=True)
                for got, want in zip(self._program_grads(phase).values(), grads)]

    def after(self, phase: str, out) -> None:
        if self.current is None:
            return
        before, after = self.records[self.current][2], self.records[self.current + 1][2]
        gaps = self.gaps[(self.i, phase)] = {}
        if phase in PHASES:
            got, want = self.losses[self.i].get(phase), out[0]
            gaps["loss"] = 1.0 if got is None else abs(got - want) / max(abs(want), 1e-30)
            got = self._program_grads(phase)
            gaps["grad"] = worst_leaf(got, dict(zip(got, self.grads)))
        states = {f"{net}/{k}": v for net, module in self.modules.items()
                  for k, v in module.state_dict().items()}
        gaps["update"] = worst_leaf(
            {f"{net}/{k}": v for net in self.modules for k, v in after[net].items()}, states,
            {f"{net}/{k}": v for net in self.modules for k, v in before[net].items()})


def worst_leaf(got: dict, want: dict, base: dict | None = None) -> tuple:
    """(gap, leaf): the largest |got - want| / max(|want - base|, the median
    of |want - base| over the leaves it moves), |want| where `base` is None;
    a leaf `got` lacks reads 1."""
    scale = {k: float((v - base[k].to(v.device)).float().norm()) if base is not None
             else float(v.float().norm()) for k, v in want.items()}
    moved = [v for v in scale.values() if v > 0]
    median = float(np.median(moved)) if moved else 0.0
    worst = (0.0, "")
    for k, v in want.items():
        gap = (1.0 if got.get(k) is None else
               float((got[k].to(v.device) - v).float().norm()) / max(scale[k], median, 1e-30))
        if gap > worst[0]:
            worst = (gap, k)
    return worst


def summarise(teacher: Teacher, steps: int) -> dict:
    """The held gaps, each the largest over the checked steps' phases:
    `loss_gap`, `grad_gap` and `update_gap`, and `cadence_gap`, the steps
    whose phases are not the reference's; and `phases`, each phase's
    largest (loss, (grad, leaf), (update, leaf))."""
    phases: dict = {}
    for (_, phase), g in teacher.gaps.items():
        p = phases.setdefault(phase, {"loss": 0.0, "grad": (0.0, ""), "update": (0.0, "")})
        p["loss"] = max(p["loss"], g.get("loss", 0.0))
        p["grad"] = max(p["grad"], g.get("grad", (0.0, "")))
        p["update"] = max(p["update"], g.get("update", (0.0, "")))
    ran = {(i, phase) for i, phase, _ in teacher.records if phase != "end"}
    cadence = sum({p for j, p in ran if j == i} != {p for j, p in teacher.ran if j == i}
                  for i in range(steps))
    return {"loss_gap": max(p["loss"] for p in phases.values()),
            "grad_gap": max(p["grad"][0] for p in phases.values()),
            "update_gap": max(p["update"][0] for p in phases.values()),
            "cadence_gap": float(cadence), "phases": phases}
