"""Closed loop: the G-NeRF training step as `run_training` drives it.

Set-up builds one trainer (E, G, the depth D and the LPIPS VGG loaded
through `load_jax_params` from seeded weights, `init_train_state`,
`make_train_step`), with batches from the program's
`data_iterator(SyntheticDataset(...))` and keys from `step_key(seed,
cur_nimg)`. It drives the first `checked_steps` steps through the loop's
own call and feed, reading what the check needs: each step's G and D loss,
the first gradient of every leaf from Adam's state after step 1, and every
leaf's change after the last checked step. Then `warmup_steps` more steps,
and the same trainer goes on into the window. `train_images_per_s` is the
images stepped over the window's time, the input pipeline included.

Once the window has closed, the reference takes the same weights, works out
the same batches and keys, follows the checked steps, and the readings are
compared, each leaf by its norm (`grad_gap`, `update_gap`). Mix parameters
(traffic/<mix>.json): batch, checked_steps, warmup_steps, trace_seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import roofline, trace, weights
from benchmark.gnerf_infer import DTYPES
from benchmark.reference import gnerf as ref
from benchmark.reference import train as ref_train


def seeds(seed: int) -> tuple[int, int, int]:
    """(run seed for keys and weights, dataset seed, order seed) of a run
    seed: JAX's 32-bit key seed, the dataset's RandomState(seed * 100003 +
    index) and the sampler's RandomState(seed) all need small seeds."""
    return seed % 2 ** 31, seed % 40000, seed % 2 ** 31


def reference_modules(cfg: dict):
    """(G, E, D, VGG) of the frozen reference on `meta`."""
    g = cfg["generator"]
    gen = ref.Generator(
        z_dim=g["z_dim"], c_dim=g["c_dim"], w_dim=g["w_dim"],
        plane_resolution=g["plane_resolution"], plane_channels=g["plane_channels"],
        mapping_layers=g["mapping_layers"], channel_base=g["channel_base"],
        channel_max=g["channel_max"], neural_res=g["neural_rendering_resolution"],
        depth_resolution=g["depth_resolution"],
        depth_resolution_importance=g["depth_resolution_importance"],
        ray_start=g["ray_start"], ray_end=g["ray_end"], box_warp=g["box_warp"])
    enc = ref.Encoder(out_dim=cfg["encoder"]["out_dim"], layers=tuple(cfg["encoder"]["layers"]))
    d = cfg["discriminator"]
    disc = ref_train.DepthD(res=g["neural_rendering_resolution"], channel_base=d["channel_base"],
                            channel_max=d["channel_max"], c_dim=g["c_dim"])
    return gen, enc, disc, ref_train.VGG()


def program(cfg: dict, host: dict, device: str):
    """(trainer state, step function) of the program under test."""
    from gnerf_tpu_torch.models import Discriminator, ResNeXt50Encoder, TriPlaneGenerator
    from gnerf_tpu_torch.models.triplane import DEFAULT_RENDERING_KWARGS
    from gnerf_tpu_torch.training.losses import VGG16LPIPS
    from gnerf_tpu_torch.training.train_loop import TrainConfig, init_train_state, make_train_step
    from gnerf_tpu_torch.utils.checkpoint import load_jax_params
    from gnerf_tpu_torch.utils.device import resolve_device

    # The training CLI's entry does this first: on CUDA it turns TF32 off,
    # the configuration's fp32 policy.
    resolve_device(device)
    g, t = cfg["generator"], cfg["training"]
    rk = dict(DEFAULT_RENDERING_KWARGS)
    rk.update(cfg["rendering_kwargs"])
    gen = TriPlaneGenerator(
        z_dim=g["z_dim"], c_dim=g["c_dim"], w_dim=g["w_dim"],
        img_resolution=g["img_resolution"], plane_resolution=g["plane_resolution"],
        plane_channels=g["plane_channels"], mapping_layers=g["mapping_layers"],
        channel_base=g["channel_base"], channel_max=g["channel_max"],
        neural_rendering_resolution=g["neural_rendering_resolution"], rendering_kwargs=rk,
        device="meta")
    enc = ResNeXt50Encoder(out_dim=cfg["encoder"]["out_dim"],
                           layers=tuple(cfg["encoder"]["layers"]), device="meta")
    d = cfg["discriminator"]
    disc = Discriminator(c_dim=g["c_dim"], img_resolution=g["neural_rendering_resolution"],
                         img_channels=1, channel_base=d["channel_base"],
                         channel_max=d["channel_max"], device="meta")
    vgg = VGG16LPIPS(device="meta")
    for net, root in ((gen, "G"), (enc, "E"), (disc, "D"), (vgg, "V")):
        load_jax_params(net, host[root], device=device)
    tcfg = TrainConfig(batch_size=int(t["batch"]), glr=t["glr"], dlr=t["dlr"],
                       r1_gamma=t["r1_gamma"], gan_depth=True, train_en=True, train_gen=False,
                       neural_rendering_resolution=g["neural_rendering_resolution"],
                       dtype=DTYPES[cfg["dtype"]["all"]])
    return init_train_state(gen, enc, disc, vgg, tcfg), make_train_step(tcfg)


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


class Driver:
    def __init__(self, cell, log):
        self.cell, self.log = cell, log
        self.t = cell.traffic
        self.attempted = self.failed = 0
        self.setup_parts: dict = {}
        self.counters: dict = {}
        self.flops: dict = {}
        self.readings: dict = {}

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

        import gnerf_tpu_torch.training.train as program_train
        from gnerf_tpu_torch.ops import cuda_build
        from gnerf_tpu_torch.training.dataset import SyntheticDataset, data_iterator

        lap("program_import_s")
        if dev == "cuda":
            cuda_build.build(["osg_decode", "threefry"])
        lap("build_s")
        self.run_seed, data_seed, order_seed = seeds(cell.seed)
        gen, enc, disc, vgg = reference_modules(cell.config)
        trees = weights.draw({"G": gen, "E": enc, "D": disc, "V": vgg}, cell.seed, dev)
        self.host = weights.to_host(trees)
        del trees
        lap("weights_s")
        self.state, self.step = program(cell.config, self.host, dev)
        self.step_key = program_train.step_key
        g = cell.config["generator"]
        self.data_args = (data_seed, order_seed, int(self.t["batch"]), int(self.t["dataset_size"]),
                          g["img_resolution"], g["neural_rendering_resolution"])
        dataset = SyntheticDataset(resolution=g["img_resolution"],
                                   depth_resolution=g["neural_rendering_resolution"],
                                   size=int(self.t["dataset_size"]), seed=data_seed)
        self.batches = data_iterator(dataset, batch_size=int(self.t["batch"]), seed=order_seed)
        lap("load_s")
        self._checked_steps()
        for _ in range(int(self.t["warmup_steps"])):
            self._one()
        lap("warmup_s")
        if cell.trace:
            st = self.state
            trace.wrap(st.enc, "apply", "encoder")
            trace.wrap(st.g, "synthesis", "synthesis")
            trace.wrap(st.disc, "apply", "disc")
            trace.wrap(st.vgg, "apply", "lpips")

    def _to_device(self, host):
        return {k: torch.from_numpy(np.asarray(v)).to(self.cell.device, non_blocking=True)
                for k, v in host.items()}

    def _one(self):
        """One step as the loop makes it; returns (stats, host s waiting for data)."""
        t = time.perf_counter()
        batch = self._to_device(next(self.batches))
        wait = time.perf_counter() - t
        _, stats = self.step(self.state, batch, self.step_key(self.run_seed, self.state.cur_nimg))
        return stats, wait

    def _named(self):
        st = self.state
        return {**{f"E/{k}": p for k, p in st.enc.named_parameters()},
                **{f"D/{k}": p for k, p in st.disc.named_parameters()}}

    def _checked_steps(self) -> None:
        params = self._named()
        start = {k: p.detach().clone() for k, p in params.items()}
        losses = []
        for i in range(int(self.t["checked_steps"])):
            stats, _ = self._one()
            losses.append((float(stats["Loss/G/total"]), float(stats["Loss/D/total"])))
            if i == 0:
                grads = {}
                for opt in (self.state.opt_g, self.state.opt_d):
                    beta1 = opt.param_groups[0]["betas"][0]
                    names = {id(p): k for k, p in params.items()}
                    for p, s in opt.state.items():
                        grads[names[id(p)]] = s["exp_avg"] / (1.0 - beta1)
                self.readings["grads"] = leaf_norms(grads)
        self.readings["losses"] = losses
        self.readings["updates"] = leaf_norms({k: p.detach() - start[k] for k, p in params.items()})
        self.readings["sizes"] = {k: p.numel() for k, p in params.items()}

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        sync = torch.cuda.synchronize if self.cell.device == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        steps, wait = 0, 0.0
        while time.perf_counter() - t0 < seconds:
            _, w = self._one()
            steps, wait = steps + 1, wait + w
        sync()
        elapsed = time.perf_counter() - t0
        images = steps * int(self.t["batch"])
        self.attempted, self.counters = steps, {"steps": steps, "data_wait_s": wait}
        self.log(f"window {elapsed:.3f} s: {steps} steps, {images} images, "
                 f"{1e3 * elapsed / max(steps, 1):.2f} ms a step, data wait {1e3 * wait:.1f} ms")
        return {"train_images_per_s": images / elapsed}

    def release(self) -> None:
        self.state = self.step = self.batches = None
        if self.cell.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def reference_readings(self, count_flops: bool = False, half: bool = False) -> dict:
        """The reference's losses, first gradients and changes over the
        checked steps, from the same weights, batches and keys. `half`
        plants a fault for the calibration: half of each batch left out,
        the means taken over the rest."""
        dev = self.cell.device
        gen, enc, disc, vgg = reference_modules(self.cell.config)
        for net, root in ((gen, "G"), (enc, "E"), (disc, "D"), (vgg, "V")):
            ref.load_state(net, self.host[root], dev)
        t = self.cell.config["training"]
        step = ref_train.Step(gen, enc, disc, vgg, int(self.t["batch"]), glr=t["glr"],
                              dlr=t["dlr"], r1_gamma=t["r1_gamma"])
        named = {**{f"E/{k}": p for k, p in enc.named_parameters()},
                 **{f"D/{k}": p for k, p in disc.named_parameters()}}
        start = {k: p.detach().clone() for k, p in named.items()}
        data = ref_train.batches(*self.data_args)
        losses, grads = [], {}
        for i in range(int(self.t["checked_steps"])):
            rows = int(self.t["batch"]) // 2 if half else int(self.t["batch"])
            batch = {k: torch.from_numpy(v[:rows]).to(dev) for k, v in next(data).items()}
            key = ref_train.step_key(self.run_seed, i * int(self.t["batch"]))
            if count_flops and i == 0:
                flops, out = roofline.count_flops(step, batch, key, dev)
                self.flops = {"step": flops}
            else:
                out = step(batch, key, dev)
            losses.append((out["loss_g"], out["loss_d"]))
            if i == 0:
                grads = leaf_norms(dict(zip(named, out["grads"])))
        updates = leaf_norms({k: p.detach() - start[k] for k, p in named.items()})
        return {"losses": losses, "grads": grads, "updates": updates,
                "sizes": {k: p.numel() for k, p in named.items()}}

    def check(self) -> list:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        want = self.reference_readings(count_flops=self.cell.trace)
        gaps = compare(self.readings, want)
        limits = self.cell.config["limits"]
        self.log(f"loss_gap {gaps['loss_gap']!r} grad_gap {gaps['grad_gap']!r} "
                 f"update_gap {gaps['update_gap']!r} update_gap_short "
                 f"{gaps['update_gap_short']!r} (leaves left out: {gaps['left_out']})")
        return [[name, gaps[name], float(limits[name])] for name in GAPS]

    def reading(self, tr: trace.Trace) -> dict:
        g, b = self.cell.config["generator"], int(self.t["batch"])
        m = g["neural_rendering_resolution"] ** 2 * g["depth_resolution"]
        return {"trace": tr, "counters": self.counters, "flops": self.flops,
                "decoder_bound_s": roofline.decoder_bound_s(b, m, g["plane_channels"], 64, 33,
                                                            False),
                "peak_flops": roofline.PEAK_FLOPS["fp32"]}


def _worst_leaf(got: dict, want: dict, leaves) -> float:
    """max over `leaves` of |got - want| / max(want, the median of want)."""
    leaves = list(leaves)
    if not leaves:
        return 0.0
    groups: dict = {}
    for k in leaves:
        groups.setdefault(k.split("/", 1)[0], []).append(k)
    worst = 0.0
    for names in groups.values():
        median = float(np.median([want[k] for k in names]))
        for k in names:
            worst = max(worst, abs(got[k] - want[k]) / max(want[k], median, 1e-30))
    return worst


GAPS = ("loss_gap", "grad_gap", "update_gap", "update_gap_short")
MIN_LEAF = 4096  # elements of the smallest leaf compared in `update_gap`


def compare(got: dict, want: dict) -> dict:
    """The gaps of the program's readings from the reference's: each step's
    G and D loss (relative), each leaf's first gradient and change (by norm,
    against that leaf's or its network's median leaf's norm). A leaf whose
    reference gradient is under a thousandth of its network's median leaf's
    moves under Adam by rounding alone and is left out of the change.

    The change is compared in two groups with limits of their own:
    `update_gap` over the leaves of MIN_LEAF elements or more (the
    convolutions and dense weights), `update_gap_short` over the shorter
    ones (E's BatchNorm scales and biases, 64-2048 elements). Adam moves
    each element by about its learning rate whatever the gradient's size,
    so a few elements whose near-zero gradients change sign by rounding
    move a short vector's norm by up to 0.7 % on an H100, ten times what
    the long leaves read; a short leaf left unmoved or moved double still
    reads about 1 (PERF.md gives the readings)."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for pg, pw in zip(got["losses"], want["losses"]) for a, b in zip(pg, pw))
    g = want["grads"]
    medians = {net: float(np.median([v for k, v in g.items() if k.startswith(net + "/")]))
               for net in {k.split("/", 1)[0] for k in g}}
    moved = [k for k in g if g[k] >= 1e-3 * medians[k.split("/", 1)[0]]]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(got["grads"], g, g),
            "update_gap": _worst_leaf(got["updates"], want["updates"],
                                      [k for k in moved if want["sizes"][k] >= MIN_LEAF]),
            "update_gap_short": _worst_leaf(got["updates"], want["updates"],
                                            [k for k in moved if want["sizes"][k] < MIN_LEAF]),
            "left_out": sorted(set(g) - set(moved))}
