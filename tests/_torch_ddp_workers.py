"""What each gloo rank runs in the port's distributed tests
(tests/test_torch_parallel.py, test_torch_ddp_*.py), through
`_torch_dist.run_ranks`. Imports torch and the port only, so the ranks
start quickly; the tests hold the results to JAX and to the port's world 1.

The tiny networks are described by a spec the test writes with
`torch.save`: constructor arguments and state_dicts (`build_gnerf`,
`build_eg3d` build the same state in the test process and in every rank).
"""

import numpy as np
import torch
import torch.distributed as dist

from gnerf_tpu_torch.parallel import (all_gather, all_reduce, check_replica_consistency,
                                      draw, local_rows, make_mesh, pmean_grads, use_mesh)


def to_np(x):
    """A copy: a CPU tensor's numpy() shares its memory, and the state moves on."""
    return x.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# Collectives


def collective_fns(group):
    """name -> (the collective on this rank, its single-process version over
    the list of every rank's input at rank r)."""
    return {
        "all_reduce_sum": (lambda x: all_reduce(x, group),
                           lambda xs, r: sum(xs)),
        "all_reduce_mean": (lambda x: all_reduce(x, group, mean=True),
                            lambda xs, r: sum(xs) / len(xs)),
        "all_gather_dim0": (lambda x: all_gather(x, group, dim=0),
                            lambda xs, r: torch.cat(xs, dim=0)),
        "all_gather_dim1": (lambda x: all_gather(x, group, dim=1),
                            lambda xs, r: torch.cat(xs, dim=1)),
    }


def second_order_terms(y, x, a, b):
    """loss = sum(sin(y) * a); g = dloss/dx with a graph; h = sum(g^2 * b);
    returns (g, dh/dx, dh/da)."""
    loss = (torch.sin(y) * a).sum()
    (g,) = torch.autograd.grad(loss, x, create_graph=True)
    h = (g.square() * b).sum()
    gx, ga = torch.autograd.grad(h, [x, a])
    return g, gx, ga


def collectives_case(rank, world, inputs):
    """Every collective's value and first and second derivatives on this
    rank, from the inputs[name] = (xs, as, bs) of all ranks."""
    out = {}
    for name, (fn, _) in collective_fns(dist.group.WORLD).items():
        xs, as_, bs = inputs[name]
        x = torch.tensor(xs[rank], dtype=torch.float64, requires_grad=True)
        a = torch.tensor(as_[rank], dtype=torch.float64, requires_grad=True)
        b = torch.tensor(bs[rank], dtype=torch.float64)
        y = fn(x)
        g, gx, ga = second_order_terms(y, x, a, b)
        out[name] = tuple(to_np(t) for t in (y, g, gx, ga))
    return out


def mesh_case(rank, world):
    """Each mesh's (data_rank, ray_rank) and the global ranks in this
    rank's data and ray groups (gathered over each group), and the messages
    of the meshes that cannot be made."""
    out = {}
    for name, kw in {"2x2": dict(data=2, rays=2), "rays2": dict(rays=2),
                     "4x1": dict(data=4), "1x4": dict(data=1, rays=4)}.items():
        mesh = make_mesh(**kw)
        me = torch.tensor([float(rank)])
        out[name] = dict(data=mesh.data, rays=mesh.rays, data_rank=mesh.data_rank,
                         ray_rank=mesh.ray_rank,
                         data_group=to_np(all_gather(me, mesh.data_group)).astype(int).tolist(),
                         ray_group=to_np(all_gather(me, mesh.ray_group)).astype(int).tolist())
    errors = {}
    for name, kw in {"3x1": dict(data=3), "rays3": dict(rays=3)}.items():
        try:
            make_mesh(**kw)
        except AssertionError as err:
            errors[name] = str(err)
    out["errors"] = errors
    return out


def pmean_case(rank, world, grads):
    """pmean_grads over the world of this rank's gradients grads[rank]."""
    mine = [None if g is None else torch.tensor(g) for g in grads[rank]]
    return [None if g is None else to_np(g) for g in pmean_grads(mine, dist.group.WORLD)]


def moments_case(rank, world):
    """psum_moments of this rank's [n, sum, sum_sq] of the values rank + (0, 1, 2)."""
    from gnerf_tpu_torch.parallel import psum_moments

    v = torch.arange(3.0, dtype=torch.float64) + rank
    return to_np(psum_moments(torch.stack([torch.tensor(3.0, dtype=torch.float64), v.sum(),
                                            v.square().sum()]), dist.group.WORLD))


def replica_case(rank, world):
    """The consistency check on equal tensors, then after rank 2 changes one."""
    named = [("w", torch.ones(3, 4)), ("b", torch.arange(5.0)), ("c", torch.zeros(2))]
    first = check_replica_consistency(named, dist.group.WORLD)
    if rank == 2:
        named[1][1][3] += 1
    try:
        check_replica_consistency(named, dist.group.WORLD)
        second = None
    except AssertionError as err:
        second = str(err)
    return first, second


def draw_case(rank, world, data, rays):
    """This rank's part of a batch draw and of a batch x rays draw under the
    (data, rays) mesh, and its rows of a global tensor."""
    mesh = make_mesh(data=data, rays=rays)
    gen = torch.Generator().manual_seed(5)
    with use_mesh(mesh):
        rows = draw(torch.randn, (8 // data, 3), gen)
        rows_rays = draw(torch.rand, (8 // data, 8 // rays, 4), gen, ray_mesh=mesh, ray_dim=1)
    return to_np(rows), to_np(rows_rays), to_np(local_rows(torch.arange(8.0), mesh))


# ---------------------------------------------------------------------------
# Models


def bn_case(rank, world, x, w, params, momentum):
    """The encoder's train-mode BatchNorm on this rank's rows of x under a
    data mesh: (y, dL/dx, dL/dscale, dL/dbias, new mean, new var) for
    L = sum(y * w) over the rank's rows."""
    from gnerf_tpu_torch.models.encoder import _BatchNorm

    mesh = make_mesh(data=world)
    bn = _BatchNorm(x.shape[1])
    with torch.no_grad():
        for k, v in params.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    xr = local_rows(torch.from_numpy(x), mesh).clone().requires_grad_(True)
    with use_mesh(mesh):
        y = bn(xr, train=True, momentum=momentum)
        loss = (y * local_rows(torch.from_numpy(w), mesh)).sum()
        gx, gs, gb = torch.autograd.grad(loss, [xr, bn.scale, bn.bias])
    return tuple(to_np(t) for t in (y, gx, gs, gb, bn.mean, bn.var))


def mbstd_case(rank, world, x, w, k, group_size):
    """minibatch_std on this rank's rows under a data mesh: (out, dL/dx,
    the R1 input gradient, dR1/dk) for L = sum(out * w) and
    R1 = sum over rows of |d(sum tanh(k * out))/dx|^2."""
    from gnerf_tpu_torch.models.stylegan2 import minibatch_std

    mesh = make_mesh(data=world)
    xr = local_rows(torch.from_numpy(x), mesh).clone().requires_grad_(True)
    kt = torch.tensor(k, requires_grad=True)
    with use_mesh(mesh):
        out = minibatch_std(xr, group_size)
        (gx,) = torch.autograd.grad((out * local_rows(torch.from_numpy(w), mesh)).sum(), xr,
                                    retain_graph=True)
        logits = torch.tanh(minibatch_std(xr, group_size) * kt).sum(dim=(1, 2, 3))
        (g1,) = torch.autograd.grad(logits.sum(), xr, create_graph=True)
        (gk,) = torch.autograd.grad(g1.square().sum(), kt)
    return tuple(to_np(t) for t in (out, gx, g1, gk))


DISCS = {
    "depth": ("Discriminator", dict(c_dim=25, img_resolution=16, img_channels=1,
                                    channel_base=256, channel_max=32, mbstd_group_size=4)),
    "single": ("SingleDiscriminator", dict(c_dim=25, img_resolution=16, img_channels=3,
                                           channel_base=256, channel_max=32,
                                           mbstd_group_size=4)),
    "dual": ("DualDiscriminator", dict(c_dim=25, img_resolution=16, img_channels=3,
                                       channel_base=256, channel_max=32, mbstd_group_size=4)),
    "dummy_dual": ("DummyDualDiscriminator", dict(c_dim=25, img_resolution=16, img_channels=3,
                                                  channel_base=256, channel_max=32,
                                                  mbstd_group_size=4)),
}


def make_disc(name):
    from gnerf_tpu_torch.models import dual_discriminator, stylegan2

    cls, kw = DISCS[name]
    mod = stylegan2 if cls == "Discriminator" else dual_discriminator
    return getattr(mod, cls)(**kw, device="cpu", generator=torch.Generator().manual_seed(3))


def disc_inputs(disc, name, img, raw, c):
    if name == "depth":
        return img[:, :1]
    return {"image": img, "image_raw": raw}


def disc_logits_and_r1(name, img, raw, c):
    """D's logits, its R1 input gradient (of the image) and the gradient of
    the summed R1 penalty with respect to D's weights, on the given rows."""
    disc = make_disc(name)
    img = img.clone().requires_grad_(True)
    logits = disc.apply(disc_inputs(disc, name, img, raw, c), c)
    (g,) = torch.autograd.grad(logits.sum(), img, create_graph=True)
    params = [p for p in disc.parameters()]
    wg = torch.autograd.grad(g.square().sum(), params, allow_unused=True)
    wg = {n: to_np(t) for (n, _), t in zip(disc.named_parameters(), wg) if t is not None}
    return to_np(logits), to_np(g), wg


def disc_case(rank, world, img, raw, c):
    """Every discriminator on this rank's rows under a data mesh."""
    mesh = make_mesh(data=world)
    out = {}
    with use_mesh(mesh):
        for name in DISCS:
            out[name] = disc_logits_and_r1(
                name, *(local_rows(torch.from_numpy(v), mesh) for v in (img, raw, c)))
    return out


def toy_decoder(feats, dirs):
    """A decoder with a gradient to every feature: rgb from the planes' mean,
    sigma its sum."""
    m = feats.mean(1)
    return {"rgb": torch.sigmoid(m[..., :3]), "sigma": m.sum(-1, keepdim=True)}


def render_rays_seeded(planes, origins, dirs, options):
    """render_rays with toy_decoder on a seed-7 generator: (rgb, depth,
    weight sum, d(sum rgb^2 + sum depth)/d planes)."""
    from gnerf_tpu_torch.render.renderer import render_rays

    planes = planes.clone().requires_grad_(True)
    rgb, depth, wsum = render_rays(planes, toy_decoder, origins, dirs, options,
                                   torch.Generator().manual_seed(7))
    (gp,) = torch.autograd.grad(rgb.square().sum() + depth.sum(), planes)
    return tuple(to_np(t) for t in (rgb, depth, wsum, gp))


def render_case(rank, world, planes, origins, dirs, options):
    """render_rays on this rank's rows (data=2) and on its half of the rays
    (rays=2, the mesh in the options as `ray_sharding`)."""
    out = {}
    for name, (data, rays) in {"data2": (2, 1), "rays2": (1, 2)}.items():
        mesh = make_mesh(data=data, rays=rays)
        opts = dict(options, ray_sharding=mesh) if rays > 1 else options
        with use_mesh(mesh):
            out[name] = render_rays_seeded(
                *(local_rows(torch.from_numpy(v), mesh) for v in (planes, origins, dirs)), opts)
    return out


# ---------------------------------------------------------------------------
# Train steps


def build_gnerf(spec):
    """The G-NeRF TrainState and TrainConfig the spec describes, on the CPU."""
    from gnerf_tpu_torch.models import Discriminator, ResNeXt50Encoder, TriPlaneGenerator
    from gnerf_tpu_torch.training import losses as L
    from gnerf_tpu_torch.training import train_loop as T

    g = TriPlaneGenerator(**spec["g"], device="cpu")
    enc = ResNeXt50Encoder(**spec["enc"], device="cpu")
    disc = Discriminator(**spec["disc"], device="cpu")
    vgg = L.VGG16LPIPS(**spec["vgg"], device="cpu")
    for module, key in ((g, "g"), (enc, "enc"), (disc, "disc"), (vgg, "vgg")):
        module.load_state_dict(spec["state"][key])
    cfg = T.TrainConfig(**spec["cfg"])
    return T.init_train_state(g, enc, disc, vgg, cfg), cfg


def build_eg3d(spec):
    """The EG3DState and EG3DLossConfig the spec describes, on the CPU."""
    from gnerf_tpu_torch.models import DualDiscriminator, TriPlaneGenerator
    from gnerf_tpu_torch.training import eg3d_loss as E

    g = TriPlaneGenerator(**spec["g"], device="cpu")
    d = DualDiscriminator(**spec["disc"], device="cpu")
    g.load_state_dict(spec["state"]["g"])
    d.load_state_dict(spec["state"]["disc"])
    cfg = E.EG3DLossConfig(**spec["cfg"])
    return E.init_eg3d_state(g, d, cfg, lazy=spec["lazy"]), cfg


def state_snapshot(state) -> dict:
    """The modules' state_dicts, and by module and parameter name every
    optimizer's first moment (its record of the gradients) and the step
    Adam last took."""
    out = {}
    for name in ("g", "g_ema", "enc", "disc"):
        module = getattr(state, name, None)
        if module is not None:
            out[name] = {k: to_np(v) for k, v in module.state_dict().items()}
    for name in ("g", "enc", "disc"):
        module = getattr(state, name, None)
        if module is None:
            continue
        for opt_name in ("opt_g", "opt_d"):
            opt = getattr(state, opt_name, None)
            if opt is None:
                continue
            group = opt.param_groups[0]
            (b1, b2), lr, eps = group["betas"], group["lr"], group["eps"]
            for pn, p in module.named_parameters():
                if p in opt.state:
                    st = opt.state[p]
                    t = float(st["step"])
                    m, v = to_np(st["exp_avg"]), to_np(st["exp_avg_sq"])
                    out.setdefault("exp_avg", {})[f"{name}.{pn}"] = m
                    out.setdefault("update", {})[f"{name}.{pn}"] = (
                        lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps))
    return out


def named_state(state):
    return [(f"{name}.{k}", v) for name in ("g", "g_ema", "enc", "disc")
            if getattr(state, name, None) is not None
            for k, v in getattr(state, name).state_dict().items()]


def _result(rank, state, stats, mesh):
    """rank 0's snapshot, every rank's stats, and whether the ranks agree."""
    return dict(snapshot=state_snapshot(state) if rank == 0 else None,
                stats={k: float(v) for k, v in stats.items()},
                consistent=check_replica_consistency(named_state(state), mesh.group),
                cur_nimg=state.cur_nimg)


def gnerf_case(rank, world, spec_path, batch, scenarios):
    """One G-NeRF step per scenario {name: (data, rays, seeded)}, each from
    the spec's state, on this rank's rows of the global batch; seeded steps
    take step_generator(0, 0)."""
    from gnerf_tpu_torch.training import train_loop as T
    from gnerf_tpu_torch.training.train import step_generator

    spec = torch.load(spec_path, weights_only=False)
    out = {}
    for name, (data, rays, seeded) in scenarios.items():
        state, cfg = build_gnerf(spec)
        mesh = make_mesh(data=data, rays=rays)
        step = T.make_train_step(cfg, mesh=mesh)
        local = {k: local_rows(torch.from_numpy(np.asarray(v)), mesh) for k, v in batch.items()}
        _, stats = step(state, local, step_generator(0, 0, "cpu") if seeded else None)
        out[name] = _result(rank, state, stats, mesh)
    return out


def eg3d_case(rank, world, spec_path, batch, scenarios, density_points=None):
    """EG3D phases per scenario {name: (data, rays, phases, seeded, aug_p)},
    each from the spec's state; phases is a string of 'm' (Gmain + Dmain),
    'g' (Greg) and 'd' (Dreg), run in order at the blur of the spec's
    schedule. Greg takes this rank's rows of `density_points` (coords,
    dirs) when given. Returns the result after every phase."""
    from gnerf_tpu_torch.training import eg3d_loss as E

    spec = torch.load(spec_path, weights_only=False)
    out = {}
    for name, (data, rays, phases, seeded, aug_p) in scenarios.items():
        state, cfg = build_eg3d(spec)
        mesh = make_mesh(data=data, rays=rays)
        main, greg, dreg = E.make_eg3d_phase_steps(cfg, mesh=mesh)
        local = {k: local_rows(torch.from_numpy(np.asarray(v)), mesh) for k, v in batch.items()}
        if density_points is not None:
            pts = tuple(local_rows(torch.from_numpy(p), mesh) for p in density_points)
            E.density_reg_points = lambda n, cfg, rng, device: pts
        out[name] = [_result(rank, state, stats, mesh) for stats in
                     run_eg3d_phases(state, cfg, (main, greg, dreg), local, phases, seeded,
                                     aug_p)]
    return out


def run_eg3d_phases(state, cfg, steps, batch, phases, seeded, aug_p):
    """Yields the stats of each phase of `phases` in turn (see eg3d_case),
    the blur at the schedule's value for the state's cur_nimg; a seeded
    phase i draws from step_generator(0, 0, phase=i)."""
    from gnerf_tpu_torch.training import eg3d_loss as E
    from gnerf_tpu_torch.training.train import step_generator

    main, greg, dreg = steps
    for i, phase in enumerate(phases):
        rng = step_generator(0, 0, "cpu", phase=i) if seeded else None
        sigma = E.blur_sigma_schedule(state.cur_nimg, cfg)
        size = E.blur_kernel_size(sigma)
        if phase == "m":
            _, stats = main(state, batch, rng, sigma, aug_p, blur_size=size, res=8)
        elif phase == "g":
            _, stats = greg(state, batch, rng)
        else:
            _, stats = dreg(state, batch, rng, sigma, aug_p, blur_size=size, res=8)
        yield stats


# ---------------------------------------------------------------------------
# The CLI


def shrink_networks():
    """The CLI's networks at the tests' tiny widths, as
    tests/test_torch_train_cli.py's `tiny_networks` fixture makes them."""
    import gnerf_tpu_torch.models as models
    from gnerf_tpu_torch.training import losses

    def shrink(cls, **small):
        return lambda *a, **kw: cls(*a, **{**kw, **small})

    models.TriPlaneGenerator = shrink(models.TriPlaneGenerator, plane_resolution=16,
                                      channel_base=512, channel_max=32)
    models.ResNeXt50Encoder = shrink(models.ResNeXt50Encoder, layers=(1, 1, 1, 1))
    models.Discriminator = shrink(models.Discriminator, channel_base=256, channel_max=32)
    models.DualDiscriminator = shrink(models.DualDiscriminator, channel_base=256,
                                      channel_max=32)
    losses.VGG16LPIPS = shrink(losses.VGG16LPIPS, resize_to=32)


def cli_case(rank, world, runs):
    """run_training for each kwargs of `runs` in turn, on every rank (the
    process group comes up through init_distributed, from torchrun's
    environment); returns what each call returned on this rank."""
    from gnerf_tpu_torch.parallel import init_distributed
    from gnerf_tpu_torch.training.train import run_training

    shrink_networks()
    assert init_distributed("cpu") and dist.get_backend() == "gloo"
    return [run_training(**kw) for kw in runs]
