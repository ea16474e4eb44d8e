"""The port's distributed substrate (gnerf_tpu_torch.parallel) on gloo ranks
on the CPU: the counterparts of tests/test_parallel.py's mesh, pmean_grads,
replica-check and init tests, the autograd collectives' first and second
derivatives against a single-process computation, and each rank's part of
a random draw. Every multi-process run has its own timeout
(tests/_torch_dist.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import _torch_ddp_workers as W
from _torch_dist import run_ranks
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu_torch.utils import prng
from gnerf_tpu.parallel import DATA_AXIS, make_mesh as jax_make_mesh, pmean_grads as jax_pmean

WORLD = 4


def test_mesh_layout_matches_jax():
    """Rank d * rays + r holds data shard d and ray shard r, as JAX's
    reshape(data, rays) lays out devices; data=None takes the rest; a mesh
    that does not cover the world raises JAX's message."""
    results = run_ranks(W.mesh_case, WORLD, timeout=300)
    for name, (data, rays) in {"2x2": (2, 2), "rays2": (2, 2), "4x1": (4, 1),
                               "1x4": (1, 4)}.items():
        grid = np.asarray(jax_make_mesh(data=data, rays=rays,
                                        devices=jax.devices()[:WORLD]).devices)
        ids = np.vectorize(lambda d: d.id)(grid) - min(d.id for d in jax.devices()[:WORLD])
        for rank, res in enumerate(results):
            got = res[name]
            d, r = divmod(rank, rays)
            assert (got["data"], got["rays"], got["data_rank"], got["ray_rank"]) == \
                (data, rays, d, r), (name, rank, got)
            assert ids[d, r] == rank
            assert got["data_group"] == ids[:, r].tolist(), (name, rank)
            assert got["ray_group"] == ids[d, :].tolist(), (name, rank)
    for res in results:
        assert res["errors"] == {"3x1": "mesh 3x1 != 4 devices",
                                 "rays3": "4 devices not divisible by rays=3"}


def test_init_distributed_off_by_default(monkeypatch):
    """init_distributed is a no-op (returns False) without torchrun's
    WORLD_SIZE or GNERF_DISTRIBUTED; process_info reports (0, 1) and the
    single-process mesh is None (no collective to make)."""
    from gnerf_tpu_torch.parallel import init_distributed, make_mesh, process_info

    monkeypatch.delenv("GNERF_DISTRIBUTED", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert process_info() == (0, 1)
    assert make_mesh() is None and make_mesh(data=1, rays=1) is None
    with pytest.raises(AssertionError, match="mesh 2x1 != 1 devices"):
        make_mesh(data=2)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed("cpu") is False


def _pmean_inputs():
    rs = np.random.RandomState(0)
    grads = [[rs.randn(3, 2).astype(np.float32), None, rs.randn(5).astype(np.float32)]
             for _ in range(WORLD)]
    grads[0][0][0, 0] = np.nan
    grads[1][0][0, 1] = np.inf
    grads[2][2][4] = -np.inf
    grads[3][2][3] = np.nan
    grads[1][2][3] = np.inf
    return grads


def test_pmean_grads_order_matches_jax():
    """The mean comes before the scrub: a NaN or Inf on one rank decides
    that element on every rank, as JAX's pmean then nan_to_num does (here
    inside shard_map on a 4-device mesh). None gradients stay None."""
    grads = _pmean_inputs()
    results = run_ranks(W.pmean_case, WORLD, grads, timeout=300)
    mesh = jax_make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    for j in (0, 2):
        stacked = jnp.asarray(np.stack([g[j] for g in grads]))
        want = jax.shard_map(lambda x: jax_pmean({"g": x}, DATA_AXIS)["g"], mesh=mesh,
                             in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS))(stacked)
        for rank, got in enumerate(results):
            assert got[1] is None
            np.testing.assert_allclose(got[j], np.asarray(want)[rank], rtol=1e-6, atol=0)
    assert results[0][0][0, 0] == 0 and results[0][0][0, 1] == 1e5
    assert results[0][2][3] == 0 and results[0][2][4] == -1e5


def test_psum_moments_sums_the_ranks_triples():
    """[n, sum, sum_sq] triples add up over the ranks (training-stats sync)."""
    vals = np.concatenate([np.arange(3.0) + r for r in range(WORLD)])
    want = [vals.size, vals.sum(), np.square(vals).sum()]
    for got in run_ranks(W.moments_case, WORLD, timeout=300):
        np.testing.assert_array_equal(got, want)


def test_replica_consistency_check():
    """True while every rank holds the same tensors; once one rank changes
    one, every rank raises naming it."""
    for first, second in run_ranks(W.replica_case, WORLD, timeout=300):
        assert first is True
        assert second == "replica divergence at b"


def _collective_inputs():
    rs = np.random.RandomState(1)
    out = {}
    for name in W.collective_fns(None):
        xs = [rs.randn(2, 3) for _ in range(WORLD)]
        y_shape = {"all_gather_dim0": (2 * WORLD, 3),
                   "all_gather_dim1": (2, 3 * WORLD)}.get(name, (2, 3))
        out[name] = (xs, [rs.randn(*y_shape) for _ in range(WORLD)],
                     [rs.randn(2, 3) for _ in range(WORLD)])
    return out


@pytest.fixture(scope="module")
def collectives():
    inputs = _collective_inputs()
    return inputs, run_ranks(W.collectives_case, WORLD, inputs, timeout=300)


@pytest.mark.parametrize("name", list(W.collective_fns(None)))
def test_autograd_collective_matches_single_process(collectives, name):
    """On 4 ranks, each rank's value, first derivative (with a graph) and
    the second derivatives through it equal those of one process that sums
    the ranks' losses: loss_r = sum(sin(y_r) a_r), y_r the collective of
    the x's, g_r = d(sum of losses)/dx_r, h = sum_r sum(g_r^2 b_r)."""
    inputs, results = collectives
    xs, as_, bs = inputs[name]
    _, plain = W.collective_fns(None)[name]
    x = [torch.tensor(v, requires_grad=True) for v in xs]
    a = [torch.tensor(v, requires_grad=True) for v in as_]
    ys = [plain(x, r) for r in range(WORLD)]
    loss = sum((torch.sin(y) * ar).sum() for y, ar in zip(ys, a))
    g = torch.autograd.grad(loss, x, create_graph=True)
    h = sum((gr.square() * torch.tensor(br)).sum() for gr, br in zip(g, bs))
    gx = torch.autograd.grad(h, x + a)
    for r, (y_got, g_got, gx_got, ga_got) in enumerate(res[name] for res in results):
        np.testing.assert_allclose(y_got, W.to_np(ys[r]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g_got, W.to_np(g[r]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(gx_got, W.to_np(gx[r]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(ga_got, W.to_np(gx[WORLD + r]), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("data,rays", [(4, 1), (2, 2), (1, 4)])
def test_draw_is_the_ranks_part_of_the_world1_draw(data, rays):
    """Under a (data, rays) mesh each rank's draw is its rows (and rays) of
    the draw one process makes for the global batch, in the same order; its
    rows of a global tensor are rows d*n ... (d+1)*n - 1."""
    rows = prng.normal(prng.PRNGKey(5), (8, 3))
    rows_rays = prng.uniform(prng.PRNGKey(6), (8, 8, 4))
    n, k = 8 // data, 8 // rays
    for rank, (got_rows, got_rays, got_local) in enumerate(
            run_ranks(W.draw_case, WORLD, data, rays, timeout=300)):
        d, r = divmod(rank, rays)
        np.testing.assert_array_equal(got_rows, W.to_np(rows[d * n:(d + 1) * n]))
        np.testing.assert_array_equal(got_rays, W.to_np(rows_rays[d * n:(d + 1) * n,
                                                                  r * k:(r + 1) * k]))
        np.testing.assert_array_equal(got_local, np.arange(8.0)[d * n:(d + 1) * n])


@pytest.mark.parametrize("data,rays,rank", [(2, 1, 0), (2, 1, 1), (1, 2, 0), (1, 2, 1)])
def test_draw_computes_only_the_ranks_counters(monkeypatch, data, rays, rank):
    """At data=2 and at rays=2 `draw` runs threefry on this rank's counters
    alone (its rows, its rays) and gives the world-1 draw's block bit for
    bit."""
    from gnerf_tpu_torch.ops import threefry as T
    from gnerf_tpu_torch.parallel.mesh import Mesh, use_mesh
    from gnerf_tpu_torch.parallel.sharding import draw

    mesh = Mesh(data=data, rays=rays, data_rank=rank if data > 1 else 0,
                ray_rank=rank if rays > 1 else 0, data_group=None, ray_group=None, group=None)
    sizes = []
    threefry = T.threefry2x32

    def counting(key, x0, x1):
        sizes.append(x0.numel())
        return threefry(key, x0, x1)

    monkeypatch.setattr(T, "threefry2x32", counting)
    key = prng.PRNGKey(9)
    n, k = 8 // data, 6 // rays
    with use_mesh(mesh):
        got = draw(prng.uniform, key, (n, k, 5), ray_mesh=mesh, ray_dim=1)
    assert sizes == [n * k * 5]
    whole = prng.uniform(key, (8, 6, 5))
    d, r = mesh.data_rank, mesh.ray_rank
    assert torch.equal(got, whole[d * n:(d + 1) * n, r * k:(r + 1) * k])
