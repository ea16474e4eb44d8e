"""The threefry kernel's host plan (`gnerf_tpu_torch/ops/threefry.py`),
emulated in numpy as `csrc/threefry.cu` computes with it: the collapsed
geometry and multiply-high divisors give the flat counters of every draw
and block, the table's block prefix maps every block to its entry and every
value to one thread, a packed table read back and run through threefry in
numpy gives the single draws, and the batched draws on the CPU
(`threefry_draws`, `prng.draw_many`, `sharding.draw_many`, the ADA pipe's
draw plan, a synthesis network's noise) equal the single ones. No JAX: the
single draws are held to `jax.random` by test_torch_prng.py and
test_torch_draws.py, and the kernel itself runs on the card
(test_torch_threefry.py, chip_smoke.py)."""

import math

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu_torch.ops import threefry as T
from gnerf_tpu_torch.utils import prng

U64 = np.uint64
M32 = U64(0xFFFFFFFF)


def _divide(j: np.ndarray, d: int) -> np.ndarray:
    """j // d as the kernel computes it in 32-bit words (j uint64 < 2^32)."""
    magic, shift = T.divisor(d)
    t = (j * U64(magic)) >> U64(32)
    return ((t + ((j - t) >> U64(1))) & M32) >> U64(shift)


def _kernel_counters(shape, part, j: np.ndarray) -> np.ndarray:
    """The 32-bit instance's counter of each block value j (`counter` in
    csrc/threefry.cu): base + the strided coordinates, every word wrapping
    at 2^32."""
    base, sizes, strides = T.geometry(shape, part)
    i, q = np.full(j.shape, base, U64), j.astype(U64)
    for d in range(len(sizes) - 1, 0, -1):
        qq = _divide(q, sizes[d])
        i = (i + ((q - qq * U64(sizes[d])) & M32) * U64(strides[d])) & M32
        q = qq
    return (i + q * U64(strides[0])) & M32


def _flat_counters(shape, part, j: np.ndarray) -> np.ndarray:
    """The flat index in the whole draw of each block value j, from its
    coordinates in the block (Python integers, no wrapping)."""
    sizes = T.block_shape(shape, part)
    coords = np.unravel_index(j, sizes)
    out = np.zeros(j.shape, object)
    stride = 1
    for d in reversed(range(len(shape))):
        start = (part or {}).get(d, (0, 0))[0]
        out = out + (coords[d].astype(object) + start) * stride
        stride *= shape[d]
    return out.astype(U64)


def _random_cases(seed: int, count: int):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        shape = tuple(int(s) for s in rng.choice([1, 2, 3, 5, 7, 13, 31], rng.integers(1, 6)))
        part = {}
        for d in range(len(shape)):
            if rng.random() < 0.5:
                start = int(rng.integers(0, shape[d]))
                part[d] = (start, int(rng.integers(1, shape[d] - start + 1)))
        yield shape, part or None


SMALL = list(_random_cases(0, 60)) + [
    ((1,), None), ((4, 1, 512, 512), {0: (2, 2)}), ((4, 4096, 48, 1), {1: (2048, 2048)}),
    ((8, 4096, 48, 1), {0: (2, 2), 1: (2048, 2048)}), ((65537,), None),
    ((3, 65537), {1: (5, 65530)}), ((65537, 3), {0: (2, 7)}), ((7, 11, 13), {1: (3, 1)}),
    ((3,) * 8, {1: (0, 2), 3: (1, 2), 5: (0, 2)}),
]
# Totals near 2^32: sampled values, the block's first and last among them.
LARGE = [((65536, 65535), {0: (65000, 536)}), ((65536, 65535), {1: (1, 65533)}),
         ((65537, 65535), {0: (0, 65536)}), (((1 << 32) - 1,), {0: ((1 << 32) - 6, 5)}),
         ((1 << 32,), {0: ((1 << 32) - 1, 1)}), ((4, 1073741823), {0: (3, 1), 1: (7, 1 << 29)}),
         ((2, 3, (1 << 31) // 3), {0: (1, 1)}), ((65535, 65537), None)]


@pytest.mark.parametrize("shape,part", SMALL + LARGE, ids=str)
def test_geometry_and_divisors_give_the_flat_counters(shape, part):
    """The 32-bit instance's counters, from the collapsed geometry and the
    magic divisors, equal `counters` (all of a small block) or the flat
    index from the block's coordinates (sampled for totals near 2^32)."""
    plan = T.plan_of(shape, part)
    assert not plan.wide and plan.shape == T.block_shape(shape, part)
    _, sizes, _ = T.geometry(shape, part)
    assert len(sizes) <= 4 and all(s >= 2 for s in sizes[1:])
    if plan.n <= 1 << 18:
        j = np.arange(plan.n, dtype=U64)
        hi, lo = T.counters(shape, part, "cpu")
        want = ((hi << 32) | lo).numpy().astype(U64)
    else:
        rng = np.random.default_rng(1)
        j = np.concatenate([[0, 1, plan.n - 2, plan.n - 1],
                            rng.integers(0, plan.n, 4096)]).astype(U64)
        want = _flat_counters(shape, part, j)
    np.testing.assert_array_equal(_kernel_counters(shape, part, j), want)


def test_blocks_collapse_to_one_offset_or_two_dimensions():
    """A data-rank block is one offset plus j, a ray-rank block two
    dimensions, a fold_in's one counter at 2^32 - 1 the 32-bit entry; past
    32-bit counters, or 5 dimensions after merging, the 64-bit one."""
    assert T.geometry((4, 1, 512, 512), {0: (2, 2)}) == (2 * 512 * 512, (2 * 512 * 512,), (1,))
    assert T.geometry((4, 8192, 48, 1), {1: (4096, 4096)}) == (4096 * 48, (4, 4096 * 48),
                                                               (8192 * 48, 1))
    assert T.geometry((1 << 32,), {0: ((1 << 32) - 1, 1)}) == ((1 << 32) - 1, (1,), (1,))
    assert not T.plan_of((1 << 32,), {0: ((1 << 32) - 1, 1)}).wide
    assert T.plan_of((1 << 33,), {0: (1 << 32, 8)}).wide
    assert T.plan_of(((1 << 32) + 3,), None).wide
    assert T.plan_of((3,) * 8, {1: (0, 2), 3: (0, 2), 5: (0, 2), 7: (0, 2)}).wide
    assert T.plan_of((2, 0, 3), None).n == 0


def test_divisor_is_exact_over_32_bits():
    rng = np.random.default_rng(2)
    ds = [2, 3, 7, 48, 1 << 16, (1 << 16) + 1, 196608, (1 << 31) - 1, 1 << 31,
          (1 << 32) - 1] + [int(d) for d in rng.integers(2, 1 << 32, 200, dtype=np.int64)]
    j = np.concatenate([[0, 1, (1 << 32) - 2, (1 << 32) - 1],
                        rng.integers(0, 1 << 32, 2000, dtype=np.int64)]).astype(U64)
    for d in ds:
        edges = np.array([d - 1, d, d + 1, 2 * d - 1, ((1 << 32) - 1) // d * d], U64) & M32
        jj = np.concatenate([j, edges])
        np.testing.assert_array_equal(_divide(jj, d), jj // U64(d), err_msg=f"d={d}")
    with pytest.raises(ValueError):
        T.divisor(1)


@pytest.mark.parametrize("counts", [[1], [5003], [(1 << 24) + 3], [4] * 32, [786432, 1, 7],
                                    list(np.random.default_rng(3).integers(1, 70000, 32))],
                         ids=lambda c: f"{len(c)} entries")
def test_block_prefix_maps_every_block_and_value(counts):
    """Each block finds its entry by the kernel's scan of the prefix, and
    the entry's grid-stride loop over 4-value quads gives every value to
    exactly one thread."""
    counts = [int(n) for n in counts]
    first = T.block_prefix(counts)
    blocks = np.arange(first[-1])
    found = np.zeros_like(blocks)
    for k in range(1, len(counts)):  # while k + 1 < count and b >= first[k + 1]: ++k
        found += blocks >= first[k]
    for k, n in enumerate(counts):
        mine = blocks[found == k]
        assert mine.tolist() == list(range(first[k], first[k + 1]))
        nb = first[k + 1] - first[k]
        assert 1 <= nb <= T.WAVE
        quads = -(-n // T.VALUES)
        step = nb * T.THREADS
        q = np.arange(step)[None, :] + step * np.arange(-(-quads // step))[:, None]
        q = q[q < quads]
        assert np.array_equal(np.sort(q), np.arange(quads))
        values = (q[:, None] * T.VALUES + np.arange(T.VALUES)).ravel()
        assert np.array_equal(np.sort(values[values < n]), np.arange(n))


def _run_table(blob: bytes, wide: bool, outs: dict) -> list:
    """Reads a packed table as the kernel does and computes each entry's
    values with threefry in numpy: [(out pointer, values)]."""
    head = T._TABLE_HEAD[wide]
    count, *first = head.unpack_from(blob)
    assert first[0] == 0 and first[count] == T.block_prefix(
        [outs[i][1] for i in range(count)])[-1]
    size = T._HEAD.size + (T._WIDE if wide else T._NARROW).size
    assert len(blob) == head.size + count * size
    got = []
    for k in range(count):
        at = head.size + k * size
        out, key_ptr, k0, k1, lo, span, kind = T._HEAD.unpack_from(blob, at)
        fields = (T._WIDE if wide else T._NARROW).unpack_from(blob, at + T._HEAD.size)
        dims = 8 if wide else 4
        ndim, n, base = fields[:3]
        sizes, strides = fields[3:3 + ndim], fields[3 + dims:3 + dims + ndim]
        magic = fields[3 + 2 * dims:3 + 2 * dims + ndim]
        shift = fields[3 + 3 * dims:3 + 3 * dims + ndim]
        assert key_ptr == 0
        if not wide:
            assert [(m, s) for m, s in zip(magic[1:], shift[1:])] == [
                T.divisor(s) for s in sizes[1:]]
        j = np.arange(n, dtype=object)
        i = np.full(n, base, object)
        for d in range(ndim - 1, 0, -1):
            i, j = i + (j % sizes[d]) * strides[d], j // sizes[d]
        i = (i + j * strides[0]).astype(U64)
        x0, x1 = T._threefry_np(k0, k1, (i >> U64(32)).astype(np.uint32),
                                (i & M32).astype(np.uint32))
        if kind == T.KINDS["pairs"]:
            vals = torch.from_numpy(np.stack([x0, x1], -1).view(np.int32))
        else:
            words = torch.from_numpy((x0 ^ x1).astype(np.int64))
            vals = T._to_int32(words)
            if kind != T.KINDS["bits"]:
                vals = T._uniform_floats(vals, lo, span)
                if kind == T.KINDS["normal"]:
                    vals = math.sqrt(2) * T._erfinv(vals)
        got.append((out, vals))
    return got


def test_packed_table_computes_the_single_draws():
    """Entries packed as the kernel reads them (head, geometry, divisors,
    the prefix), run through threefry in numpy, give the single draws; the
    layout is csrc/threefry.cu's (112-byte narrow and 248-byte wide
    entries after a 136- or 16-byte head)."""
    assert T._HEAD.size + T._NARROW.size == 112 and T._HEAD.size + T._WIDE.size == 248
    assert T._TABLE_HEAD[False].size == 136 and T._TABLE_HEAD[True].size == 16
    key = prng.fold_in(prng.PRNGKey(7), 3)
    cases = [("uniform", (4, 3, 5), {1: (1, 2)}, -0.5, 2.0), ("normal", (6, 1, 8, 8), {0: (3, 3)}),
             ("bits", (5003,), None), ("pairs", (9,), {0: (2, 5)}),
             ("normal", (4, 40, 6, 1), {1: (20, 20)}), ("uniform", (3, 3, 3, 3, 3),
                                                        {1: (1, 1), 3: (0, 2)})]
    for wide in (False, True):
        entries, outs, keep = [], {}, []
        for k, (kind, shape, part, *bounds) in enumerate(cases):
            plan = T.plan_of(shape, part)
            full, dtype = T._out_spec(plan, kind)
            out = torch.empty(full, dtype=dtype)
            lo, span = T._bounds(kind, *(bounds or (0.0, 1.0)))
            if wide:  # the 64-bit entry's layout, with the same geometry
                plan = plan._replace(wide=True, geometry=_wide_geometry(shape, part))
            entries.append((T.entry(plan, key, kind, lo, span, out, "cpu", keep), plan.n))
            want = T.threefry_draw(key, shape, part, "cpu", kind, *(bounds or (0.0, 1.0)))
            outs[k] = (out.data_ptr(), plan.n, want)
        for blob_entries in ([entries[:1]] if wide else [entries, entries[:1]]):
            got = _run_table(T.table(blob_entries, wide), wide, outs)
            for k, (ptr, vals) in enumerate(got):
                assert ptr == outs[k][0]
                want = outs[k][2].reshape(vals.shape)
                if vals.dtype == torch.float32:
                    torch.testing.assert_close(vals, want, rtol=0, atol=0)
                else:
                    assert torch.equal(vals, want)
    with pytest.raises(ValueError):
        T.table(entries * 6, False)  # 36 > 32 entries


def _wide_geometry(shape, part) -> bytes:
    base, sizes, strides = T.geometry(shape, part)
    pad = [0] * (8 - len(sizes))
    return T._WIDE.pack(len(sizes), math.prod(T.block_shape(shape, part)), base, *sizes, *pad,
                        *strides, *pad, *[0] * 16)


def test_threefry_draws_equal_single_draws_on_the_cpu():
    """`threefry_draws` and `prng.draw_many` on the CPU are the single draws
    entry for entry (keys split on the host, parts, every kind); on meta
    their shapes."""
    keys = prng.split(prng.PRNGKey(11), 6)
    draws = [(keys[0], (4, 3), None, "uniform", -1.0, 3.0), (keys[1], (6, 1, 4, 4),
                                                             {0: (3, 3)}, "normal", 0.0, 1.0),
             (keys[2], (5003,), None, "bits", 0.0, 1.0), (keys[3], (7,), {0: (2, 4)}, "pairs",
                                                          0.0, 1.0),
             (keys[4], (0, 3), None, "uniform", 0.0, 1.0), (keys[5], (4, 40, 6, 1),
                                                            {1: (20, 20)}, "uniform", 0.0, 1.0)]
    got = T.threefry_draws(draws, "cpu")
    for d, g in zip(draws, got):
        key, shape, part, kind, lo, hi = d
        assert torch.equal(g, T.threefry_draw(key, shape, part, "cpu", kind, lo, hi))
    meta = T.threefry_draws(draws, "meta")
    assert [m.shape for m in meta] == [g.shape for g in got]
    many = prng.draw_many([prng.Draw("uniform", keys[0], (4, 3), -1.0, 3.0),
                           prng.Draw("normal", keys[1], (6, 1, 4, 4), part={0: (3, 3)}),
                           prng.Draw("bits", keys[2], 5003)])
    assert torch.equal(many[0], prng.uniform(keys[0], (4, 3), -1.0, 3.0))
    assert torch.equal(many[1], prng.normal(keys[1], (6, 1, 4, 4), part={0: (3, 3)}))
    assert torch.equal(many[2], prng.bits(keys[2], 5003))
    assert prng.draw_many([]) == []


@pytest.mark.parametrize("rank", [0, 1])
def test_sharding_draw_many_takes_each_ranks_rows(rank):
    """Under a data=2 mesh each draw of `sharding.draw_many` is this rank's
    rows of the global draw, as `sharding.draw` gives them."""
    from gnerf_tpu_torch.parallel.mesh import Mesh, use_mesh
    from gnerf_tpu_torch.parallel.sharding import draw, draw_many

    mesh = Mesh(data=2, rays=1, data_rank=rank, ray_rank=0, data_group=None, ray_group=None,
                group=None)
    keys = prng.split(prng.PRNGKey(4), 3)
    with use_mesh(mesh):
        got = draw_many([prng.Draw("uniform", keys[0], (2,)),
                         prng.Draw("normal", keys[1], (2, 1, 8, 8)),
                         prng.Draw("uniform", keys[2], (2, 2), 0.5, 1.5)])
        want = [draw(prng.uniform, keys[0], (2,)), draw(prng.normal, keys[1], (2, 1, 8, 8)),
                draw(prng.uniform, keys[2], (2, 2), minval=0.5, maxval=1.5)]
    whole = prng.normal(keys[1], (4, 1, 8, 8))
    assert torch.equal(got[1], whole[2 * rank:2 * rank + 2])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ada_draw_plan_matches_the_keys_the_pipe_takes():
    """The bgc pipe's plan is 26 draws (one launch); with every
    augmentation on, the plan fills the 32 split keys, and a pipe call
    takes exactly the plan's draws in order (`take` checks each)."""
    from gnerf_tpu_torch.training.augment import AugmentPipe
    from gnerf_tpu_torch.training.eg3d_loss import BGC_SPEC

    bgc = AugmentPipe(**BGC_SPEC)._draw_plan(3)
    assert len(bgc) == 26 and all(kind for kind, _ in bgc)
    assert len(AugmentPipe(**BGC_SPEC)._draw_plan(1)) == 22
    every = dict(BGC_SPEC, imgfilter=1.0, noise=1.0, cutout=1.0)
    pipe = AugmentPipe(**every)
    assert len(pipe._draw_plan(3)) == 32
    images = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 3, 8, 8),
                                                                      np.float32))
    before = T.threefry_draw.launches
    out = pipe(prng.PRNGKey(3), images, p=1.0)
    assert out.shape == images.shape and torch.isfinite(out).all()
    assert T.threefry_draw.launches == before  # the CPU takes the plain version


def test_synthesis_noise_equals_each_layers_draw():
    """`draw_noise` draws what each layer drew alone: block i's key is
    split(rng)[i], conv0 takes split(key)[0] and conv1 split(key)[1] (the
    4x4 block's conv1 split(key)[0])."""
    from gnerf_tpu_torch.models.stylegan2 import SynthesisNetwork, draw_noise

    net = SynthesisNetwork(w_dim=8, img_resolution=16, img_channels=3, channel_base=64,
                           channel_max=4, key=prng.PRNGKey(1))
    blocks = [getattr(net, f"b{r}") for r in net.block_resolutions]
    rng = prng.PRNGKey(9)
    noises = draw_noise(blocks, rng, 3, "cpu")
    for block, key, noise in zip(blocks, prng.split(rng, len(blocks)), noises):
        k0, k1 = prng.split(key)
        names = {"conv1": k0} if block.in_channels == 0 else {"conv0": k0, "conv1": k1}
        assert set(noise) == set(names)
        for name, k in names.items():
            r = getattr(block, name).resolution
            assert torch.equal(noise[name], prng.normal(k, (3, 1, r, r)))
    assert draw_noise(blocks, None, 3, "cpu") == [None] * len(blocks)
