"""`gnerf_tpu_torch.utils.prng` vs `jax.random` (threefry2x32, partitionable):
keys, splits, folds, bits, uniform and randint draws bit for bit; normal
draws within 1e-6 absolute (XLA's erfinv polynomial, whose log1p may differ
from torch's in the last place); a block of a draw (`part`) is the whole
draw's block."""

import numpy as np
import pytest
import torch

import jax

from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu_torch.utils import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1]
# Seeds outside 0..2^31-1 that PRNGKey accepts: cut to their low 32 bits.
EDGE_SEEDS = [-1, -2 ** 31, 2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 63 - 1, -2 ** 63,
              np.int64(2 ** 33), np.uint32(2 ** 32 - 1), np.int32(-5), True]
SHAPES = [(), (0,), (1,), (7,), (5, 3), (2, 3, 5), (70001,), (257, 300)]


def _np(key_or_words):
    return np.asarray(key_or_words).astype(np.int64)


def test_jax_is_partitionable_threefry():
    """The stream this module reproduces."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS + EDGE_SEEDS, ids=repr)
def test_prngkey_matches_jax(seed):
    got = prng.PRNGKey(seed)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), _np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [2 ** 63, -2 ** 63 - 1, 2 ** 64, 1.5, "3", None])
def test_prngkey_refuses_what_jax_refuses(seed):
    with pytest.raises(Exception) as want:
        jax.random.PRNGKey(seed)
    with pytest.raises(type(want.value)):
        prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    for n in (*range(1, 6), 8, 9, 32):
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), n).numpy(),
                                      _np(jax.random.split(jax.random.PRNGKey(seed), n)))
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed)).numpy(),
                                  _np(jax.random.split(jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 - 1])
def test_fold_in_matches_jax(seed, data):
    np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(seed), data).numpy(),
                                  _np(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


def test_chained_keys_match_jax():
    """Keys of keys: split, fold_in and a split of a split row."""
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    for i in range(4):
        jk = jax.random.split(jax.random.fold_in(jk, i), 3)[i % 3]
        tk = prng.split(prng.fold_in(tk, i), 3)[i % 3]
        np.testing.assert_array_equal(tk.numpy(), _np(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_match_jax(seed, shape):
    got = prng.bits(prng.PRNGKey(seed), shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), _np(jax.random.bits(jax.random.PRNGKey(seed),
                                                                   shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 2.5), (-0.011048543, 0.011048543),
                                   (3.0, 3.5)])
def test_uniform_matches_jax_bitwise(seed, shape, lo, hi):
    got = prng.uniform(prng.PRNGKey(seed), shape, lo, hi)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo, maxval=hi))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_matches_jax(seed, shape):
    got = prng.normal(prng.PRNGKey(seed), shape)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_normal_tails_match_jax():
    """Half a million draws reach |z| > 4.5, the erfinv's w >= 5 branch."""
    got = prng.normal(prng.PRNGKey(3), (512000,)).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (512000,)))
    assert np.abs(want).max() > 4.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_meta_key_draws_shapes_only():
    key = prng.PRNGKey(0, device="meta")
    for fn in (prng.normal, prng.uniform, prng.bits):
        out = fn(key, (3, 4))
        assert out.is_meta and tuple(out.shape) == (3, 4)
    assert prng.split(key, 3).is_meta


# randint bounds: spans of 1 (equal and reversed bounds), negative bounds,
# the full int32 range, numpy bounds past int32 (int64 wraps to int32,
# uint32 past int32 max takes one more), a span that wraps to 0, and the
# EG3D style-mixing cutoff (1, num_ws).
RANDINT_BOUNDS = [(0, 1), (5, 5), (5, 3), (-10, 10), (-7, -2), (-2 ** 31, 2 ** 31 - 1),
                  (np.int64(-2 ** 40), np.int64(2 ** 40 + 9)), (np.int64(3), np.int64(2 ** 33)),
                  (np.uint32(3), np.uint32(2 ** 32 - 1)), (-2 ** 31, np.uint32(2 ** 32 - 1)),
                  (np.int16(-5), np.int16(300)), (1, 14), (1, 18)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", RANDINT_BOUNDS, ids=repr)
@pytest.mark.parametrize("shape", [(), (1,), (7, 3), (5003,)], ids=str)
def test_randint_matches_jax_bitwise(seed, lo, hi, shape):
    got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31), (-2 ** 31 - 1, 0), (0, 2 ** 40)])
def test_randint_refuses_python_bounds_past_int32_as_jax_does(lo, hi):
    with pytest.raises(OverflowError):
        jax.random.randint(jax.random.PRNGKey(0), (), lo, hi)
    with pytest.raises(OverflowError):
        prng.randint(prng.PRNGKey(0), (), lo, hi)


@pytest.mark.parametrize("fn", [prng.bits, prng.uniform, prng.normal])
@pytest.mark.parametrize("shape,part", [
    ((8, 5), {0: (4, 4)}), ((4, 6, 3, 1), {1: (3, 3)}), ((4, 6, 3, 1), {0: (2, 2), 1: (0, 3)}),
    ((16, 12), {0: (3, 1), 1: (11, 1)}), ((5,), {0: (5, 0)}), ((2, 3), {})])
def test_part_is_the_block_of_the_whole_draw(fn, shape, part):
    """A block's draws are the whole draw's at the block's positions, bit for
    bit: the rank's part of a sharded draw."""
    key = prng.PRNGKey(11)
    whole = fn(key, shape)
    index = tuple(slice(part[d][0], part[d][0] + part[d][1]) if d in part else slice(None)
                  for d in range(len(shape)))
    got = fn(key, shape, part=part)
    assert got.shape == whole[index].shape
    assert torch.equal(got, whole[index])


def test_cpu_key_draws_on_another_device():
    """A key on the CPU draws on the device it is given (meta here: the
    shape only), its words handed over as scalars."""
    key = prng.PRNGKey(2)
    out = prng.normal(key, (3, 4), device="meta")
    assert out.is_meta and tuple(out.shape) == (3, 4)
    with pytest.raises(ValueError, match="not inside"):
        prng.bits(key, (4,), part={0: (3, 2)})

