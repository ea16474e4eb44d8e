"""`gnerf_tpu_torch.utils.prng` vs `jax.random` (threefry2x32, partitionable):
keys, splits, folds, bits and uniform draws bit for bit; normal draws within
1e-6 absolute (XLA's erfinv polynomial, whose log1p may differ from torch's
in the last place)."""

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
    for n in range(1, 6):
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
