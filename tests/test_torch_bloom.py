"""Bloom filter parity: the port's bitset is bit-identical to the JAX
package's, and a filter built by either probes identically in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bloom as jbloom
from repro_torch.core import bloom as tbloom

PARAMS = [(20, 3), (10, 3), (12, 5), (16, 1)]


def _values(rng, n, zero_frac=0.3):
    v = np.round(rng.normal(size=n) * 100, 1).astype(np.float32)
    v[rng.uniform(size=n) < zero_frac] = 0.0
    return v


@pytest.mark.parametrize("log2_bits,num_hashes", PARAMS)
@pytest.mark.parametrize("skip_zeros", [True, False])
def test_bitset_is_bit_identical(rng, log2_bits, num_hashes, skip_zeros):
    vals = _values(rng, 3000)
    jp = jbloom.BloomParams(log2_bits=log2_bits, num_hashes=num_hashes)
    tp = tbloom.BloomParams(log2_bits=log2_bits, num_hashes=num_hashes)
    want = np.asarray(jbloom.build(jnp.asarray(vals), jp, skip_zeros))
    got = tbloom.build(torch.as_tensor(vals), tp, skip_zeros)
    assert got.dtype == torch.uint32 and got.shape == (tp.n_words,)
    assert np.array_equal(tbloom.to_numpy_words(got), want)


@pytest.mark.parametrize("log2_bits,num_hashes", PARAMS)
def test_probes_agree_both_ways(rng, log2_bits, num_hashes):
    members = _values(rng, 2000, zero_frac=0.0)
    queries = np.concatenate([members[:500], _values(rng, 1500)])
    jp = jbloom.BloomParams(log2_bits=log2_bits, num_hashes=num_hashes)
    tp = tbloom.BloomParams(log2_bits=log2_bits, num_hashes=num_hashes)
    j_words = jbloom.build(jnp.asarray(members), jp)
    t_words = tbloom.build(torch.as_tensor(members), tp)
    # the port probes the JAX package's filter ...
    got = tbloom.probe(tbloom.from_numpy_words(np.asarray(j_words)),
                       torch.as_tensor(queries), tp).numpy()
    want = np.asarray(jbloom.probe(j_words, jnp.asarray(queries), jp))
    assert np.array_equal(got, want)
    # ... and the JAX package probes the port's
    back = np.asarray(jbloom.probe(jnp.asarray(tbloom.to_numpy_words(t_words)),
                                   jnp.asarray(queries), jp))
    assert np.array_equal(back, want)
    assert got[:500].all()   # no false negatives


def test_hash_matches_uint32_arithmetic(rng):
    keys = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    for i in range(5):
        want = np.asarray(jbloom._hash(jnp.asarray(keys), i, 20))
        got = tbloom._hash(torch.as_tensor(keys.astype(np.int64)), i, 20)
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_float64_values_hash_as_float32(rng):
    vals = rng.normal(size=256)
    tp = tbloom.BloomParams()
    w64 = tbloom.build(torch.as_tensor(vals), tp)
    w32 = tbloom.build(torch.as_tensor(vals.astype(np.float32)), tp)
    assert torch.equal(w64.view(torch.int32), w32.view(torch.int32))
