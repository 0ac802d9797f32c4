"""Port parity: the counter RNG is bit-equal to the JAX package's.

Tolerance: none — every draw must be bit-identical (uint32 hashing).
"""

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.core import rng as jrng
from jaderaytracerendering_tpu_torch.core import rng as trng

torch.set_num_threads(1)

N = 100_000
SITES = sorted({v for k, v in vars(jrng.DrawSites).items()
                if k.isupper() and isinstance(v, int)})


def _counters(seed):
    g = np.random.default_rng(seed)
    pix = g.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    smp = g.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    bnc = g.integers(0, 130, N).astype(np.uint32)
    return pix, smp, bnc


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_draw_sites_ids_equal():
    names = [k for k in vars(jrng.DrawSites) if k.isupper()]
    assert names and all(getattr(trng.DrawSites, k) == getattr(jrng.DrawSites, k)
                         for k in names)


@pytest.mark.parametrize("site", SITES)
def test_uniform_bit_equal(site):
    pix, smp, bnc = _counters(site)
    want = jrng.uniform(np, pix, smp, bnc, np.uint32(site), 7)
    got = trng.uniform(_t(pix), _t(smp), _t(bnc), site, 7).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_uniform_sites_bit_equal():
    pix, smp, bnc = _counters(1)
    sites = SITES + [jrng.DrawSites.LIGHT_BASE + k for k in range(1, 6)]
    want = jrng.uniform_sites(np, pix, smp, bnc, sites, 3)
    got = trng.uniform_sites(_t(pix), _t(smp), _t(bnc), sites, 3).numpy()
    np.testing.assert_array_equal(got, want)
    # and row s of the batched form equals the single-site draw
    np.testing.assert_array_equal(
        got[2], trng.uniform(_t(pix), _t(smp), _t(bnc), sites[2], 3).numpy())


def test_hash_counters_bit_equal():
    pix, smp, bnc = _counters(2)
    want = jrng.hash_counters(np, pix, smp, bnc, np.uint32(9), 0xFFFFFFFF)
    got = trng.hash_counters(_t(pix), _t(smp), _t(bnc), 9, 0xFFFFFFFF).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
