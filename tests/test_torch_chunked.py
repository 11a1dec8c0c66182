"""The port's streaming operators (radx_tpu_torch/ops/chunked.py) against
the JAX package's (radx_tpu/ops/chunked.py, Pallas in interpret mode), at
slab 1024 with n = 5 * 1024 + 7: six slabs, eight sorted runs.

Tolerances: every output bit for bit, except float32 sums, within 1e-5
times the group's sum of magnitudes (the two packages add in different
orders).  One JAX result per case; on the CPU the port's kernel wrappers
run their plain PyTorch versions.
"""

import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import chunked as jc
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.ops import chunked as tc

JCFG = JaxSortConfig(chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SLAB = 1024
N = 5 * SLAB + 7

torch.set_num_threads(1)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("density", [0.3, 0.0, 1.0],
                         ids=["mixed", "all_false", "all_true"])
def test_filter_chunked_matches_jax(density):
    rng = np.random.default_rng(1)
    mask = (rng.random(N) < density).astype(np.int32)
    a = rng.integers(0, 2**32, N, dtype=np.uint32)
    b = rng.random(N).astype(np.float32)
    want, wcount = jc.filter_chunked(mask, [a, b], JCFG, slab=SLAB)
    got, count = tc.filter_chunked(mask, [a, b], CFG, slab=SLAB, device="cpu")
    assert count == wcount == int(mask.sum())
    _same(got, [np.asarray(w) for w in want])
    np.testing.assert_array_equal(got[0], a[mask != 0])


def test_filter_chunked_empty_input():
    empty = np.zeros(0, np.int32)
    want, wcount = jc.filter_chunked(empty, [empty.view(np.uint32)], JCFG,
                                     slab=SLAB)
    got, count = tc.filter_chunked(empty, [empty.view(np.uint32)], CFG,
                                   slab=SLAB, device="cpu")
    assert count == wcount == 0
    _same(got, want)


def _group_input(rng, distinct):
    keys = (rng.permutation(N).astype(np.uint32) if distinct is None
            else rng.integers(0, distinct, N, dtype=np.uint32))
    return keys, rng.integers(0, 2**32, N, dtype=np.uint32)


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_groupby_chunked_recursive_merge_matches_jax(agg):
    """64 distinct keys: 6 slabs of 64 partials, grouped again in one
    slab."""
    keys, vals = _group_input(np.random.default_rng(2), 64)
    want = jc.groupby_chunked(keys, vals, agg, JCFG, slab=SLAB)
    got = tc.groupby_chunked(keys, vals, agg, CFG, slab=SLAB, device="cpu")
    assert got[2] == want[2] == 64
    _same(got[:2], want[:2])


def test_groupby_chunked_host_merge_matches_jax():
    """All keys distinct: the partials do not shrink, _host_merge ends."""
    keys, vals = _group_input(np.random.default_rng(3), None)
    want = jc.groupby_chunked(keys, vals, "max", JCFG, slab=SLAB)
    got = tc.groupby_chunked(keys, vals, "max", CFG, slab=SLAB, device="cpu")
    assert got[2] == want[2] == N
    _same(got[:2], want[:2])
    order = np.argsort(keys)
    np.testing.assert_array_equal(got[1], vals[order])


def test_groupby_chunked_float32_sum_within_tolerance():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 64, N, dtype=np.uint32)
    vals = (rng.standard_normal(N) * 100).astype(np.float32)
    wk, wv, wng = jc.groupby_chunked(keys, vals, "sum", JCFG, slab=SLAB)
    gk, gv, gng = tc.groupby_chunked(keys, vals, "sum", CFG, slab=SLAB,
                                     device="cpu")
    assert gng == wng == 64
    np.testing.assert_array_equal(gk, np.asarray(wk))
    assert gv.dtype == np.float32
    abs_sums = np.array([np.abs(vals[keys == k].astype(np.float64)).sum()
                         for k in gk])
    assert (np.abs(gv.astype(np.float64) - np.asarray(wv)) <= 1e-5 * abs_sums).all()


def test_sort_chunked_eight_runs_matches_jax():
    keys = np.random.default_rng(5).integers(0, 2**32, N, dtype=np.uint32)
    keys[::97] = 0xFFFFFFFF  # real keys equal to the fill
    want = jc.sort_chunked(keys, JCFG, slab=SLAB)
    got = tc.sort_chunked(keys, CFG, slab=SLAB, device="cpu")
    _same([got], [np.asarray(want)])
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_chunked_one_slab_matches_jax():
    keys = np.random.default_rng(6).integers(0, 2**32, SLAB - 3,
                                             dtype=np.uint32)
    want = jc.sort_chunked(keys, JCFG, slab=SLAB)
    got = tc.sort_chunked(keys, CFG, slab=SLAB, device="cpu")
    _same([got], [np.asarray(want)])


def test_sort_chunked_levels_alternate():
    """Every level of the merge tree leaves run j ascending for even j and
    descending for odd j (a wrong direction bit still gives a permutation):
    slabs, then each level, held in numpy."""
    keys = np.random.default_rng(7).integers(0, 2**32, N, dtype=np.uint32)
    dev = torch.device("cpu")
    runs = tc._slab_runs(keys, SLAB, CFG, dev)
    assert len(runs) == 8
    log_run = SLAB.bit_length() - 1
    while True:
        for j, r in enumerate(runs):
            want = np.sort(r)
            np.testing.assert_array_equal(r, want if j % 2 == 0 else want[::-1])
        if len(runs) == 1:
            break
        runs = tc._merge_level(runs, log_run, CFG, dev)
        log_run += 1
    biased = np.concatenate([keys, np.full(8 * SLAB - N, 0xFFFFFFFF,
                                           np.uint32)]) ^ np.uint32(1 << 31)
    np.testing.assert_array_equal(runs[0], np.sort(biased.view(np.int32)))


def test_sort_chunked_errors_match_jax():
    ints = np.arange(10, dtype=np.int32)
    for fn, cfg in ((jc.sort_chunked, JCFG), (tc.sort_chunked, CFG)):
        with pytest.raises(TypeError):
            fn(ints, cfg, slab=SLAB)
        with pytest.raises(ValueError):
            fn(ints.view(np.uint32), cfg, slab=1000)
