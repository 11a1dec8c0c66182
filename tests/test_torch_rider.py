"""The rider mode of the port's bitonic kernels (radx_tpu_torch/kernels/
bitonic.py, two planes, one compare) and the port's ``_sort_rider`` against
the JAX package's ``_sort_rider_jit`` (radx_tpu/ops/sort.py, Pallas in
interpret mode).

Which of two tied keys' riders comes first is not part of the contract (the
JAX package itself orders ties differently on the CPU and on the TPU), so
the riders are compared as a multiset per key: both results are sorted by
(key, rider) and must then be equal.  The key plane is compared bit for bit,
and must equal the keys-only network's output.  On the CPU the wrappers run
their plain PyTorch versions; the card holds each kernel against its plain
version bit for bit on both planes (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import sort as js
from radx_tpu_torch import SortConfig
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.ops import sort as ts

JCFG = JaxSortConfig(chunk_rows=8, rider_chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SMALL = SortConfig(rider_chunk_elems=16, rider_finish_elems=64)


def _pairs_sorted(keys, riders):
    order = np.lexsort((riders, keys))
    return keys[order], riders[order]


def _assert_same_multiset(k1, r1, k2, r2):
    a, b = _pairs_sorted(k1, r1), _pairs_sorted(k2, r2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("n", [1000, 4096])
def test_sort_rider_matches_jax_as_multiset(n):
    """Keys in [0, 16) (ties dominate) plus 0xFFFFFFFF keys, which the pads
    (neutral riders) join."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 16, n, dtype=np.uint32)
    keys[:20] = 0xFFFFFFFF
    payload = rng.permutation(n).astype(np.int32)
    neutral = -7
    jk, jr = js._sort_rider_jit(jnp.asarray(keys), jnp.asarray(payload), JCFG,
                                n, neutral)
    jk, jr = np.asarray(jk), np.asarray(jr)
    total = ts._pad_len(n)
    assert jk.shape == (total,)
    for cfg in (CFG, SMALL, SortConfig(), SortConfig(strategy="lax")):
        k, r = ts._sort_rider(torch.from_numpy(keys), torch.from_numpy(payload),
                              cfg, n, neutral)
        assert k.dtype == torch.uint32 and r.dtype == torch.int32
        np.testing.assert_array_equal(k.numpy(), jk)
        _assert_same_multiset(k.numpy(), r.numpy(), jk, jr)
    # every real rider once, every pad's neutral rider once
    assert sorted(r.numpy().tolist()) == sorted(
        payload.tolist() + [neutral] * (total - n))


def _ties(rng, n):
    return rng.integers(0, 16, n).astype(np.int32)


def _port2(fn, x, r, *args, **kw):
    tx, tr = torch.from_numpy(x.copy()), torch.from_numpy(r.copy())
    out = fn(tx, *args, rider=tr, **kw)
    assert out is tx
    return tx.numpy(), tr.numpy()


def _port1(fn, x, *args, **kw):
    tx = torch.from_numpy(x.copy())
    fn(tx, *args, **kw)
    return tx.numpy()


RIDER_PASSES = {
    "chunk_sort": lambda: ((tb.chunk_sort, 64), {"invert": True}),
    "chunk_sort_ascending": lambda: ((tb.chunk_sort, 64), {"ascending": True}),
    **{f"cross_stage<{f}>": (
        lambda f=f, j=min(3, 11 - f): ((tb.cross_stage, j, f, j + f + 1),
                                       {"invert": f % 2 == 1}))
       for f in range(1, tb.cross_fusion(2) + 1)},
    "finish": lambda: ((tb.finish, 256, 11), {}),
}


@pytest.mark.parametrize("name", list(RIDER_PASSES))
def test_rider_pass_moves_keys_like_keys_only_and_keeps_pairs(name):
    """Each pass with a rider gives the keys-only pass's key plane, and the
    (key, rider) pairs it started with."""
    rng = np.random.default_rng(len(name))
    x = _ties(rng, 1 << 12)
    r = np.arange(x.size, dtype=np.int32)
    (fn, *args), kw = RIDER_PASSES[name]()
    gx, gr = _port2(fn, x, r, *args, **kw)
    np.testing.assert_array_equal(gx, _port1(fn, x, *args, **kw))
    np.testing.assert_array_equal(gx, x[gr])  # each rider still with its key
    assert sorted(gr.tolist()) == r.tolist()


def test_ties_keep_their_own_riders():
    """All keys equal: no pair is strictly out of order, nothing moves."""
    x = np.full(1 << 10, 5, np.int32)
    r = np.arange(x.size, dtype=np.int32)
    _, gr = _port2(tb.sort_planes, x, r, 64, 256)
    np.testing.assert_array_equal(gr, r)


@pytest.mark.parametrize("descending", [False, True])
def test_sort_planes_with_rider(descending):
    rng = np.random.default_rng(5)
    x = _ties(rng, 1 << 12)
    r = rng.permutation(x.size).astype(np.int32)
    for cfg in (SMALL, CFG):
        gx, gr = _port2(tb.sort_planes, x, r, cfg.rider_chunk_elems,
                        cfg.rider_finish_elems, descending=descending)
        want = np.sort(x)[::-1] if descending else np.sort(x)
        np.testing.assert_array_equal(gx, want)
        _assert_same_multiset(gx, gr, x, r)


def test_merges_with_rider():
    """merge_sorted_runs and the arbitrary-length valley merge carry the
    rider (the ops that arbitrary-N rider sorts will build on)."""
    rng = np.random.default_rng(6)
    runs = np.sort(_ties(rng, 8 << 8).reshape(8, -1), axis=1)
    runs[1::2] = runs[1::2, ::-1]
    x = runs.reshape(-1).copy()
    r = np.arange(x.size, dtype=np.int32)
    gx, gr = _port2(tb.merge_sorted_runs, x, r, 8, 16, 64)
    np.testing.assert_array_equal(gx, np.sort(x))
    np.testing.assert_array_equal(gx, x[gr])
    n = 3 * 256 + 17
    k = n // 3
    y = _ties(rng, n)
    valley = np.concatenate([np.sort(y[:k])[::-1], np.sort(y[k:])])
    r = np.arange(n, dtype=np.int32)
    gx, gr = _port2(tb.merge_valley_ascending, valley, r, 16, 64)
    np.testing.assert_array_equal(gx, np.sort(y))
    np.testing.assert_array_equal(gx, valley[gr])
    assert sorted(gr.tolist()) == r.tolist()


def test_rider_counts_and_validation():
    tb.reset_counts()
    x = torch.from_numpy(_ties(np.random.default_rng(7), 1 << 10))
    tb.sort_planes(x, 16, 64, rider=torch.arange(1 << 10, dtype=torch.int32))
    assert not any(tb.LAUNCHES.values())
    assert all(tb.PLAIN_CALLS[k] > 0
               for k in ("chunk_sort_ref", "cross_stage_ref", "finish_ref"))
    with pytest.raises(ValueError, match="rider"):
        tb.chunk_sort(x, 64, rider=torch.zeros(1 << 10, dtype=torch.int64))
    with pytest.raises(ValueError, match="rider"):
        tb.finish(x, 64, 7, rider=torch.zeros(1 << 9, dtype=torch.int32))
    with pytest.raises(ValueError, match="rider"):
        tb.cross_stage(x, 3, 1, 5, rider=torch.zeros(1 << 11,
                                                     dtype=torch.int32)[::2])


def test_rider_config():
    # JAX finish width for two planes: min(16, 16384 // (chunk_rows * 2))
    assert (CFG.rider_chunk_elems, CFG.rider_finish_elems) == (1024, 16 * 1024)
    assert CFG.compact_elems == JCFG.compact_chunk_rows * 128
    d = config_from_jax(JaxSortConfig(rider_chunk_rows=2048))
    assert (d.rider_chunk_elems, d.rider_finish_elems) == (2048 * 128,
                                                           4 * 2048 * 128)
    for bad in ({"rider_chunk_elems": 1000}, {"rider_finish_elems": 3},
                {"rider_chunk_elems": 64, "rider_finish_elems": 32},
                {"compact_elems": 1000}, {"scan_elems": 128}):
        with pytest.raises(ValueError):
            SortConfig(**bad)
