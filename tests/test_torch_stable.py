"""The lexicographic mode of the port's bitonic network (radx_tpu_torch/
kernels/bitonic.py, ``lex=``) and the stable sort API built on it
(radx_tpu_torch/ops/sort.py) against the JAX package's (radx_tpu/kernels/
bitonic.py with ``num_cmp=2``, radx_tpu/ops/sort.py; Pallas in interpret
mode), bit for bit (tolerance 0: (key, index) is a total order, so every
correct sort gives the one result).  On the CPU the port's wrappers run
their plain PyTorch versions; tests/test_torch_gpu.py holds the kernels'
``/lex<P>`` instances against those on a card.  One JAX call per case keeps
interpret mode inside its time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.kernels import bitonic as jb
from radx_tpu.ops import sort as js
from radx_tpu_torch import (SortConfig, argsort, sort_any, sort_pairs,
                            sort_pairs_any, sort_u64)
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.ops import sort as ts

JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     rider_chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SMALL = SortConfig(stable_chunk_elems=16, stable_finish_elems=64,
                   rider_chunk_elems=16, rider_finish_elems=64)


def _tied(rng, n):
    return rng.integers(0, 16, n).astype(np.int32)


@pytest.mark.parametrize("planes", [2, 3, 4, 5])
def test_lex_network_matches_jax_sort_planes(planes):
    """Heavily tied plane 0, a unique plane 1, riders: every plane equal to
    JAX sort_planes(num_cmp=2), ascending (and descending once)."""
    rng = np.random.default_rng(planes)
    n = 2048
    ps = [_tied(rng, n), rng.permutation(n).astype(np.int32)]
    ps += [rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
           for _ in range(planes - 2)]
    descending = planes == 3
    want = jb.sort_planes([jnp.asarray(p.reshape(-1, 128)) for p in ps], 8, 2,
                          interpret=True, descending=descending)
    for chunk, fin in ((1024, 2048), (16, 64), (32, 32)):
        got = [torch.from_numpy(p.copy()) for p in ps]
        tb.sort_planes(got[0], chunk, fin, descending, lex=got[1:])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))


def test_lex_passes_keep_rows_and_validate():
    rng = np.random.default_rng(1)
    n = 1 << 11
    k, tie = _tied(rng, n), rng.permutation(n).astype(np.int32)
    r = np.arange(n, dtype=np.int32)
    for fn, args in ((tb.chunk_sort, (64,)), (tb.finish, (256, 11)),
                     *(((tb.cross_stage, (3, f, 3 + f + 1)))
                       for f in range(1, tb.max_fusion(3) + 1))):
        ps = [torch.from_numpy(x.copy()) for x in (k, tie, r)]
        fn(ps[0], *args, lex=ps[1:])
        got_r = ps[2].numpy()
        np.testing.assert_array_equal(ps[0].numpy(), k[got_r])
        np.testing.assert_array_equal(ps[1].numpy(), tie[got_r])
        assert sorted(got_r.tolist()) == r.tolist()
    x = torch.from_numpy(k.copy())
    with pytest.raises(ValueError, match="cross pass"):
        tb.cross_stage(x, 0, tb.cross_fusion(4) + 1, 8,
                       lex=[x.clone(), x.clone(), x.clone()])
    with pytest.raises(ValueError, match="lex"):
        tb.chunk_sort(x, 64, lex=[x.clone()] * 8)
    with pytest.raises(ValueError, match="not both"):
        tb.chunk_sort(x, 64, rider=x.clone(), lex=[x.clone()])
    assert [tb.max_fusion(p) for p in range(1, 9)] == [4, 4, 4, 3, 3, 3, 2, 2]
    assert "cross_stage<4>/lex3" in tb.KERNELS
    assert [tb.cross_fusion(p) for p in range(1, 9)] == [10, 9, 8, 6, 6, 6,
                                                          4, 4]
    assert "cross_stage<8>/lex3" in tb.KERNELS
    assert "cross_stage<4>/lex7" in tb.KERNELS
    assert "cross_stage<5>/lex7" not in tb.KERNELS


def test_merge_valley_lex():
    """A valley (a descending run, then an ascending one) of (key, tie) rows
    of a length that is no power of two merges into ascending order."""
    rng = np.random.default_rng(2)
    n = 3 * 256 + 64
    keys, tie = _tied(rng, n), rng.permutation(n).astype(np.int32)
    cut = n // 3
    idx = np.concatenate([np.lexsort((tie[:cut], keys[:cut]))[::-1],
                          cut + np.lexsort((tie[cut:], keys[cut:]))])
    ps = [torch.from_numpy(keys[idx].copy()), torch.from_numpy(tie[idx].copy())]
    tb.merge_valley_ascending(ps[0], 16, 64, lex=ps[1:])
    want = np.lexsort((tie, keys))
    np.testing.assert_array_equal(ps[0].numpy(), keys[want])
    np.testing.assert_array_equal(ps[1].numpy(), tie[want])


def _keys(rng, n):
    k = rng.integers(0, 40, n, dtype=np.uint32)
    k[:7] = 0xFFFFFFFF  # real keys equal to the pad sentinel
    return k


@pytest.mark.parametrize("n", [1000, 2500])
def test_argsort_and_sort_pairs_match_jax(n):
    rng = np.random.default_rng(n)
    k = _keys(rng, n)
    p = rng.standard_normal(n).astype(np.float32)
    jk, jp = js.sort_pairs(k, p, JCFG)
    for cfg in (CFG, SMALL, SortConfig(), SortConfig(strategy="lax")):
        gk, gp = sort_pairs(k, p, cfg, device="cpu")
        assert gp.dtype == torch.float32
        np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(gp.numpy().view(np.uint32),
                                      np.asarray(jp).view(np.uint32))
        np.testing.assert_array_equal(argsort(k, cfg, device="cpu").numpy(),
                                      np.argsort(k, kind="stable"))


def test_sort_pairs_assume_unique_matches_jax():
    rng = np.random.default_rng(5)
    n = 3000
    k = rng.permutation(1 << 20)[:n].astype(np.uint32)
    p = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    jk, jp = js.sort_pairs(k, p, JCFG, assume_unique=True)
    for cfg in (CFG, SMALL, SortConfig(strategy="lax")):
        gk, gp = sort_pairs(k, p, cfg, assume_unique=True, device="cpu")
        np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(jp))


def test_sort_multi_matches_jax_more_than_six_payloads():
    """Seven payloads: the JAX package sorts 9 planes in two lexicographic
    sorts; the port sorts (key, index) once and gathers the payloads."""
    rng = np.random.default_rng(6)
    n = 1000
    k = _keys(rng, n)
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32),
            rng.standard_normal(n).astype(np.float32),
            rng.integers(-9, 9, n).astype(np.int32)] * 2
    pays.append(pays[0] ^ np.uint32(0x5A5A5A5A))
    jk, jps = js.sort_multi(k, pays, JCFG)
    for cfg in (CFG, SMALL, SortConfig(strategy="lax")):
        gk, gps = ts.sort_multi(k, pays, cfg, device="cpu")
        np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
        assert len(gps) == len(pays)
        for g, w, p in zip(gps, jps, pays):
            assert g.dtype == torch.from_numpy(p).dtype
            np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                          np.asarray(w).view(np.uint32))


def test_sort_u64_and_64bit_sort_any_match_jax():
    rng = np.random.default_rng(7)
    n = 2000
    hi = rng.integers(0, 8, n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    lo[:20] = 0xFFFFFFFF
    jh, jl = js.sort_u64(hi, lo, JCFG)
    for cfg in (CFG, SMALL):
        gh, gl = sort_u64(hi, lo, cfg, device="cpu")
        np.testing.assert_array_equal(gh.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(jl))
    f64 = rng.standard_normal(n)
    f64[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 5e-324]
    i64 = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    u64 = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    for keys in (f64, i64, u64):
        for descending in (False, True):
            got = sort_any(keys, descending, SMALL, device="cpu")
            assert isinstance(got, np.ndarray) and got.dtype == keys.dtype
            want = np.sort(keys)[::-1] if descending else np.sort(keys)
            np.testing.assert_array_equal(got, want)  # (-0.0 == 0.0 here)
    want = js.sort_any(f64, True, JCFG)  # one JAX call: float64 descending
    np.testing.assert_array_equal(
        sort_any(f64, True, CFG, device="cpu").view(np.uint64),
        want.view(np.uint64))


def test_sort_pairs_any_matches_jax():
    rng = np.random.default_rng(8)
    n = 1200
    f32 = (rng.integers(-20, 20, n) / 4).astype(np.float32)
    f32[:8] = [np.nan, -0.0, 0.0, np.inf, -np.inf, -0.0, 0.0, np.nan]
    i64 = rng.integers(-50, 50, n).astype(np.int64) << 33
    pay = np.arange(n, dtype=np.int32)
    jk, jp = js.sort_pairs_any(f32, pay, True, JCFG)
    gk, gp = sort_pairs_any(f32, pay, True, CFG, device="cpu")
    np.testing.assert_array_equal(gk.numpy().view(np.uint32),
                                  np.asarray(jk).view(np.uint32))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(jp))
    gk, gp = sort_pairs_any(i64, pay, False, SMALL, device="cpu")
    order = np.argsort(i64, kind="stable")
    np.testing.assert_array_equal(gk, i64[order])
    np.testing.assert_array_equal(gp.numpy(), order)


def test_sort_arbn_stable_matches_jax():
    """The arbitrary-N (key, index, payload) path at a small n: 3000 rows in
    1024-row blocks, pieces of 2 and 1 blocks, one valley merge."""
    rng = np.random.default_rng(9)
    n = 3000
    k = _keys(rng, n)
    p = rng.integers(0, 2**32, n, dtype=np.uint32)
    jk, jp = js._sort_arbn_stable_jit(jnp.asarray(k), jnp.asarray(p), JCFG, n,
                                      True)
    for cfg in (CFG, SMALL):
        planes = ts._sort_arbn_stable(torch.from_numpy(k), [torch.from_numpy(p)],
                                      cfg, n)
        np.testing.assert_array_equal(ts._unbias(planes[0], n).numpy(),
                                      np.asarray(jk))
        np.testing.assert_array_equal(planes[2][:n].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(planes[1][:n].numpy(),
                                      np.argsort(k, kind="stable"))


def test_routing_and_small_inputs():
    assert ts._use_decomposition(3 * (1 << 22) + 7, SortConfig())
    for n in (0, 1):
        k = np.arange(n, dtype=np.uint32)
        assert argsort(k, device="cpu").numel() == n
        gk, gp = sort_pairs(k, k, device="cpu")
        assert gk.numel() == gp.numel() == n
    with pytest.raises(TypeError):
        sort_pairs(np.zeros(4, np.uint32), np.zeros(4, np.int64), device="cpu")
    with pytest.raises(ValueError):
        sort_pairs(np.zeros(4, np.uint32), np.zeros(3, np.int32), device="cpu")
    with pytest.raises(ValueError):
        sort_u64(np.zeros(4, np.uint32), np.zeros(3, np.uint32), device="cpu")
    with pytest.raises(TypeError):
        argsort(np.zeros(4, np.int32), device="cpu")
