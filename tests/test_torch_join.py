"""The port's joins (radx_tpu_torch/ops/join.py) against the JAX package's
(radx_tpu/ops/join.py, Pallas in interpret mode), bit for bit: the tagged
union's (key, tie) order is total, so keys, values, counts, valid flags and
the truncated flag agree exactly.  Two known defects of the reference are
not taken as the truth (ROADMAP Queue 3):

  * F1: a float32 left join in the JAX package converts the build values
    numerically; the port keeps their bits, held against a NumPy model, and
    the test records how the JAX output differs;
  * F3: 2^30 - 1 rows per side; the port keeps the cap (the probe tiebreak
    starts at 2^30) and raises as the JAX package does.

On the CPU the port's kernel wrappers run their plain PyTorch versions."""

import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import join as jj
from radx_tpu_torch import SortConfig
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.ops import join as tj

JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     compact_chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SMALL = SortConfig(stable_chunk_elems=16, stable_finish_elems=64,
                   compact_elems=64, scan_elems=256)


def _sides(rng, nb, np_, span, unique_build=True):
    bk = (rng.permutation(span)[:nb] if unique_build
          else rng.integers(0, span // 4, nb)).astype(np.uint32)
    bk[:2] = [0xFFFFFFFF, 0]  # the pad sentinel as a real key
    pk = rng.integers(0, span, np_).astype(np.uint32)
    pk[:3] = [0xFFFFFFFF, 0xFFFFFFFF, 0]
    bv = rng.integers(0, 2**32, nb, dtype=np.uint32)
    pv = rng.integers(-(2**31), 2**31, np_, dtype=np.int64).astype(np.int32)
    return bk, bv, pk, pv


def _check_merge(want, got):
    wk, wb, wp, wc = want
    gk, gb, gp, gc = got
    c = int(wc)
    assert int(gc) == c and gc.dtype == torch.int32 and gc.dim() == 0
    for w, g in ((wk, gk), (wb, gb), (wp, gp)):
        w = np.asarray(w)[:c]
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g[:c].numpy().view(np.uint32),
                                      w.view(np.uint32))


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_merge_matches_jax(how):
    rng = np.random.default_rng(len(how))
    bk, bv, pk, pv = _sides(rng, 900, 1400, 2000, unique_build=how == "inner")
    want = jj.join_merge(bk, bv, pk, pv, JCFG, how=how, missing=7)
    for cfg in (CFG, SMALL):
        _check_merge(want, tj.join_merge(bk, bv, pk, pv, cfg, how=how,
                                         missing=7, device="cpu"))


def test_join_merge_int32_keys_matches_jax():
    rng = np.random.default_rng(3)
    bk = rng.permutation(600).astype(np.int32) - 300
    pk = rng.integers(-400, 400, 800).astype(np.int32)
    bv = rng.standard_normal(600).astype(np.float32)
    pv = np.arange(800, dtype=np.uint32)
    want = jj.join_merge(bk, bv, pk, pv, JCFG)
    _check_merge(want, tj.join_merge(bk, bv, pk, pv, SMALL, device="cpu"))


def test_join_merge_multi_matches_jax():
    """Duplicate build keys: up to 6 per key, max_matches=4 truncates; the
    port's 4 fill planes run in one segscan pass, 6 in two."""
    rng = np.random.default_rng(4)
    bk, bv, pk, pv = _sides(rng, 1000, 1000, 1000, unique_build=False)
    bk[10:16] = 77  # six build rows on one key
    pk[50] = 77
    jk, jb, jp, jvalid, jtrunc = jj.join_merge_multi(bk, bv, pk, pv, 4, JCFG)
    assert bool(jtrunc)
    jvalid = np.asarray(jvalid)
    for cfg in (CFG, SMALL):
        k, b, p, valid, trunc = tj.join_merge_multi(bk, bv, pk, pv, 4, cfg,
                                                    device="cpu")
        assert trunc.dim() == 0 and bool(trunc)
        np.testing.assert_array_equal(valid.numpy(), jvalid)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(b.numpy()[jvalid], np.asarray(jb)[jvalid])
    # six fill planes (two passes) against a NumPy model: each probe row
    # matches the first (in build order) six build rows of its key
    k, b, p, valid, trunc = tj.join_merge_multi(bk, bv, pk, pv, 6, SMALL,
                                                device="cpu")
    assert bool(trunc) == (np.unique(bk, return_counts=True)[1].max() > 6)
    rows = {}
    for key, v in zip(bk.tolist(), bv.tolist()):
        rows.setdefault(key, []).append(v)
    want = sorted((x, y, v) for x, y in zip(pk.tolist(), pv.tolist())
                  for v in rows.get(x, [])[:6])
    vm = valid.numpy()
    got = sorted(zip(np.broadcast_to(k.numpy(), vm.shape)[vm].tolist(),
                     np.broadcast_to(p.numpy(), vm.shape)[vm].tolist(),
                     b.numpy()[vm].tolist()))
    assert got == want


def test_join_inner_matches_jax():
    rng = np.random.default_rng(5)
    bk, bv, pk, pv = _sides(rng, 700, 500, 800, unique_build=False)
    want = jj.join_inner(bk, bv, pk, pv, 3, JCFG)
    got = tj.join_inner(bk, bv, pk, pv, 3, SMALL, device="cpu")
    for w, g in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)
    assert bool(got[4]) == bool(want[4]) == True  # noqa: E712


def test_left_join_float32_keeps_bits_f1():
    """F1: build values 1.5 / -0.0 / NaN come back bit for bit (NumPy model);
    the JAX package returns 1.5 as 1069547520.0 (its int32 bit pattern
    converted to float), the divergence recorded here."""
    bk = np.array([1, 2, 3, 4], np.uint32)
    bv = np.array([1.5, -0.0, np.nan, 2.25], np.float32)
    pk = np.array([3, 9, 1, 2, 1], np.uint32)
    pv = np.arange(5, dtype=np.int32)
    order = np.argsort(pk, kind="stable")
    lookup = dict(zip(bk.tolist(), bv.view(np.uint32).tolist()))
    missing = np.float32(-7.25)
    want_b = np.array([lookup.get(int(x), int(missing.view(np.uint32)))
                       for x in pk[order]], np.uint32)
    k, b, p, c = tj.join_merge(bk, bv, pk, pv, CFG, how="left",
                               missing=missing, device="cpu")
    assert int(c) == 5 and b.dtype == torch.float32
    np.testing.assert_array_equal(k[:5].numpy(), pk[order])
    np.testing.assert_array_equal(p[:5].numpy(), order)
    np.testing.assert_array_equal(b[:5].numpy().view(np.uint32), want_b)
    jb = np.asarray(jj.join_merge(bk, bv, pk, pv, JCFG, how="left",
                                  missing=missing)[1])[:5]
    first_one = list(pk[order]).index(1)
    assert jb[first_one] == np.float32(1069547520.0)  # the reference's F1
    assert b[first_one].item() == 1.5


def test_join_row_cap_f3():
    """2^30 rows on a side raise, checked on a zero-stride view (nothing of
    that size is allocated); 2^30 - 1 is the largest side."""
    big = torch.zeros(1, dtype=torch.uint32).expand(1 << 30)
    small = torch.zeros(4, dtype=torch.uint32)
    for args in ((big, big, small, small), (small, small, big, big)):
        with pytest.raises(ValueError, match="2\\^30"):
            tj.join_merge(*args)
        with pytest.raises(ValueError, match="2\\^30"):
            tj.join_merge_multi(*args)
    assert tj.MAX_SIDE_ROWS == (1 << 30) - 1


def test_join_validation():
    k = np.arange(4, dtype=np.uint32)
    with pytest.raises(TypeError):
        tj.join_merge(k, k, k.astype(np.int32), k, device="cpu")
    with pytest.raises(ValueError, match="how"):
        tj.join_merge(k, k, k, k, how="outer", device="cpu")
    with pytest.raises(ValueError):
        tj.join_merge_multi(k, k, k, k, 0, device="cpu")
    with pytest.raises(TypeError):
        tj.join_inner(k, k.astype(np.int64), k, k, device="cpu")
