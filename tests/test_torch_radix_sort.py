"""``strategy="radix"`` in the port: ``kernels/radix_sort.sort_radix`` against
the JAX package's (Pallas kernels in interpret mode) and the entry points
under ``SortConfig(strategy="radix")`` against numpy, on the CPU.

``sort_radix`` runs at the JAX test geometry: chunk_rows = 32 (C = 4096
keys), 16384 keys, 4 chunks, slots of 1024 keys, nb 6, nb_pad 16.  Its
stages — block-cyclic chunk sorts, splitters, ranks, run bounds and the slot
flag, packed slots, merged buckets, the output — equal the JAX package's bit
for bit (rider mode: (key, rider) multisets, ROADMAP Queue 3).  The port's
tiles are cut below the radix chunk so the span passes of the cross /
finish kernels run too.

The entry points run at 2^16 keys (C = 2^14, 4 chunks), with the plain
versions' call counts showing that the radix functions ran — and that
LazyTable, join_merge and top_k, which stay on the network in the JAX
package, did not reach them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import radx_tpu_torch as R
from radx_tpu.kernels import bitonic as jb
from radx_tpu.kernels import msd as jm
from radx_tpu.kernels import radix_sort as jrs
from radx_tpu_torch.config import SortConfig
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.kernels import msd as tm
from radx_tpu_torch.kernels import radix as tr
from radx_tpu_torch.kernels import radix_sort as trs
from radx_tpu_torch.ops import join as tj
from radx_tpu_torch.ops import sort as ts

C_ROWS, N = 32, 16384
C = C_ROWS * 128
PAD = 0x7FFFFFFF
SIGN = np.uint32(0x80000000)
TILES = dict(chunk_elems=1024, finish_elems=2048, rider_chunk_elems=1024,
             rider_finish_elems=2048, stable_chunk_elems=1024,
             stable_finish_elems=2048)
CFG = SortConfig(strategy="radix", **TILES)  # span passes below the chunk
RADIX = SortConfig(strategy="radix")  # the default tiles
BIG = 1 << 16


def _counts():
    return {**tb.PLAIN_CALLS, **tr.PLAIN_CALLS, **tm.PLAIN_CALLS}


def _reset():
    for m in (tb, tr, tm):
        m.reset_counts()


def _radix_ran():
    c = _counts()
    return c["radix_concat_ref"] > 0 and c["slot_merge_ref"] > 0


def _planes(rng, mode, n_valid):
    """Sign-biased int32 planes of a mode, sentinel-filled past n_valid:
    keys (uniform), lex2 (keys with ties, the index plane) or rider (keys in
    [0, 64), random riders)."""
    keys = rng.integers(0, 2**32, N, dtype=np.uint32)
    if mode != "keys":
        keys[: N // 2] = rng.integers(0, 64, N // 2)
        keys = rng.permutation(keys)
    if mode == "rider":
        keys %= np.uint32(64)
    k = (keys ^ SIGN).view(np.int32)
    k[n_valid:] = PAD
    planes = [k]
    if mode == "lex2":
        planes.append(np.arange(N, dtype=np.int32))
    if mode == "rider":
        planes.append(rng.integers(-(2**31), 2**31, N, dtype=np.int64)
                      .astype(np.int32))
    return planes


def _jax(planes):
    return [jnp.asarray(p.reshape(-1, 128)) for p in planes]


def _np(planes):
    return [np.asarray(p).reshape(-1) for p in planes]


def _rows(planes):
    r = (planes[0].astype(np.int64) << 32) | (planes[1].astype(np.int64)
                                              & 0xFFFFFFFF)
    return np.sort(r)


CASES = {  # name: (mode, n_valid)
    "keys_uniform": ("keys", N),
    "keys_ragged": ("keys", N - 517),
    "lex2_ragged": ("lex2", N - 1000),
    "rider_ties": ("rider", N),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sort_radix_matches_jax(case):
    mode, nv = CASES[case]
    ncmp = 2 if mode == "lex2" else 1
    planes = _planes(np.random.default_rng(len(case)), mode, nv)
    outs, ovf = jrs.sort_radix(_jax(planes), C_ROWS, ncmp, interpret=True,
                               n_valid=nv, unique=mode != "rider")
    want = _np(outs)
    got = [torch.from_numpy(p.copy()) for p in planes]
    res, overflow = trs.sort_radix(got, C, ncmp, CFG, nv)
    assert res is got and overflow is False and not bool(ovf)
    got = [g.numpy() for g in got]
    np.testing.assert_array_equal(got[0], want[0])
    if mode == "rider":
        np.testing.assert_array_equal(_rows(got), _rows(want))
    else:
        for g, w in zip(got[1:], want[1:]):  # lex2: the same permutation
            np.testing.assert_array_equal(g, w)
    order = np.argsort(planes[0][:nv], kind="stable")
    np.testing.assert_array_equal(got[0][:nv], planes[0][:nv][order])
    if mode == "lex2":
        np.testing.assert_array_equal(got[1][:nv], order)


def _jax_pack(bounds, x3, p, ncmp):
    """radx_tpu/kernels/radix_sort.py:275-313, the pack launch, as is."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0, grid=(p.n_chunks,),
        in_specs=[pl.BlockSpec((1, 1, p.nb_pad + 1), lambda c: (c, 0, 0),
                               memory_space=pltpu.SMEM)]
        + [pl.BlockSpec((1, p.c_rows, 128), lambda c: (c, 0, 0))] * len(x3),
        out_specs=[pl.BlockSpec((p.nb_pad, 1, p.slot_rows, 128),
                                lambda c: (0, c, 0, 0))] * len(x3),
        scratch_shapes=[pltpu.VMEM((p.c_rows + p.slot_rows + 8, 128),
                                   jnp.int32)] * len(x3),
    )
    return pl.pallas_call(
        functools.partial(jm._pack_kernel, p.c_rows, p.slot_rows, p.nb_pad,
                          ncmp),
        grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((p.nb_pad, p.n_chunks, p.slot_rows,
                                         128), jnp.int32)] * len(x3),
        interpret=True,
    )(jnp.asarray(bounds)[:, None, :], *x3)


@pytest.mark.parametrize("case", ["keys_ragged", "lex2_ragged"])
def test_radix_stages_match_jax(case):
    """Each stage of the port's sort_radix against the JAX package's."""
    mode, nv = CASES[case]
    ncmp = 2 if mode == "lex2" else 1
    planes = _planes(np.random.default_rng(len(case)), mode, nv)
    jp, p = jrs.plan(N, C_ROWS), trs.plan(N, C)
    tiles = CFG.mode_tiles(len(planes), ncmp)

    j_sorted = jb.sort_chunks_ascending_cyclic(_jax(planes), C_ROWS, ncmp,
                                               t_rows=8, interpret=True)
    t_sorted = tb.sort_chunks_ascending_cyclic(
        [torch.from_numpy(q) for q in planes], ncmp, C, *tiles)
    for g, w in zip(t_sorted, _np(j_sorted)):
        np.testing.assert_array_equal(g.numpy(), w)

    x3 = [q.reshape(jp.n_chunks, C_ROWS, 128) for q in j_sorted]
    j_spl = jrs.choose_splitters(x3[0], jnp.asarray(planes[0]), jp, nv, True)
    t_spl = trs.choose_splitters(t_sorted[0], torch.from_numpy(planes[0]), p,
                                 nv, CFG.mode_tiles(1, 1))
    np.testing.assert_array_equal(t_spl.numpy(),
                                  np.asarray(j_spl)[: jp.nb - 1])

    j_ranks = np.asarray(jm._splitter_ranks(x3[0], j_spl, jp, True))
    t_ranks = tm.splitter_ranks_ref(t_sorted[0], t_spl, C)
    np.testing.assert_array_equal(t_ranks.numpy(), j_ranks)

    # the JAX run bounds and slot flag, radix_sort.py:227-245 and :266
    gtile = (np.arange(C_ROWS // 8)[:, None] * jp.n_chunks
             + np.arange(jp.n_chunks)[None, :])
    valid = np.clip(nv - gtile * 1024, 0, 1024).sum(0)
    j_bounds = np.concatenate(
        [np.zeros((jp.n_chunks, 1), np.int32), j_ranks,
         np.broadcast_to(valid[:, None], (jp.n_chunks, jp.nb_pad + 1 - jp.nb))],
        1).astype(np.int32)
    b = trs.run_bounds(t_ranks, p, nv, tail=False)
    np.testing.assert_array_equal(b.bounds.numpy(), j_bounds)
    assert bool(b.overflow) == bool(np.diff(j_bounds, axis=1).max() > p.slot)
    assert not bool(b.overflow)
    np.testing.assert_array_equal(b.start.numpy(), np.concatenate(
        [[0], np.cumsum(np.diff(j_bounds, axis=1).sum(0))]))

    j_packed = _jax_pack(j_bounds, x3, jp, ncmp)
    t_packed = tm.pack(t_sorted, b.bounds, C, p.slot, p.nb_pad, ncmp)
    for g, w in zip(t_packed, _np(j_packed)):
        np.testing.assert_array_equal(g.numpy(), w)

    j_merged = jb.merge_slots_ascending(
        [q.reshape(jp.nb_pad * C_ROWS, 128) for q in j_packed], jp.slot_rows,
        C_ROWS, ncmp, interpret=True)
    t_merged = tb.merge_slots_ascending(t_packed, ncmp, C, p.slot, *tiles)
    for g, w in zip(t_merged, _np(j_merged)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_rider_sentinel_keys_keep_their_riders():
    """Real keys 0xFFFFFFFF in the rider mode skip the buckets (K13 copies
    them from the sorted chunks), so their riders survive.  The JAX package
    merges them with the slots' fill rows and returns fill zeros in place
    of most of their riders (ROADMAP Queue 3, F4)."""
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 64, N).astype(np.int32)
    keys[rng.random(N) < 0.03] = PAD
    rider = rng.integers(1, 2**31, N, dtype=np.int64).astype(np.int32)
    planes = [torch.from_numpy(keys.copy()), torch.from_numpy(rider.copy())]
    _, overflow = trs.sort_radix(planes, C, 1, CFG)
    assert overflow is False
    got = [p.numpy() for p in planes]
    np.testing.assert_array_equal(got[0], np.sort(keys))
    np.testing.assert_array_equal(_rows(got), _rows([keys, rider]))
    outs, _ = jrs.sort_radix(_jax([keys, rider]), C_ROWS, 1, interpret=True,
                             unique=False)
    jr = _np(outs)[1][_np(outs)[0] == PAD]
    assert (jr == 0).sum() > 0  # the reference's lost riders


def test_all_equal_keys_overflow_and_sort_exactly():
    keys = np.full(BIG, 0x12345678, np.uint32)
    plane = torch.from_numpy((keys ^ SIGN).view(np.int32).copy())
    chunk = trs.pick_chunk(BIG, RADIX.chunk_elems)
    _reset()
    res, overflow = trs.sort_radix([plane], chunk, 1, RADIX)
    assert overflow is True and res[0] is plane
    c = _counts()
    assert c["chunk_sort_cyclic_ref"] == 1 and c["radix_rank_ref"] == 1
    assert c["radix_pack_ref"] == 0 and c["radix_concat_ref"] == 0
    _reset()
    out = R.sort(keys, RADIX, device="cpu")
    np.testing.assert_array_equal(out.numpy(), keys)
    c = _counts()
    assert c["radix_rank_ref"] == 1 and c["chunk_sort_ref"] == 1
    assert c["radix_pack_ref"] == 0


# --- the entry points under strategy="radix", against numpy ------------------


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint32)


@pytest.mark.parametrize("cfg", [RADIX, CFG], ids=["default_tiles", "small"])
@pytest.mark.parametrize("n", [BIG, BIG - 517])
def test_sort_and_argsort(cfg, n):
    rng = np.random.default_rng(n)
    keys = _u32(rng, n)
    keys[:40] = 0xFFFFFFFF  # the pad sentinel as a real key
    _reset()
    np.testing.assert_array_equal(R.sort(keys, cfg, device="cpu").numpy(),
                                  np.sort(keys))
    assert _radix_ran()
    dup = _u32(rng, n, 500)
    _reset()
    np.testing.assert_array_equal(R.argsort(dup, cfg, device="cpu").numpy(),
                                  np.argsort(dup, kind="stable"))
    assert _radix_ran()


@pytest.mark.parametrize("assume_unique", [False, True])
def test_sort_pairs(assume_unique):
    rng = np.random.default_rng(11)
    keys = (rng.permutation(BIG - 3).astype(np.uint32) if assume_unique
            else _u32(rng, BIG - 3, 1000))
    pay = rng.standard_normal(keys.size).astype(np.float32)
    _reset()
    k, p = R.sort_pairs(keys, pay, CFG, assume_unique, device="cpu")
    o = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k.numpy(), keys[o])
    np.testing.assert_array_equal(p.numpy().view(np.int32),
                                  pay[o].view(np.int32))
    assert _radix_ran()
    assert tm.PLAIN_CALLS["radix_concat_ref"] == 1


def test_sort_u64_and_sort_multi():
    rng = np.random.default_rng(12)
    hi, lo = _u32(rng, BIG, 1 << 12), _u32(rng, BIG)
    _reset()
    sh, sl = R.sort_u64(hi, lo, CFG, device="cpu")
    packed = (hi.astype(np.uint64) << np.uint64(32)) | lo
    want = np.sort(packed)
    np.testing.assert_array_equal(sh.numpy(), (want >> np.uint64(32)).astype(
        np.uint32))
    np.testing.assert_array_equal(sl.numpy(), want.astype(np.uint32))
    assert _radix_ran()
    keys = _u32(rng, BIG, 300)
    # one (key, index) engine sort, the seven payloads gathered after it
    pays = [_u32(rng, BIG) for _ in range(7)]
    _reset()
    sk, sp = ts.sort_multi(keys, pays, CFG, device="cpu")
    o = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sk.numpy(), keys[o])
    for a, b in zip(sp, pays):
        np.testing.assert_array_equal(a.numpy(), b[o])
    assert tm.PLAIN_CALLS["radix_concat_ref"] == 1


@pytest.mark.parametrize("agg", ["sum", "min", "max", "count"])
def test_groupby(agg):
    """n_valid = total in the rider sort: the pads (key 0xFFFFFFFF, the
    neutral rider) and real 0xFFFFFFFF keys beside them."""
    rng = np.random.default_rng(13)
    n = BIG - 1000  # pads in the rider sort's 2^16 rows
    keys = _u32(rng, n, 3000)
    keys[::89] = 0xFFFFFFFF
    vals = _u32(rng, n)
    _reset()
    uk, out, ng = R.groupby(keys, vals, agg, CFG, device="cpu")
    assert _radix_ran()
    ek, inv = np.unique(keys, return_inverse=True)
    g = int(ng)
    assert g == ek.size
    np.testing.assert_array_equal(uk[:g].numpy(), ek)
    v = vals.astype(np.uint64)
    want = {"sum": lambda: np.bincount(inv, v % 2**20)
            + (np.bincount(inv, v >> 20) % 2**12) * 2**20,
            "count": lambda: np.bincount(inv),
            "min": lambda: np.minimum.reduceat(v[np.argsort(inv, kind="stable")],
                                               np.r_[0, np.cumsum(np.bincount(inv))[:-1]]),
            "max": lambda: np.maximum.reduceat(v[np.argsort(inv, kind="stable")],
                                               np.r_[0, np.cumsum(np.bincount(inv))[:-1]]),
            }[agg]()
    got = out[:g].numpy().view(np.uint32).astype(np.uint64)
    np.testing.assert_array_equal(got % 2**32,
                                  np.asarray(want, np.float64).astype(np.uint64)
                                  % 2**32)


def test_unique_and_join_inner():
    rng = np.random.default_rng(14)
    keys = _u32(rng, BIG - 10, 5000)
    _reset()
    vals, counts, count = R.unique(keys, return_counts=True, cfg=CFG,
                                   device="cpu")
    assert _radix_ran()
    ev, ec = np.unique(keys, return_counts=True)
    c = int(count)
    np.testing.assert_array_equal(vals[:c].numpy(), ev)
    np.testing.assert_array_equal(counts[:c].numpy(), ec)
    bk = _u32(rng, BIG, 20000)
    bv, pk = _u32(rng, BIG), _u32(rng, 3000, 20000)
    pv = _u32(rng, 3000)
    _reset()
    k, b, p, valid, _ = tj.join_inner(bk, bv, pk, pv, 4, CFG, device="cpu")
    assert _radix_ran()
    order = np.argsort(bk, kind="stable")
    sb, svb = bk[order], bv[order]
    lo = np.searchsorted(sb, pk)
    hi = np.searchsorted(sb, pk, side="right")
    for i in range(0, 3000, 97):
        m = min(hi[i] - lo[i], 4)
        assert int(valid[i].sum()) == m
        np.testing.assert_array_equal(b[i, :m].numpy(), svb[lo[i]: lo[i] + m])
        assert (k[i, :m].numpy() == pk[i]).all()


def test_arbitrary_n_last_piece():
    """The arbitrary-N paths send their last (ascending) piece through the
    engine, as the JAX package does: 24 blocks of 2^14 -> pieces 16 + 8."""
    rng = np.random.default_rng(15)
    n = 24 * (1 << 14) - 5
    keys = _u32(rng, n, 1 << 20)
    _reset()
    got = ts._sort_arbn_keys(torch.from_numpy(keys), RADIX, n)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))
    assert _radix_ran()
    _reset()
    planes = ts._sort_arbn_stable(torch.from_numpy(keys), [], RADIX, n)
    np.testing.assert_array_equal(planes[1][:n].numpy(),
                                  np.argsort(keys, kind="stable"))
    assert _radix_ran()


def test_lazy_join_merge_and_top_k_stay_on_the_network():
    rng = np.random.default_rng(16)
    keys, vals = _u32(rng, BIG - 7, 100), _u32(rng, BIG - 7)
    t = R.Table.from_arrays(k=keys, v=vals, device="cpu")
    _reset()
    lazy = t.lazy(CFG)
    out = lazy.filter(lazy.column("v").view(torch.int32) >= 0)
    res = out.groupby("k", "v", "sum").collect()
    srt = t.lazy(CFG).sort_by("k").collect()
    tk = R.top_k(torch.from_numpy(keys), 10, cfg=CFG)
    j = t.join(R.Table.from_arrays(k=np.arange(50, dtype=np.uint32),
                                   w=np.arange(50, dtype=np.uint32),
                                   device="cpu"), "k", "v", "w", cfg=CFG)
    c = _counts()
    assert not any(c[k] for k in ("chunk_sort_cyclic_ref", "slot_merge_ref",
                                  "radix_hist_ref", "radix_rank_ref",
                                  "radix_pack_ref", "radix_concat_ref"))
    assert c["chunk_sort_ref"] > 0
    keep = vals.view(np.int32) >= 0
    assert res.num_rows == np.unique(keys[keep]).size
    np.testing.assert_array_equal(srt.column("k").numpy(), np.sort(keys))
    np.testing.assert_array_equal(tk[0].numpy(), np.sort(keys)[::-1][:10])
    assert j.num_rows == int((keys < 50).sum())


def test_samples_sorted_on_the_network(monkeypatch):
    """From 2^17 samples on the network sorts them (in place, on a copy of
    the strided samples): the same splitters as torch.sort gives."""
    keys = np.random.default_rng(17).integers(0, 2**32, BIG, dtype=np.uint32)
    p = trs.plan(BIG, 1 << 14)
    sorted_ = torch.sort(torch.from_numpy((keys ^ SIGN).view(np.int32))
                         .view(-1, p.C), 1).values.view(-1)
    before = sorted_.clone()
    flat = torch.from_numpy((keys ^ SIGN).view(np.int32))
    want = trs.choose_splitters(sorted_, flat, p, BIG, RADIX.mode_tiles(1, 1))
    monkeypatch.setattr(trs, "_SAMPLE_SORT_MIN", 2)
    _reset()
    got = trs.choose_splitters(sorted_, flat, p, BIG, RADIX.mode_tiles(1, 1))
    assert tb.PLAIN_CALLS["chunk_sort_ref"] == 1
    assert torch.equal(got, want) and torch.equal(sorted_, before)


def test_groupby_with_many_pads_does_not_overflow():
    """A row count just above a power of two: 39% of the rider sort's rows
    are pads (key 0xFFFFFFFF).  They skip the buckets and the splitter
    targets, so the buckets stay balanced and no slot overflows."""
    rng = np.random.default_rng(18)
    n = 40000
    keys, vals = _u32(rng, n), _u32(rng, n)
    _reset()
    uk, out, ng = R.groupby(keys, vals, "count", CFG, device="cpu")
    c = _counts()
    assert c["radix_rank_ref"] == 1 and c["radix_pack_ref"] == 1  # no overflow
    ek, ec = np.unique(keys, return_counts=True)
    assert int(ng) == ek.size
    np.testing.assert_array_equal(uk[: ek.size].numpy(), ek)
    np.testing.assert_array_equal(out[: ek.size].numpy(), ec)
