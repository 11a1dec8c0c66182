"""The value-plane gather (radx_tpu_torch/kernels/gather.py) and the sorts
that now hand only their two compare planes to the network — the join's
tagged union (key, tie) and the stable sorts (key, index) — against the
JAX package (Pallas in interpret mode), which still sorts every value plane
through its network, bit for bit (tolerance 0: (key, tie) and (key, index)
are total orders, so every correct sort gives the one result).

``gather_planes_ref`` is held against numpy in both modes; on the CPU the
wrappers run their plain versions (tests/test_torch_gpu.py holds the CUDA
kernel against them on a card).  One JAX result a case keeps interpret mode
inside its time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radx_tpu
from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import join as jj
from radx_tpu.ops import sort as js
from radx_tpu_torch import SortConfig, Table, sort_pairs
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.kernels import gather as tg
from radx_tpu_torch.kernels import radix_sort as trs
from radx_tpu_torch.ops import join as tj
from radx_tpu_torch.ops import sort as ts

JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     rider_chunk_rows=8, compact_chunk_rows=8,
                     interpret=True)
CFG = config_from_jax(JCFG)
SMALL = SortConfig(stable_chunk_elems=16, stable_finish_elems=64,
                   compact_elems=64, scan_elems=256)
LAX = SortConfig(strategy="lax")
N_ODD = 4099  # no multiple of the kernel's 4096-row tile or of any sort tile


def _i32(rng, n):
    return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)


def _bits(x):
    return np.asarray(x).view(np.uint32)


# --- gather_planes_ref against numpy -------------------------------------------


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_gather_index_mode_matches_numpy(planes):
    """out[g][i] = src[g][idx[i]], 0 where idx lies outside the source."""
    rng = np.random.default_rng(planes)
    m = 3000
    srcs = [_i32(rng, m) for _ in range(planes)]
    idx = rng.integers(0, m, N_ODD).astype(np.int32)
    idx[:4] = [-1, m, 2**31 - 1, -(2**31)]
    tg.reset_counts()
    got = tg.gather_planes(torch.from_numpy(idx),
                           [torch.from_numpy(s) for s in srcs])
    inside = (idx >= 0) & (idx < m)
    assert len(got) == planes
    for g, s in zip(got, srcs):
        assert g.dtype == torch.int32 and g.shape == (N_ODD,)
        np.testing.assert_array_equal(
            g.numpy(), np.where(inside, s[np.clip(idx, 0, m - 1)], 0))
    assert tg.PLAIN_CALLS["gather_planes_ref"] == 1
    assert not any(tg.LAUNCHES.values())


def test_gather_permutation_of_the_rows():
    """The stable sorts' case: a permutation of the source's own rows."""
    rng = np.random.default_rng(5)
    src = _i32(rng, N_ODD)
    idx = rng.permutation(N_ODD).astype(np.int32)
    (got,) = tg.gather_planes(torch.from_numpy(idx), [torch.from_numpy(src)])
    np.testing.assert_array_equal(got.numpy(), src[idx])


def test_gather_tagged_mode_matches_numpy():
    """Build ties, probe ties (2^30 + i) and pads (0x7FFFFFFF) in one
    plane: (build[t], 0), (0, probe[t - 2^30]) and (0, 0)."""
    rng = np.random.default_rng(6)
    nb, np_ = 1500, 2200
    build, probe = _i32(rng, nb), _i32(rng, np_)
    kind = rng.integers(0, 3, N_ODD)
    tie = np.where(kind == 0, rng.integers(0, nb, N_ODD),
                   np.where(kind == 1, tg.PROBE_TIE + rng.integers(0, np_, N_ODD),
                            tg.PAD_TIE)).astype(np.int32)
    tie[:3] = [0, tg.PROBE_TIE, tg.PAD_TIE]
    b, p = tg.gather_planes(torch.from_numpy(tie),
                            [torch.from_numpy(build), torch.from_numpy(probe)],
                            "tagged")
    want_b = np.where(kind == 0, build[np.clip(tie, 0, nb - 1)], 0)
    want_p = np.where(kind == 1, probe[np.clip(tie - tg.PROBE_TIE, 0, np_ - 1)],
                      0)
    want_b[:3], want_p[:3] = [build[0], 0, 0], [0, probe[0], 0]
    np.testing.assert_array_equal(b.numpy(), want_b)
    np.testing.assert_array_equal(p.numpy(), want_p)


def test_gather_validates():
    x = torch.zeros(8, dtype=torch.int32)
    for bad in ([x.long()], [x] * 5, [x[::2]], []):
        with pytest.raises(ValueError):
            tg.gather_planes(x, bad)
    with pytest.raises(ValueError, match="two sources"):
        tg.gather_planes(x, [x], "tagged")
    with pytest.raises(ValueError, match="mode"):
        tg.gather_planes(x, [x], "scatter")
    with pytest.raises(ValueError, match="index"):
        tg.gather_planes(x.float(), [x])
    assert tg.gather_planes(x[:0], [x])[0].numel() == 0


# --- the two-plane paths against radx_tpu --------------------------------------


def _keys(rng, n):
    k = rng.integers(0, 40, n, dtype=np.uint32)  # duplicates
    k[:7] = 0xFFFFFFFF  # real keys equal to the pad sentinel
    return k


@pytest.mark.parametrize("n,arbn", [(2048, False), (3000, False),
                                    (3000, True)])
def test_sort_pairs_matches_jax(monkeypatch, n, arbn):
    """At a power of two, padded, and on the arbitrary-N path (routed there
    at this size: pieces of 2 and 1 blocks, one valley merge)."""
    rng = np.random.default_rng(n + arbn)
    k = _keys(rng, n)
    p = rng.standard_normal(n).astype(np.float32)
    jk, jp = js.sort_pairs(k, p, JCFG)
    if arbn:
        monkeypatch.setattr(ts, "_use_decomposition",
                            lambda n, cfg: cfg.strategy != "lax")
    for cfg in (CFG, SMALL, LAX):
        gk, gp = sort_pairs(k, p, cfg, device="cpu")
        assert gp.dtype == torch.float32
        np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(_bits(gp.numpy()), _bits(jp))


@pytest.mark.parametrize("payloads", [1, 3, 7])
def test_sort_multi_matches_jax(payloads):
    """Seven payloads take two gather launches (four a launch)."""
    rng = np.random.default_rng(10 + payloads)
    n = 1500
    k = _keys(rng, n)
    kinds = (lambda: rng.integers(0, 2**32, n, dtype=np.uint32),
             lambda: rng.standard_normal(n).astype(np.float32),
             lambda: rng.integers(-9, 9, n).astype(np.int32))
    pays = [kinds[i % 3]() for i in range(payloads)]
    jk, jps = js.sort_multi(k, pays, JCFG)
    for cfg in (CFG, SMALL):
        gk, gps = ts.sort_multi(k, pays, cfg, device="cpu")
        np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
        assert len(gps) == payloads
        for g, w, p in zip(gps, jps, pays):
            assert g.dtype == torch.from_numpy(p).dtype
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def _float_sides(rng, nb, np_):
    """float32 keys (duplicate build keys, -0.0 / +0.0 / inf / NaN on both
    sides) with uint32 build and int32 probe values."""
    bk = (rng.integers(-40, 40, nb) / 4).astype(np.float32)
    bk[:4] = [-0.0, 0.0, np.inf, np.nan]
    pk = (rng.integers(-48, 48, np_) / 4).astype(np.float32)
    pk[:5] = [0.0, -0.0, np.nan, -np.inf, np.inf]
    bv = rng.integers(0, 2**32, nb, dtype=np.uint32)
    pv = _i32(rng, np_)
    return bk, bv, pk, pv


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_merge_float_keys_matches_jax(how):
    rng = np.random.default_rng(20 + len(how))
    bk, bv, pk, pv = _float_sides(rng, 700, 1100)
    wk, wb, wp, wc = jj.join_merge(bk, bv, pk, pv, JCFG, how=how, missing=9)
    c = int(wc)
    for cfg in (CFG, SMALL):
        gk, gb, gp, gc = tj.join_merge(bk, bv, pk, pv, cfg, how=how,
                                       missing=9, device="cpu")
        assert int(gc) == c and gk.dtype == torch.float32
        for g, w in ((gk, wk), (gb, wb), (gp, wp)):
            np.testing.assert_array_equal(_bits(g[:c].numpy()),
                                          _bits(np.asarray(w)[:c]))


def test_join_merge_multi_matches_jax():
    """Duplicate build keys beyond max_matches; the union's value planes
    (a build row's probe value is 0) come back as the JAX package's."""
    rng = np.random.default_rng(30)
    bk = rng.integers(0, 300, 900).astype(np.uint32)
    bk[:6] = 0xFFFFFFFF
    pk = rng.integers(0, 400, 800).astype(np.uint32)
    pk[:2] = 0xFFFFFFFF
    bv = rng.integers(0, 2**32, 900, dtype=np.uint32)
    pv = rng.integers(0, 2**32, 800, dtype=np.uint32)
    jk, jb, jp, jvalid, jtrunc = jj.join_merge_multi(bk, bv, pk, pv, 3, JCFG)
    jvalid = np.asarray(jvalid)
    for cfg in (CFG, SMALL):
        k, b, p, valid, trunc = tj.join_merge_multi(bk, bv, pk, pv, 3, cfg,
                                                    device="cpu")
        assert bool(trunc) == bool(jtrunc) == True  # noqa: E712
        np.testing.assert_array_equal(valid.numpy(), jvalid)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(b.numpy()[jvalid],
                                      np.asarray(jb)[jvalid])


def test_lazy_join_matches_jax():
    """LazyTable.join after a filter on both sides: rows past the counts
    are union rows whose values the gather fetches, then the flags drop."""
    rng = np.random.default_rng(40)
    n, d = 1200, 160
    a = {"k": rng.integers(0, 90, n).astype(np.uint32),
         "v": rng.integers(0, 2**32, n, dtype=np.uint32)}
    b = {"k": np.repeat(rng.permutation(90)[:d // 2].astype(np.uint32), 2),
         "w": rng.integers(0, 2**32, d, dtype=np.uint32)}
    ma, mb = a["v"] % 3 != 0, np.arange(d) % 5 != 2
    jl = radx_tpu.Table.from_arrays(**a).lazy(JCFG).filter(jnp.asarray(ma))
    jd = radx_tpu.Table.from_arrays(**b).lazy(JCFG).filter(jnp.asarray(mb))
    tl = Table.from_arrays(device="cpu", **a).lazy(CFG).filter(
        torch.from_numpy(ma))
    td = Table.from_arrays(device="cpu", **b).lazy(CFG).filter(
        torch.from_numpy(mb))
    want = jl.join(jd, "k", "v", "w").collect().to_numpy()
    got = tl.join(td, "k", "v", "w").collect().to_numpy()
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]),
                                      err_msg=name)


# --- what reaches the network ----------------------------------------------------


def test_union_and_pairs_sort_two_planes(monkeypatch):
    """The join's union, sort_pairs and sort_multi hand two planes to the
    network (and, under "radix", to the distribution sort); the value
    planes come from one gather a call (two for seven payloads)."""
    net_w, dist_w = [], []
    net, dist = tb.sort_planes, trs.sort_radix

    def counting_net(k, *a, rider=None, lex=None, **kw):
        net_w.append(1 + (rider is not None) + len(lex or ()))
        return net(k, *a, rider=rider, lex=lex, **kw)

    def counting_dist(planes, *a, **kw):
        dist_w.append(len(planes))
        return dist(planes, *a, **kw)

    monkeypatch.setattr(tb, "sort_planes", counting_net)
    monkeypatch.setattr(trs, "sort_radix", counting_dist)
    rng = np.random.default_rng(50)
    n = 1000
    k, v = _keys(rng, n), rng.integers(0, 2**32, n, dtype=np.uint32)
    calls = {}
    for name, fn in (
            ("union", lambda: tj.join_merge(k, v, k[::-1].copy(), v, SMALL,
                                            device="cpu")),
            ("pairs", lambda: sort_pairs(k, v, SMALL, device="cpu")),
            ("multi", lambda: ts.sort_multi(k, [v] * 7, SMALL, device="cpu")),
            ("radix", lambda: sort_pairs(
                np.tile(k, 64), np.tile(v, 64),
                SortConfig(strategy="radix"), device="cpu"))):
        net_w.clear()
        dist_w.clear()
        tg.reset_counts()
        fn()
        calls[name] = (sorted(set(net_w)), dist_w[:],
                       tg.PLAIN_CALLS["gather_planes_ref"])
    assert calls == {"union": ([2], [], 1), "pairs": ([2], [], 1),
                     "multi": ([2], [], 2), "radix": ([], [2], 1)}
