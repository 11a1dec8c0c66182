"""The sorts whose planes the network's first and last launches make
(radx_tpu_torch/ops/sort.py ``_source_load``: ``sort``, ``argsort``,
``sort_pairs``, the joins' union, ``join_inner``'s stable build sort and
``groupby``'s rider sort) against the JAX package's (radx_tpu, Pallas in
interpret mode), bit for bit (tolerance 0), on the CPU, where the source
load and the unbiasing store run their plain versions.

n is neither a power of two nor a multiple of 4, and 0xFFFFFFFF (the pads'
key) is among the keys, so the pads and the real largest keys meet; each
case takes one JAX result and holds the port to it in three configurations
(the JAX tiles, small tiles, and small tiles cut into the arbitrary-N
pieces), with PyTorch's preparation of the planes made to raise, so the
source route is the one that ran."""

import numpy as np
import pytest

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import join as jj
from radx_tpu.ops import sort as js
from radx_tpu.ops.groupby import groupby as j_groupby
from radx_tpu_torch import SortConfig, argsort, groupby, sort, sort_pairs
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.ops import join as tj
from radx_tpu_torch.ops import sort as ts

JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     rider_chunk_rows=8, compact_chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SMALL = SortConfig(chunk_elems=16, finish_elems=64, stable_chunk_elems=16,
                   stable_finish_elems=64, rider_chunk_elems=16,
                   rider_finish_elems=64, compact_elems=64, scan_elems=256)
N = 999


def _keys(rng, n, span=2**32):
    k = rng.integers(0, span, n, dtype=np.uint64).astype(np.uint32)
    k[rng.random(n) < 0.1] = 0xFFFFFFFF
    k[:2] = [0xFFFFFFFF, 0]
    return k


def _no_preparation(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("PyTorch prepared the planes")

    for name in ("_key_plane", "_unbias", "_iota", "_rider_planes",
                 "_payload_plane"):
        monkeypatch.setattr(ts, name, refuse)


def _configs(monkeypatch):
    """The JAX tiles, small tiles, and small tiles on the arbitrary-N
    pieces (``_worth_decomposing`` patched: 999 rows would pad to 1024)."""
    yield CFG
    yield SMALL
    monkeypatch.setattr(ts, "_worth_decomposing", lambda n: n > 500)
    yield SMALL
    monkeypatch.undo()


def _ran_sources():
    ran = tb.PLAIN_CALLS["source_planes_ref"]
    tb.reset_counts()
    return ran > 0


def test_sort_matches_jax(monkeypatch):
    keys = _keys(np.random.default_rng(1), N)
    want = np.asarray(js.sort(keys, JCFG))
    for cfg in _configs(monkeypatch):
        _no_preparation(monkeypatch)
        got = sort(keys, cfg, device="cpu")
        assert got.numel() == N and _ran_sources()
        np.testing.assert_array_equal(got.numpy(), want)


def test_argsort_matches_jax(monkeypatch):
    keys = _keys(np.random.default_rng(2), N, 300)
    want = np.asarray(js.argsort(keys, JCFG))
    for cfg in _configs(monkeypatch):
        _no_preparation(monkeypatch)
        got = argsort(keys, cfg, device="cpu")
        assert _ran_sources()
        np.testing.assert_array_equal(got.numpy(), want)


def test_sort_pairs_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    keys = _keys(rng, N, 300)
    vals = rng.integers(0, 2**32, N, dtype=np.uint32)
    wk, wv = js.sort_pairs(keys, vals, JCFG)
    for cfg in _configs(monkeypatch):
        _no_preparation(monkeypatch)
        gk, gv = sort_pairs(keys, vals, cfg, device="cpu")
        assert _ran_sources()
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _sides(rng):
    nb, np_ = 301, N - 301
    bk = rng.permutation(4000)[:nb].astype(np.uint32)
    bk[:2] = [0xFFFFFFFF, 0]
    pk = rng.integers(0, 4000, np_).astype(np.uint32)
    pk[:3] = [0xFFFFFFFF, 0xFFFFFFFF, 0]
    bv = rng.integers(0, 2**32, nb, dtype=np.uint32)
    pv = rng.integers(-(2**31), 2**31, np_, dtype=np.int64).astype(np.int32)
    return bk, bv, pk, pv


def test_join_merge_matches_jax(monkeypatch):
    bk, bv, pk, pv = _sides(np.random.default_rng(4))
    wk, wb, wp, wc = jj.join_merge(bk, bv, pk, pv, JCFG)
    c = int(wc)
    for cfg in _configs(monkeypatch):
        _no_preparation(monkeypatch)
        gk, gb, gp, gc = tj.join_merge(bk, bv, pk, pv, cfg, device="cpu")
        assert int(gc) == c and _ran_sources()
        for w, g in ((wk, gk), (wb, gb), (wp, gp)):
            np.testing.assert_array_equal(
                g[:c].numpy().view(np.uint32),
                np.asarray(w)[:c].view(np.uint32))


def test_join_inner_matches_jax(monkeypatch):
    bk, bv, pk, pv = _sides(np.random.default_rng(5))
    bk[100:200] = bk[:100]  # matches of more than one build row
    want = jj.join_inner(bk, bv, pk, pv, 3, JCFG)
    for cfg in _configs(monkeypatch):
        _no_preparation(monkeypatch)
        got = tj.join_inner(bk, bv, pk, pv, 3, cfg, device="cpu")
        assert _ran_sources()
        for w, g in zip(want, got):
            w = np.asarray(w)
            np.testing.assert_array_equal(g.numpy().view(w.dtype), w)


@pytest.mark.parametrize("agg", ["sum"])
def test_groupby_matches_jax(monkeypatch, agg):
    rng = np.random.default_rng(6)
    keys = _keys(rng, N, 300)
    vals = rng.integers(0, 2**32, N, dtype=np.uint32)
    juk, jout, jng = j_groupby(keys, vals, agg, JCFG)
    g = int(jng)
    for cfg in _configs(monkeypatch):
        _no_preparation(monkeypatch)
        uk, out, ng = groupby(keys, vals, agg, cfg, device="cpu")
        assert int(ng) == g and _ran_sources()
        np.testing.assert_array_equal(uk[:g].numpy(), np.asarray(juk)[:g])
        np.testing.assert_array_equal(out[:g].numpy(), np.asarray(jout)[:g])
