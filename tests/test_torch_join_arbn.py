"""The joins' tagged union at its own length (radx_tpu_torch/ops/join.py::
tagged_union): from 2^22 rows, where a power of two would pad by more than
10%, the port sorts the union's (key, tie) planes as ``blocks * chunk`` rows
in arbitrary-N pieces and valley merges (``ops/sort.py::_sort_pieces`` with
``network=True``); the JAX package pads the union to a power of two.

Here ``_worth_decomposing`` is patched so that small unions take that path
too, on tiny lex tiles (16 / 64 rows: two or three pieces).  (key, tie) is a
total order and the pads (key and tie 0x7FFFFFFF) follow every real row, so
the joins agree with the JAX package (Pallas in interpret mode) bit for bit,
and the decomposed union with the padded one.  The union stays on the
network under every strategy: under ``"radix"`` it never reaches ``_engine``
or the distribution sort, whose overflow flag is read on the host.  On the
CPU the kernel wrappers run their plain PyTorch versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radx_tpu
from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import join as jj
from radx_tpu_torch import SortConfig, Table
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.kernels import msd as tm
from radx_tpu_torch.kernels import radix_sort as trs
from radx_tpu_torch.ops import join as tj
from radx_tpu_torch.ops import sort as ts

JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     rider_chunk_rows=8, compact_chunk_rows=8,
                     topk_chunk_rows=8, interpret=True)
SMALL = SortConfig(stable_chunk_elems=16, stable_finish_elems=64,
                   compact_elems=64, scan_elems=256)
CHUNK = 16
FF = 0xFFFFFFFF
# union rows: 48 blocks of 16 (pieces of 32 and 16 blocks) and 56 blocks
# (32, 16 and 8), each with a few pad rows
TWO, THREE = 48 * CHUNK - 5, 56 * CHUNK - 3


@pytest.fixture
def decomposed(monkeypatch):
    """Every union takes the arbitrary-N path; the list holds each call's
    (rows sorted, piece block counts, network)."""
    calls = []
    real = ts._sort_pieces

    def spy(planes, sizes, chunk, fin, cfg, num_cmp, **kw):
        calls.append((planes[0].numel(), list(sizes), kw.get("network")))
        return real(planes, sizes, chunk, fin, cfg, num_cmp, **kw)

    monkeypatch.setattr(ts, "_worth_decomposing", lambda n: True)
    monkeypatch.setattr(ts, "_sort_pieces", spy)
    return calls


def _rows(n):
    blocks, sizes = ts._decompose_blocks(n, CHUNK)
    return blocks * CHUNK, sizes


def test_sizes_cut_into_two_and_three_pieces():
    assert _rows(TWO) == (768, [32, 16])
    assert _rows(THREE) == (896, [32, 16, 8])
    for n in (TWO, THREE):
        assert _rows(n)[0] < ts._pad_len(n)


def _u32_sides(rng, nb, np_, span):
    """uint32 keys: the build side with duplicates, both sides with
    0xFFFFFFFF (the pad's key) and 0."""
    bk = rng.integers(0, span, nb).astype(np.uint32)
    bk[:3] = [FF, FF, 0]
    pk = rng.integers(0, span, np_).astype(np.uint32)
    pk[:3] = [FF, 0, FF]
    bv = rng.integers(0, 2**32, nb, dtype=np.uint32)
    pv = rng.integers(-(2**31), 2**31, np_, dtype=np.int64).astype(np.int32)
    return bk, bv, pk, pv


def _f32_sides(rng, nb, np_):
    """float32 keys with NaN, -0.0, +0.0 and duplicates; int32 build values
    (a left join converts other build dtypes numerically in the JAX
    package, ROADMAP F1)."""
    bk = (rng.integers(-60, 60, nb) / 4).astype(np.float32)
    bk[:5] = [np.nan, -0.0, 0.0, np.inf, -np.inf]
    pk = (rng.integers(-80, 80, np_) / 4).astype(np.float32)
    pk[:6] = [np.nan, 0.0, -0.0, np.nan, -0.0, np.inf]
    bv = rng.integers(-(2**31), 2**31, nb, dtype=np.int64).astype(np.int32)
    pv = rng.integers(0, 2**32, np_, dtype=np.uint32)
    return bk, bv, pk, pv


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_merge_decomposed_matches_jax(decomposed, how):
    """inner: uint32 keys, two pieces; left: float32 keys, three pieces."""
    rng = np.random.default_rng([16, len(how)])
    if how == "inner":
        n, sides = TWO, _u32_sides(rng, 300, TWO - 300, 400)
    else:
        n, sides = THREE, _f32_sides(rng, 350, THREE - 350)
    kw = {"how": how, "missing": -9} if how == "left" else {}
    want = jj.join_merge(*sides, JCFG, **kw)
    got = tj.join_merge(*sides, SMALL, **kw, device="cpu")
    total, sizes = _rows(n)
    assert decomposed == [(total, sizes, True)]
    c = int(want[3])
    assert got[3].dtype == torch.int32 and int(got[3]) == c
    if how == "left":
        assert c == n - 350
    for w, g in zip(want[:3], got[:3]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g[:c].numpy()),
                                      _bits(np.asarray(w)[:c]))


def test_join_merge_multi_decomposed_matches_jax(decomposed):
    """Up to four build rows a key, max_matches=3 (truncated), three
    pieces: every output over the n union rows, bit for bit."""
    rng = np.random.default_rng(163)
    bk, bv, pk, pv = _u32_sides(rng, 400, THREE - 400, 160)
    bk[10:14] = 77
    pk[20] = 77
    jk, jb, jp, jvalid, jtrunc = jj.join_merge_multi(bk, bv, pk, pv, 3, JCFG)
    k, b, p, valid, trunc = tj.join_merge_multi(bk, bv, pk, pv, 3, SMALL,
                                                device="cpu")
    assert decomposed == [(*_rows(THREE), True)]
    assert trunc.dim() == 0 and bool(trunc) and bool(jtrunc)
    jvalid = np.asarray(jvalid)
    assert valid.shape == jvalid.shape == (3, THREE)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(b.numpy()[jvalid], np.asarray(jb)[jvalid])


def test_lazy_join_after_filters_decomposed_matches_jax(decomposed):
    """Both sides filtered: the union holds every padded row of both
    (three pieces), the rows past each count sort with their own ties and
    are excluded by ``_union_flags``."""
    rng = np.random.default_rng(164)
    nb, np_ = 290, THREE - 290
    dk = rng.integers(0, 200, nb).astype(np.uint32)  # duplicate build keys
    dk[:2] = [FF, 7]
    a = {"k": rng.integers(0, 220, np_).astype(np.uint32),
         "v": rng.integers(0, 2**32, np_, dtype=np.uint32)}
    a["k"][:3] = [FF, 7, FF]
    d = {"k": dk, "w": rng.integers(0, 2**32, nb, dtype=np.uint32)}
    pmask = (a["v"] % 3) != 0
    bmask = np.arange(nb) % 5 != 2
    want = (radx_tpu.Table.from_arrays(**a).lazy(JCFG)
            .filter(jnp.asarray(pmask))
            .join(radx_tpu.Table.from_arrays(**d).lazy(JCFG)
                  .filter(jnp.asarray(bmask)), "k", "v", "w")
            .collect().to_numpy())
    lazy = (Table.from_arrays(device="cpu", **a).lazy(SMALL)
            .filter(torch.from_numpy(pmask))
            .join(Table.from_arrays(device="cpu", **d).lazy(SMALL)
                  .filter(torch.from_numpy(bmask)), "k", "v", "w"))
    assert decomposed == [(*_rows(THREE), True)]
    got = lazy.collect().to_numpy()
    assert list(got) == list(want) and got["k"].size > 0
    for name in want:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]),
                                      err_msg=name)


# --- the decomposed union against the padded one, inside the port ------------


def _union(monkeypatch, sides, cfg, decompose):
    monkeypatch.setattr(ts, "_worth_decomposing", lambda n: decompose)
    bk, bv, pk, pv = (torch.from_numpy(x) for x in sides)
    return tj.tagged_union(ts._encode_keys(bk), bv, ts._encode_keys(pk), pv,
                           cfg)


# n: one piece (32 blocks, no pads), two, three, four, five pieces
# (16 + 8 + 4 + 2 + 1 blocks) and a union above 2^5 blocks that rounds up
@pytest.mark.parametrize("n", [512, TWO, THREE, 60 * CHUNK - 1,
                               31 * CHUNK - 9, 67 * CHUNK + 3])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("strategy", ["bitonic", "radix", "lax"])
def test_decomposed_union_equals_padded(monkeypatch, n, seed, strategy):
    rng = np.random.default_rng([n, seed])
    nb = int(rng.integers(6, n - 6))
    sides = (_f32_sides(rng, nb, n - nb) if seed else
             _u32_sides(rng, nb, n - nb, max(n // 3, 8)))
    cfg = SortConfig(strategy=strategy, stable_chunk_elems=CHUNK,
                     stable_finish_elems=64)
    padded = _union(monkeypatch, sides, cfg, False)
    pieces = _union(monkeypatch, sides, cfg, True)
    for name, a, b in zip(("key", "tie", "build", "probe"), padded, pieces):
        assert a.shape == b.shape == (n,) and a.dtype == b.dtype
        assert torch.equal(a, b), name
    keys = padded[0].numpy()
    assert (np.diff(keys.astype(np.int64)) >= 0).all()


# --- the union never leaves the network --------------------------------------


def test_radix_union_never_reaches_engine_or_radix(monkeypatch, decomposed):
    """Under ``"radix"``, with a last piece of 2^16 rows (64 blocks of
    1024: where the distribution sort plans at these tiles), the union
    sorts on the network only; the default route of ``_sort_pieces`` on
    the same planes does reach both (the spies would see it)."""
    cfg = SortConfig(strategy="radix", chunk_elems=1024, finish_elems=2048,
                     stable_chunk_elems=1024, stable_finish_elems=2048,
                     compact_elems=1024, scan_elems=1024)
    n = 3 * (1 << 16) - 5
    assert ts._decompose_blocks(n, 1024) == (192, [128, 64])
    seen = {"engine": 0, "sort_radix": 0}

    def spy(name, real):
        def f(*a, **k):
            seen[name] += 1
            return real(*a, **k)
        return f

    monkeypatch.setattr(ts, "_engine", spy("engine", ts._engine))
    monkeypatch.setattr(trs, "sort_radix", spy("sort_radix", trs.sort_radix))
    rng = np.random.default_rng(165)
    bk, bv, pk, pv = _u32_sides(rng, n // 3, n - n // 3, 1 << 15)
    tm.reset_counts()
    k, b, p, c = tj.join_merge(bk, bv, pk, pv, cfg, device="cpu")
    lz = (Table.from_arrays(device="cpu", k=pk, v=pv).lazy(cfg)
          .join(Table.from_arrays(device="cpu", k=bk, w=bv).lazy(cfg),
                "k", "v", "w"))
    assert [d[1:] for d in decomposed] == [([128, 64], True)] * 2
    assert seen == {"engine": 0, "sort_radix": 0}
    assert not any(tm.PLAIN_CALLS.values())
    # the keys of probe rows whose key has a build row, from numpy
    hit = np.isin(pk, bk)
    c = int(c)
    assert c == hit.sum() == lz.collect().num_rows
    np.testing.assert_array_equal(k[:c].numpy(), np.sort(pk[hit]))
    # the default route on a union's planes: the last piece through _engine
    planes = [ts._key_plane(torch.from_numpy(pk), 192 * 1024),
              ts._iota(192 * 1024, "cpu")]
    ts._sort_pieces(planes, [128, 64], 1024, 2048, cfg, 2)
    assert seen == {"engine": 1, "sort_radix": 1}


def test_pieces_on_the_network(monkeypatch, decomposed):
    """A spy on ``bitonic.sort_planes``: the union's pieces, descending but
    the last, ``blocks * chunk`` rows in all (no power of two), then one
    valley merge a piece after the first."""
    sorts, merges = [], []
    real_sort, real_merge = tb.sort_planes, tb.merge_valley_ascending

    def sort_spy(x, chunk, fin, descending=False, **kw):
        sorts.append((x.numel(), descending, chunk, fin))
        return real_sort(x, chunk, fin, descending, **kw)

    def merge_spy(x, *a, **kw):
        merges.append(x.numel())
        return real_merge(x, *a, **kw)

    monkeypatch.setattr(tb, "sort_planes", sort_spy)
    monkeypatch.setattr(tb, "merge_valley_ascending", merge_spy)
    rng = np.random.default_rng(166)
    for n, rows in ((TWO, [512, 256]), (THREE, [512, 256, 128])):
        del sorts[:], merges[:]
        tj.join_merge(*_u32_sides(rng, 200, n - 200, 300), SMALL,
                      device="cpu")
        total = sum(rows)
        assert total == _rows(n)[0] and total & (total - 1)
        assert sorts == [(r, i < len(rows) - 1, 16, 64)
                         for i, r in enumerate(rows)]
        # each fold merges a descending piece with the merged suffix
        assert merges == [total - sum(rows[:i])
                          for i in reversed(range(len(rows) - 1))]


# --- the routing at the benchmark's size -------------------------------------


class _Stop(Exception):
    pass


def test_union_of_2e8_rows_takes_the_pieces(monkeypatch):
    """config 4's 10^8 x 10^8 join: 24,576 blocks of the 2^13-row lex2 tile,
    pieces of 2^27 and 2^26 rows (0.66% pads instead of 2^28 rows), on the
    network, under every strategy (shapes only, on the meta device:
    nothing runs)."""
    seen = []

    def spy(planes, sizes, chunk, fin, cfg, num_cmp, **kw):
        seen.append(([p.numel() for p in planes], sizes, chunk, fin,
                     num_cmp, kw))
        raise _Stop

    monkeypatch.setattr(ts, "_sort_pieces", spy)
    n8 = 10**8
    keys = torch.empty(n8, dtype=torch.uint32, device="meta")
    for strategy in ("bitonic", "radix", "lax"):
        cfg = SortConfig(strategy=strategy)
        assert cfg.lex_tiles(2) == (1 << 13, 1 << 13)
        with pytest.raises(_Stop):
            tj.tagged_union(keys, keys, keys, keys, cfg)
        *shapes, kw = seen.pop()
        assert shapes == [[201_326_592] * 2, [16384, 8192], 1 << 13,
                          1 << 13, 2]
        # on the network, its (key, tie) planes made from the two sides by
        # the pieces' first launches
        assert kw.keys() == {"network", "sources"} and kw["network"]
        key, tie = kw["sources"]
        assert (key.n, key.split, len(key.cols), tie.n, tie.split) == (
            2 * n8, n8, 2, 2 * n8, n8)
    assert ts._worth_decomposing(2 * n8)
    assert not ts._use_decomposition(2 * n8, SortConfig(strategy="lax"))
    # whole powers of two and sizes just below one keep the padded union
    for m in (1 << 28, (1 << 28) - 5, 1 << 27, (1 << 22) - 1):
        assert not ts._worth_decomposing(m)
