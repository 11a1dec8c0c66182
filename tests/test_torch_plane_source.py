"""A sort's planes made in the network's own first and last launches
(radx_tpu_torch/kernels/bitonic.py ``Source``, ``source_planes_ref``,
``sort_planes(sources=..., key_out=...)``; csrc/bitonic_io.cu), on the CPU,
without JAX.

The first chunk sort of a sort reads the caller's columns (the keys biased
as they are read, the rider as it is, the index or the join's tie made from
the row, the pads past n) and the last launch writes the keys back
unbiased.  Here:

  * the plain version of that load, ``source_planes_ref``, equals bit for
    bit the PyTorch preparation it replaces: ``ops/sort.py`` ``_key_plane``,
    ``_iota``, ``_rider_planes``, and copies of the join's union planes and
    the distributed sort's shard pads as they were built before (n from 1
    to 3 * 2^13 + 7, 0xFFFFFFFF keys among real ones, views 1..3 rows past
    a 16-byte boundary, every join split from no build row to no probe
    row, any stretch of rows as an arbitrary-N piece reads it);
  * the plain unbiasing store writes the rows that fit, in place or not;
  * whole sorts through the sources (keys, rider, stable, the union, the
    shard, powers of two and the arbitrary-N pieces) equal the sorts of the
    planes PyTorch prepared, every plane bit for bit (tolerance 0);
  * the one rule ``ops/sort._source_load`` by strategy and mode, the
    launches it leads to, and the count of the old preparation on a card.
"""

import numpy as np
import pytest
import torch

from radx_tpu_torch import SortConfig
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.ops import join as tj
from radx_tpu_torch.ops import sort as ts
from radx_tpu_torch.parallel import dist_sort as tds

NS = (1, 2, 1023, 1024, 1025, 4097, 3 * (1 << 13) + 7)
SMALL = SortConfig(chunk_elems=64, finish_elems=256, stable_chunk_elems=16,
                   stable_finish_elems=64, rider_chunk_elems=16,
                   rider_finish_elems=64)
PROBE_TIE = tj.PROBE_TIE


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(rng, n):
    """uint32 keys with 0xFFFFFFFF (the pads' key) and 0 among them."""
    k = rng.integers(0, 2**32, n, dtype=np.uint32)
    k[rng.random(n) < 0.2] = 0xFFFFFFFF
    k[rng.random(n) < 0.05] = 0
    return k


def _view(a: np.ndarray, off: int) -> torch.Tensor:
    """A contiguous tensor of ``a`` whose data starts ``off`` rows past the
    start of its buffer (4 * off bytes past a 16-byte boundary)."""
    buf = torch.empty(a.size + off, dtype=torch.from_numpy(a[:0]).dtype)
    v = buf[off:]
    v.copy_(torch.from_numpy(a))
    return v


def _made(sources, total, row0=0):
    return tb.source_planes_ref(sources, row0, total, "cpu")


def _eq(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# --- the union's and the shard's planes as PyTorch built them ----------------


def _union_planes_before(enc_b, enc_p, total):
    """ops/join.py tagged_union's (key, tie) planes before the network made
    them: two fills, the keys biased into both halves, two aranges."""
    nb, np_ = enc_b.numel(), enc_p.numel()
    n = nb + np_
    key = torch.full((total,), ts._PAD_KEY, dtype=torch.int32)
    key[:nb] = enc_b.view(torch.int32) ^ ts._SIGN
    key[nb:n] = enc_p.view(torch.int32) ^ ts._SIGN
    tie = torch.full((total,), 0x7FFFFFFF, dtype=torch.int32)
    tie[:nb] = torch.arange(nb, dtype=torch.int32)
    tie[nb:n] = torch.arange(np_, dtype=torch.int32) + PROBE_TIE
    return [key, tie]


def _shard_planes_before(shard, me, m, stable):
    """parallel/dist_sort.py's local planes before the network made them:
    the keys biased, the global index, each padded by ``_plane_fill``."""
    num_cmp = 2 if stable else 1
    planes = [shard.view(torch.int32) ^ ts._SIGN]
    if stable:
        planes.append(torch.arange(me * m, me * m + m, dtype=torch.int32))
    total = tds._pow2_pad(m)
    out = []
    for i, p in enumerate(planes):
        buf = torch.full((total,), tds._plane_fill(i, num_cmp),
                         dtype=torch.int32)
        buf[:m] = p
        out.append(buf)
    return out


# --- the plain load against the preparation ----------------------------------


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("off", (0, 1, 2, 3))
def test_key_and_index_sources_match_key_plane_and_iota(n, off):
    rng = np.random.default_rng(n + off)
    k = _keys(rng, n)
    keys = _view(k, off)
    for total in (ts._pad_len(n), -(-n // 16) * 16 + 32):
        key, idx = _made([tb.key_source(keys), tb.index_source(total)],
                         total)
        assert _eq(key, ts._key_plane(keys, total)), (n, off, total)
        assert _eq(idx, ts._iota(total, "cpu"))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("neutral", (0, -1, 0x7FFFFFFF, -(1 << 31), 12345))
def test_rider_sources_match_rider_planes(n, neutral):
    rng = np.random.default_rng(n)
    k = _keys(rng, n)
    v = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    off = n % 4
    keys, vals = _view(k, off), _view(v, 3 - off)
    total = ts._pad_len(n)
    got = _made(ts._rider_sources(keys, vals, neutral), total)
    want = ts._rider_planes(keys, vals, total, neutral)
    assert all(_eq(a, b) for a, b in zip(got, want)), (n, neutral)


@pytest.mark.parametrize("n", NS[1:])
def test_union_sources_match_the_union_planes(n):
    rng = np.random.default_rng(7 * n)
    k = _keys(rng, n)
    for nb in sorted({0, 1, 5 % (n + 1), n - 1, n}):
        b, p = _view(k[:nb], nb % 4), _view(k[nb:], (nb + 1) % 4)
        for total in (ts._pad_len(n), -(-n // 16) * 16):
            got = _made(tj.union_sources(b, p), total)
            want = _union_planes_before(b, p, total)
            assert all(_eq(a, c) for a, c in zip(got, want)), (n, nb, total)


@pytest.mark.parametrize("m", (1, 1023, 1025, 4097))
@pytest.mark.parametrize("stable", (False, True))
def test_shard_sources_match_plane_fill(m, stable):
    rng = np.random.default_rng(m)
    shard = _view(_keys(rng, m), m % 4)
    for me in (0, 3):
        sources = [tb.key_source(shard)]
        if stable:
            sources.append(tb.index_source(
                m, add=(me * m, me * m), pad=tds._plane_fill(1, 2)))
        got = _made(sources, tds._pow2_pad(m))
        want = _shard_planes_before(shard, me, m, stable)
        assert all(_eq(a, b) for a, b in zip(got, want)), (m, stable, me)


@pytest.mark.parametrize("n", (1025, 3 * (1 << 13) + 7))
def test_stretches_make_the_whole(n):
    """A piece of the arbitrary-N path reads rows [row0, row0 + rows): the
    stretches cut anywhere give the whole planes; only the last holds
    pads."""
    rng = np.random.default_rng(n)
    k = _keys(rng, n)
    total = -(-n // 64) * 64 + 64
    nb = n // 3
    b, p = _view(k[:nb], 1), _view(k[nb:], 2)
    for sources in (tj.union_sources(b, p),
                    [tb.key_source(_view(k, 3)), tb.index_source(total)]):
        whole = _made(sources, total)
        cuts = [0, 64, 64 + 512, total - 64, total]
        parts = [_made(sources, b_ - a, a) for a, b_ in zip(cuts, cuts[1:])]
        for j, w in enumerate(whole):
            assert _eq(torch.cat([q[j] for q in parts]), w)


def test_sources_are_checked():
    x = torch.zeros(64, dtype=torch.int32)
    keys = torch.arange(10, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="32-bit"):
        tb.key_source(torch.arange(10, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        tb.key_source(keys[::2])
    with pytest.raises(ValueError, match="one source a plane"):
        tb.chunk_sort_sources(x, 16, [tb.key_source(keys)] * 2)
    bad = tb.Source((keys.view(torch.int32),), 11, tb.SIGN, split=10)
    with pytest.raises(ValueError, match="bad source"):
        tb.chunk_sort_sources(x, 16, [bad])
    with pytest.raises(ValueError, match="no source load"):
        tb.chunk_sort_sources(x, 16, [tb.key_source(keys)] * 3,
                              lex=[x.clone(), x.clone()])
    with pytest.raises(ValueError, match="no source load"):
        tb.finish(x, 16, 6, lex=[x.clone(), x.clone()], key_out=(x, 0))


# --- the unbiasing store ------------------------------------------------------


def test_unbiasing_store_writes_the_rows_that_fit():
    plane = torch.arange(-8, 8, dtype=torch.int32)
    for rows, row in ((16, 0), (10, 0), (10, 4), (3, 8)):
        out = torch.full((rows,), 7, dtype=torch.int32)
        tb._store_key((out, row), plane)
        m = max(min(rows - row, 16), 0)
        assert torch.equal(out[row: row + m], plane[:m] ^ tb.SIGN)
        assert bool((out[:row] == 7).all())
    same = plane.clone()
    tb._store_key((same, 0), same.clone())  # in place
    assert torch.equal(same, plane ^ tb.SIGN)


@pytest.mark.parametrize("mode", ((1, 1), (1, 2), (2, 2)))
def test_last_launches_store_the_keys_unbiased(mode):
    """chunk_sort (one chunk) and finish with ``key_out``: plane 0's rows
    go unbiased to the output, in place or into n rows; the other planes
    stay in place; out of place, plane 0 is left as it was."""
    ncmp, p = mode
    rng = np.random.default_rng(p + ncmp)
    n = 256
    base = [torch.from_numpy(rng.integers(-8, 8, n).astype(np.int32))
            for _ in range(p)]
    if ncmp == 2:
        base[1] = torch.from_numpy(rng.permutation(n).astype(np.int32))
    k, rd, lx = tb._keywords(base, ncmp)
    for fn, args, ref in (
            (tb.finish, (64, 8), lambda: tb.finish_ref(k, 64, 8, rider=rd,
                                                       lex=lx)),
            (tb.chunk_sort, (n,), lambda: tb.chunk_sort_ref(k, n, rider=rd,
                                                            lex=lx))):
        want = ref()
        want = want if isinstance(want, tuple) else (want,)
        for out_rows in (None, n - 37):
            planes = [q.clone() for q in base]
            out = planes[0] if out_rows is None else torch.zeros(
                out_rows, dtype=torch.int32)
            k2, rd2, lx2 = tb._keywords(planes, ncmp)
            if fn is tb.finish:
                fn(k2, *args, rider=rd2, lex=lx2, key_out=(out, 0))
            else:
                made = [tb.column_source(q, 0) for q in base]
                tb.chunk_sort_sources(k2, n, made, rider=rd2, lex=lx2,
                                      key_out=(out, 0))
            m = out.numel()
            assert torch.equal(out, want[0][:m] ^ tb.SIGN)
            assert all(torch.equal(a, b) for a, b in
                       zip(planes[1:], want[1:]))
            if out_rows is not None and fn is tb.finish:
                assert torch.equal(planes[0], base[0])


# --- whole sorts through the sources against the prepared planes ------------


def _decomposed(monkeypatch):
    """Route 763 .. 5127-row sorts through the arbitrary-N pieces."""
    monkeypatch.setattr(ts, "_worth_decomposing", lambda n: n > 700)


@pytest.mark.parametrize("n", (1000, 1025, 4097))
@pytest.mark.parametrize("pieces", (False, True))
def test_sorts_from_sources_equal_sorts_of_prepared_planes(monkeypatch, n,
                                                            pieces):
    """``sort``, the rider sort, the stable sort, the union and the shard's
    local sort, each through the sources and through PyTorch's preparation
    (the same network on the planes ``_key_plane`` & co. made): every plane
    bit for bit, the keys unbiased."""
    if pieces:
        _decomposed(monkeypatch)
    rng = np.random.default_rng(n + pieces)
    keys = _view(_keys(rng, n), n % 4)
    vals = _view(rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                 .astype(np.int32), 1)
    cfg = SMALL
    # keys
    got = ts._sort_arbn_keys(keys, cfg, n) if pieces else ts._sort_keys(
        keys, cfg, n)
    assert _eq(got, torch.from_numpy(np.sort(keys.numpy())))
    assert got.numel() == n and got.dtype == torch.uint32
    # rider: all padded rows, the pads' riders neutral (-7)
    gk, gv = ts._sort_rider(keys, vals, cfg, n, -7)
    if pieces:
        blocks, _ = ts._decompose_blocks(n, cfg.rider_chunk_elems)
        total = blocks * cfg.rider_chunk_elems
    else:
        total = ts._pad_len(n)
    kp, pp = ts._rider_planes(keys, vals, total, -7)
    assert gk.numel() == total and gv.numel() == total
    order = np.lexsort((pp.numpy(), kp.numpy()))
    want_k = (kp.numpy()[order] ^ np.int32(ts._SIGN)).view(np.uint32)
    assert np.array_equal(gk.numpy(), want_k)
    # riders: each key's group of riders, in any order within the group
    pairs_got = sorted(zip(gk.numpy().tolist(), gv.numpy().tolist()))
    pairs_want = sorted(zip(want_k.tolist(), pp.numpy()[order].tolist()))
    assert pairs_got == pairs_want
    # stable (key, index): the whole planes, unbiased keys of n rows
    planes = ts._stable(keys, [vals], cfg, n, unbias=True)
    o = np.argsort(keys.numpy(), kind="stable")
    assert np.array_equal(planes[0].numpy(), keys.numpy()[o])
    assert np.array_equal(planes[1][:n].numpy(), o)
    assert np.array_equal(planes[2][:n].numpy(), vals.numpy()[o])
    biased = ts._stable(keys, [], cfg, n)
    assert np.array_equal(
        (biased[0][:n].numpy() ^ np.int32(ts._SIGN)).view(np.uint32),
        keys.numpy()[o])
    # pads' index plane: the rows past n in their order
    assert np.array_equal(biased[1][n:].numpy(),
                          np.arange(n, biased[1].numel()))


def _old_union(b, p, cfg):
    n = b.numel() + p.numel()
    chunk, fin = cfg.lex_tiles(2)
    if ts._worth_decomposing(n):
        blocks, sizes = ts._decompose_blocks(n, chunk)
        planes = _union_planes_before(b, p, blocks * chunk)
        ts._sort_pieces(planes, sizes, chunk, fin, cfg, 2, network=True)
    else:
        planes = _union_planes_before(b, p, ts._pad_len(n))
        ts._lex_sort(planes, cfg)
    return [q[:n] for q in planes]


@pytest.mark.parametrize("pieces", (False, True))
@pytest.mark.parametrize("strategy", ("bitonic", "lax", "radix"))
def test_union_from_sources_equals_the_prepared_union(monkeypatch, pieces,
                                                      strategy):
    if pieces:
        _decomposed(monkeypatch)
    rng = np.random.default_rng(3 + pieces)
    n = 1999
    k = _keys(rng, n)
    cfg = SortConfig(strategy=strategy, stable_chunk_elems=16,
                     stable_finish_elems=64)
    for nb in (0, 1, 700, n):
        b, p = _view(k[:nb], 1), _view(k[nb:], 2)
        vb = torch.arange(nb, dtype=torch.int32)
        vp = torch.arange(n - nb, dtype=torch.int32) - 5
        got = tj.tagged_union(b, vb, p, vp, cfg)
        want = _old_union(b, p, cfg)
        assert _eq(got[0], want[0]) and _eq(got[1], want[1]), (nb, strategy)


@pytest.mark.parametrize("stable", (False, True))
def test_shard_sort_from_sources_equals_the_padded_shard(stable):
    rng = np.random.default_rng(11 + stable)
    m, me = 1500, 2
    shard = _view(_keys(rng, m), 3)
    cfg = SMALL
    num_cmp = 2 if stable else 1
    sources = [tb.key_source(shard)]
    if stable:
        sources.append(tb.index_source(m, add=(me * m, me * m),
                                       pad=tds._plane_fill(1, 2)))
    got = tds._local_sort_sources(sources, m, "cpu", cfg, num_cmp)
    planes = _shard_planes_before(shard, me, m, stable)
    want = tds._local_sort_planes([q[:m] for q in planes], m, cfg, num_cmp)
    assert all(_eq(a, b) for a, b in zip(got, want))


# --- the rule, the launches and the count --------------------------------------


def test_the_rule_by_strategy_and_mode():
    rule = ts._source_load
    radix = SortConfig(strategy="radix")
    for planes, ncmp in ((1, 1), (2, 1), (2, 2)):
        assert rule(SortConfig(), planes, ncmp)
        assert not rule(SortConfig(strategy="lax"), planes, ncmp)
        assert rule(SortConfig(strategy="lax"), planes, ncmp, network=True)
        # the radix sort makes its planes in its own first and last
        # launches too (and its overflow fallback, the network, from the
        # same sources), whether or not its plan takes the rows
        assert rule(radix, planes, ncmp)
        assert rule(radix, planes, ncmp, network=True)
    for planes, ncmp in ((3, 2), (4, 2), (8, 2)):
        assert not rule(SortConfig(), planes, ncmp, network=True)
        assert not rule(radix, planes, ncmp)
    assert tb.SOURCE_MODES == ((1, 1), (1, 2), (2, 2))
    assert tb.source_kernels(2, 2) == ("chunk_sort/src/lex2",
                                       "finish/unbias/lex2")


def _recorded(monkeypatch, run):
    seen = []
    monkeypatch.setattr(tb, "_on_cuda", lambda *a, **k: True)
    monkeypatch.setattr(tb._build, "launch",
                        lambda counts, name, fn, dev, *args:
                        seen.append((name, fn, args)))
    run()
    return seen


@pytest.mark.parametrize("mode", ((1, 1), (1, 2), (2, 2)))
def test_a_sort_from_sources_launches_its_edges(monkeypatch, mode):
    """On the card's launch path (recorded, shapes only): the chunk sort's
    source form first, on the compile-time plan at the mode's tile, its
    sources packed ten fields a plane; the unbiasing finish last, into n
    rows of the output; no other launch writes the output."""
    ncmp, p = mode
    chunk, fin = SortConfig().mode_tiles(p, ncmp)
    total = fin << 4
    n = total - 3
    planes = [torch.empty(total, dtype=torch.int32, device="meta")
              for _ in range(p)]
    keys = torch.empty(n, dtype=torch.uint32, device="meta")
    out = torch.empty(n, dtype=torch.int32, device="meta")
    sources = [tb.key_source(keys), tb.index_source(total)][:p]
    seen = _recorded(monkeypatch, lambda: tb.sort_sources(
        sources, planes, ncmp, chunk, fin, key_out=(out, 0)))
    names = [name for name, _, _ in seen]
    sfx = tb._suffix(ncmp, p)
    assert names[0] == f"chunk_sort/src{sfx}" and names[-1] == (
        f"finish/unbias{sfx}")
    assert not any("src" in x or "unbias" in x for x in names[1:-1])
    _, fn, args = seen[0]
    assert fn == "radx_chunk_sort_src" and args[-1] == 1  # compile-time
    fields = list(args[6])
    assert len(fields) == 10 * p
    assert fields[:10][3:6] == [n, n, tb.SIGN]  # n, split, xor
    assert fields[8] == tb.PAD_KEY and fields[9] == 0
    if p == 2 and ncmp == 2:
        assert fields[10] == 1 and fields[19] == 1  # an index; pad = row
    _, fn, args = seen[-1]
    assert fn == "radx_finish_out" and args[-1] == 1
    assert args[8] == n and args[9] == tb.SIGN  # key_rows, key_xor


def test_the_old_preparation_is_counted_on_a_card_only():
    class Card:
        is_cuda = True

    ts.reset_prep_counts()
    ts.count_prep("_key_plane", torch.zeros(1))
    assert not any(ts.PREP_CALLS.values())
    ts.count_prep("_key_plane", Card())
    assert ts.PREP_CALLS["_key_plane"] == 1
    ts.reset_prep_counts()
    assert not any(ts.PREP_CALLS.values())
    assert set(ts.PREP_CALLS) == {"_key_plane", "_unbias", "_iota",
                                  "_rider_planes", "_payload_plane",
                                  "_local_sort_planes"}
