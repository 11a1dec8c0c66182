"""The radix sort's planes made in its own first and last launches
(radx_tpu_torch/kernels/radix_sort.py ``sort_radix(..., sources=)``; K4's
source form ``chunk_sort_cyclic_kernel`` over ``CyclicSources`` in
csrc/bitonic_io.cu, K13's unbiasing form ``radix_concat_kernel`` over
``ConcatKeyOut`` in csrc/radix.cu), on the CPU, tolerance 0 throughout:

  (a) a model of K4's first load from sources (``rows_from_sources`` through
      the block-cyclic map): every source row read once, the loaded tiles
      the cyclic view of ``source_planes_ref``'s planes (the pads, the index
      made from the row, the join's two key columns, a piece's ``row0``),
      int4 runs only where they lie inside a column, below n, at a 16-byte
      aligned address;
  (b) ``sort_radix`` from sources against ``sort_radix`` of the planes that
      PyTorch prepared, bit for bit: keys, (key, rider) with the pads as
      real rows, lex2, ragged, a piece, overflowing keys; the digit totals
      and the sentinel count read from the key source against those of the
      prepared plane; K13's unbiasing store in place and into fewer rows;
  (c) the entry points under ``strategy="radix"`` against the JAX package's
      (Pallas in interpret mode), with PyTorch's preparation made to raise,
      at the radix geometry of tests/test_torch_radix_sort.py (radix chunks
      of 32 rows of 128 keys, 16384 keys: both packages' chunk choice
      patched to the base, which at 16384 keys would double it and leave the
      network), three JAX calls.
"""

import collections

import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.kernels import radix_sort as jrs
from radx_tpu.ops import sort as js
from radx_tpu.ops.groupby import groupby as j_groupby
from radx_tpu_torch import SortConfig, argsort, groupby, sort, sort_pairs
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.kernels import msd as tm
from radx_tpu_torch.kernels import radix_sort as trs
from radx_tpu_torch.ops import sort as ts

C_ROWS, N = 32, 16384
C = C_ROWS * 128
TILES = dict(chunk_elems=1024, finish_elems=2048, rider_chunk_elems=1024,
             rider_finish_elems=2048, stable_chunk_elems=1024,
             stable_finish_elems=2048)
CFG = SortConfig(strategy="radix", **TILES)  # span passes below the chunk
SIGN = tb.SIGN


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _view(a: np.ndarray, off: int) -> torch.Tensor:
    """A contiguous int32 tensor of ``a`` whose data starts ``off`` rows
    past a 16-byte boundary."""
    buf = torch.empty(a.size + 4, dtype=torch.int32)
    v = buf[off: off + a.size]
    v.copy_(torch.from_numpy(a.view(np.int32)))
    return v


def _keys(rng, n, span=2**32):
    """uint32 keys with 0xFFFFFFFF (the pads' key) among them."""
    k = rng.integers(0, span, n, dtype=np.uint64).astype(np.uint32)
    k[rng.random(n) < 0.05] = 0xFFFFFFFF
    return k


# --- (a) K4's first load from sources, thread by thread -----------------------


def _cyclic_source_load(sources, row0, n, chunk, log_t, r):
    """The kernel's first load of every tile of K4's source form
    (``rows_from_sources`` over ``CyclicSources``, PH == 0: wlo = 0, runs of
    W = 2^r rows): block b is tile lb = (b << log_t) mod chunk of radix
    chunk c = b >> (log_c - log_t); tile row i is source row row0 +
    Cyclic{lb, c, n_chunks}(i).  A run of a column moves as int4 where it
    lies in one column, below n, at a 16-byte aligned address, else row by
    row; an index is made, not read.  Returns the loaded tiles (planes of
    n rows in block order), per plane the column elements each read
    touched as (column, first, last), and per plane the runs that moved as
    int4."""
    w, t = 1 << r, 1 << log_t
    log_c = chunk.bit_length() - 1
    n_chunks = n // chunk
    cyc = tb.CYCLIC_TILE
    planes, reads, vec = [], [], []
    for s in sources:
        vec.append(0)
        starts = [0]
        for col in s.cols:
            starts.append(starts[-1] + col.numel())
        vals, touched = [], []
        for b in range(n >> log_t):
            lb = (b << log_t) & (chunk - 1)
            c = b >> (log_c - log_t)

            def source(i):
                e = lb + i
                return row0 + ((e // cyc) * n_chunks + c) * cyc + e % cyc

            for gb in range(0, t, w):
                r0 = source(gb)
                assert [source(gb + u) for u in range(w)] == list(
                    range(r0, r0 + w))  # a run lies in one cyclic tile
                second = r0 >= s.split
                k = 1 if second and len(s.cols) > 1 else 0
                at = r0 - starts[k]
                addr = (s.cols[k].data_ptr() + 4 * at) if s.cols else 1
                if (s.cols and r0 + w <= s.n
                        and (second or r0 + w <= s.split)
                        and addr % 16 == 0):
                    touched.append((k, at, at + w - 1))
                    vals += (s.cols[k][at: at + w] ^ s.xor).tolist()
                    vec[-1] += 1
                    continue
                for row in range(r0, r0 + w):
                    if row >= s.n:
                        vals.append(row if s.pad is None else s.pad)
                    elif not s.cols:
                        vals.append(row + s.add[row >= s.split])
                    else:
                        k = int(row >= s.split and len(s.cols) > 1)
                        touched.append((k, row - starts[k], row - starts[k]))
                        vals.append(int(s.cols[k][row - starts[k]]) ^ s.xor)
        planes.append(torch.tensor(vals, dtype=torch.int64).to(torch.int32))
        reads.append(touched)
    return planes, reads, vec


@pytest.mark.parametrize("mode", ("keys", "rider", "lex2", "union"))
@pytest.mark.parametrize("rows, off, row0", ((8192, 0, 0), (8192 - 37, 0, 0),
                                             (8192 - 37, 1, 0),
                                             (8192 + 2000 - 5, 3, 2000),
                                             (8192 - 16 * 40, 2, 0)))
def test_cyclic_source_load_reads_each_row_once(mode, rows, off, row0):
    """K4's source load over 8192 plane rows (radix chunks of 2048, tiles of
    256, 16 rows a thread): the keys biased, a rider padded with its
    neutral, the stable sorts' index, the join's two key columns and tie;
    n a multiple of 16 or not, the column 0..3 rows past a 16-byte
    boundary, a piece from row0 on."""
    n, chunk, log_t, r = 8192, 2048, 8, 4
    rng = np.random.default_rng(rows + off)
    keys = _view(_keys(rng, rows), off)
    if mode == "keys":
        sources = [tb.key_source(keys)]
    elif mode == "rider":
        rider = _view(rng.integers(0, 2**32, rows, dtype=np.uint32),
                      3 - off)
        sources = [tb.key_source(keys), tb.column_source(rider, -7)]
    elif mode == "lex2":
        sources = [tb.key_source(keys), tb.index_source(rows)]
    else:  # the join's union: build keys, then probe keys; its tie
        nb = rows // 3 + off
        probe = _view(keys[nb:].numpy().view(np.uint32), 3 - off)
        sources = [tb.key_source(keys[:nb], probe),
                   tb.index_source(rows, nb, (0, (1 << 30) - nb),
                                   0x7FFFFFFF)]
    loaded, reads, vec = _cyclic_source_load(sources, row0, n, chunk,
                                             log_t, r)
    made = tb.source_planes_ref(sources, row0, n, "cpu")
    for got, want in zip(loaded, made):
        assert torch.equal(got, tb._cyclic_view(want, chunk))
    for j, s in enumerate(sources):
        seen = collections.Counter()
        for k, a, b in reads[j]:
            assert 0 <= a <= b < s.cols[k].numel()
            seen.update((k, i) for i in range(a, b + 1))
        assert all(v == 1 for v in seen.values())
        # every column row of the plane's stretch is read, once
        want_rows = max(min(s.n, row0 + n) - row0, 0) if s.cols else 0
        assert sum(seen.values()) == want_rows
    if mode == "union":
        return

    def runs(offset):
        """int4 runs of a column ``offset`` rows past a 16-byte boundary:
        the 16-row runs (row0 is a multiple of 16) wholly below its end,
        none at an odd offset."""
        return max(0, min(n, rows - row0) // 16) if offset == 0 else 0

    assert vec[0] == runs(off)
    if mode != "keys":
        assert vec[1] == (runs(3 - off) if mode == "rider" else 0)


# --- (b) sort_radix from sources against the prepared planes -----------------


def _prepared(sources, row0=0):
    """The planes that PyTorch prepared before (``source_planes_ref`` is
    held to ``_key_plane`` / ``_iota`` / ``_rider_planes`` bit for bit in
    tests/test_torch_plane_source.py)."""
    return tb.source_planes_ref(sources, row0, N, "cpu")


def _sources(rng, mode, n, off=0, span=2**32):
    keys = _view(_keys(rng, n, span), off)
    if mode == "keys":
        return [tb.key_source(keys)]
    if mode == "rider":
        rider = _view(rng.integers(0, 2**32, n, dtype=np.uint32), 3 - off)
        return [tb.key_source(keys), tb.column_source(rider, 12345)]
    return [tb.key_source(keys), tb.index_source(N)]


CASES = {  # name: (mode, source rows, n_valid, key rows, offset)
    "keys_ragged": ("keys", N - 517, N - 517, N - 517, 1),
    "keys_whole": ("keys", N, N, N, 0),
    "rider_pads": ("rider", N - 1000, N, N, 2),  # group-by: n_valid = total
    "rider_unique": ("rider", N - 3, N - 3, N - 3, 0),  # assume_unique
    "lex2_ragged": ("lex2", N - 1000, N - 1000, N - 1000, 3),
    "lex2_argsort": ("lex2", N - 1000, N - 1000, None, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sort_radix_from_sources_equals_prepared(case):
    mode, rows, nv, key_rows, off = CASES[case]
    ncmp = 2 if mode == "lex2" else 1
    sources = _sources(np.random.default_rng(len(case) + rows), mode, rows,
                       off, span=2**32 if mode != "lex2" else 300)
    want = _prepared(sources)
    res, overflow = trs.sort_radix(want, C, ncmp, CFG, nv)
    assert overflow is False
    tm.reset_counts()
    tb.reset_counts()
    got, overflow = trs.sort_radix(trs.Outputs(N, key_rows), C, ncmp, CFG,
                                   nv, sources)
    assert overflow is False
    assert tb.PLAIN_CALLS["chunk_sort_cyclic_ref"] == 1
    assert tb.PLAIN_CALLS["source_planes_ref"] == 1
    assert tm.PLAIN_CALLS["radix_concat_ref"] == 1
    if key_rows is None:  # argsort: the planes as they are
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    assert got[0].numel() == key_rows
    assert torch.equal(got[0], want[0][:key_rows] ^ SIGN)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    if key_rows == N:  # in place: the key tensor is plane 0 itself
        assert len(got) == len(sources)


@pytest.mark.parametrize("mode", ("keys", "lex2"))
def test_sort_radix_of_a_piece_writes_the_given_planes(mode):
    """The arbitrary-N last piece: sources longer than the piece, read from
    row0 on (the pads past them), into given planes, keys biased (valley
    merges follow)."""
    ncmp = 2 if mode == "lex2" else 1
    row0 = 3 * N
    rng = np.random.default_rng(7)
    keys = _view(_keys(rng, row0 + N - 100), 1)
    sources = [tb.key_source(keys)]
    if mode == "lex2":
        sources.append(tb.index_source(row0 + N))
    want = tb.source_planes_ref(sources, row0, N, "cpu")
    trs.sort_radix(want, C, ncmp, CFG)
    out = [torch.full((N,), 7, dtype=torch.int32) for _ in sources]
    got, overflow = trs.sort_radix(out, C, ncmp, CFG, sources=sources,
                                   row0=row0)
    assert overflow is False and got is out
    assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_overflow_allocates_nothing():
    """All-equal keys overflow a slot: nothing is written or allocated, and
    the caller's fallback (``ops/sort._engine``) sorts from the same
    sources."""
    keys = torch.full((N,), 0x12345678, dtype=torch.int32)
    spec = trs.Outputs(N, N)
    got, overflow = trs.sort_radix(spec, C, 1, CFG, N,
                                   [tb.key_source(keys)])
    assert overflow is True and got is spec
    tm.reset_counts()
    out = ts._engine(spec, CFG, 1, N, [tb.key_source(keys)])
    assert tm.PLAIN_CALLS["radix_pack_ref"] == 0
    assert torch.equal(out[0], keys)


@pytest.mark.parametrize("tail", (False, True))
@pytest.mark.parametrize("rows, row0", ((N, 0), (N - 999, 0), (N + 50, 77),
                                        (2 * N - 5, N)))
def test_counts_from_the_key_source(tail, rows, row0):
    """The digit totals (K10) and the sentinel keys read from the key
    source's rows [row0, row0 + n_valid), with the pads past it at digit
    255, equal those of the plane PyTorch prepared (its first n_valid
    rows), bit for bit."""
    rng = np.random.default_rng(rows + row0)
    keys = _view(_keys(rng, rows), 2)
    p = trs.plan(N, C)
    for nv in (N, N - 3000):
        s = tb.key_source(keys)
        plane = tb.source_planes_ref([s], row0, N, "cpu")[0]
        totals, pads = trs.source_counts(s, p, nv, row0, tail)
        assert torch.equal(totals, trs.digit_totals(plane, p, nv)[-1])
        if tail:
            assert torch.equal(pads, trs.sentinel_keys(plane, nv))
        else:
            assert pads is None


def test_join_columns_count_as_one_source():
    """A key source of two columns (the join's build then probe keys)
    counts as the plane it makes."""
    rng = np.random.default_rng(8)
    b, q = _view(_keys(rng, 5000), 1), _view(_keys(rng, 9000), 3)
    s = tb.key_source(b, q)
    p = trs.plan(N, C)
    plane = tb.source_planes_ref([s], 0, N, "cpu")[0]
    totals, pads = trs.source_counts(s, p, N, 0, True)
    assert torch.equal(totals, trs.digit_totals(plane, p, N)[-1])
    assert torch.equal(pads, trs.sentinel_keys(plane, N))


def test_unbiasing_concat_stores_the_rows_that_fit():
    """K13's unbiasing form (plain version): plane 0 XORed into the key
    rows that fit, the other planes as the plain form writes them, plane 0
    itself not written; None in its place with a second plane."""
    rng = np.random.default_rng(9)
    sources = _sources(rng, "rider", N - 10)
    planes = _prepared(sources)
    p = trs.plan(N, C)
    tiles = CFG.mode_tiles(2, 1)
    sorted_ = tb.sort_chunks_ascending_cyclic(planes, 1, C, *tiles)
    b = trs.rank_runs(*trs.rank_args(sorted_[0], planes[0], p, N, (1024,
                                                                   2048),
                                     True))
    packed = tm.pack(sorted_, b.bounds, C, p.slot, p.nb_pad, 1)
    merged = tb.merge_slots_ascending(packed, 1, C, p.slot, *tiles)
    want = tm.concat_ref(merged, sorted_, b.start, b.src, p.nb_pad, N, 1)
    for rows in (N, N - 5, 0):
        guard = torch.full((rows + 3,), 7, dtype=torch.int32)
        keys = guard[: rows + 2]  # rows fit from row 2 on
        out = [None, torch.full((N,), 7, dtype=torch.int32)]
        tm.concat(merged, sorted_, out, b.start, b.src, p.nb_pad, 1,
                  (keys, 2))
        assert torch.equal(keys[2:], want[0][:rows] ^ SIGN)
        assert (guard[:2] == 7).all() and guard[-1] == 7
        assert out[0] is None and torch.equal(out[1], want[1])
    with pytest.raises(ValueError):
        tm.concat(merged, sorted_, [None], b.start, b.src, p.nb_pad, 1,
                  (keys, 0))


# --- (c) the entry points against the JAX package -----------------------------

# the network's chunk is the whole array: the overflow branch that the JAX
# package compiles beside the radix sort is one chunk sort
JCFG = JaxSortConfig(strategy="radix", chunk_rows=N // 128,
                     stable_chunk_rows=N // 128, stable2_chunk_rows=N // 128,
                     rider_chunk_rows=N // 128, compact_chunk_rows=8,
                     interpret=True)
PCFG = config_from_jax(JCFG)


def _radix_geometry(monkeypatch):
    """Both packages' radix chunk patched to 32 rows of 128 keys (at 16384
    keys: 4 chunks, slots of 1024)."""
    monkeypatch.setattr(jrs, "pick_chunk_rows", lambda n, base, *a: C_ROWS)
    monkeypatch.setattr(trs, "pick_chunk", lambda n, base, *a: C)


def _no_preparation(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("PyTorch prepared the planes")

    for name in ("_key_plane", "_unbias", "_iota", "_rider_planes",
                 "_payload_plane"):
        monkeypatch.setattr(ts, name, refuse)


def _radix_ran():
    ran = (tm.PLAIN_CALLS["radix_concat_ref"] > 0
           and tb.PLAIN_CALLS["source_planes_ref"] > 0)
    tm.reset_counts()
    tb.reset_counts()
    return ran


def test_sort_argsort_and_sort_pairs_match_jax(monkeypatch):
    """One JAX call, the stable ``argsort`` of ragged keys with ties: the
    permutation that ``argsort`` returns and that gives ``sort``'s keys and
    stable ``sort_pairs``' keys and payload."""
    _radix_geometry(monkeypatch)
    rng = np.random.default_rng(21)
    n = N - 517
    keys = _keys(rng, n, 5000)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    perm = np.asarray(js.argsort(keys, JCFG))
    _no_preparation(monkeypatch)
    tm.reset_counts()
    got = argsort(keys, PCFG, device="cpu")
    assert _radix_ran()
    np.testing.assert_array_equal(got.numpy(), perm)
    np.testing.assert_array_equal(sort(keys, PCFG, device="cpu").numpy(),
                                  keys[perm])
    assert _radix_ran()
    gk, gv = sort_pairs(keys, vals, PCFG, device="cpu")
    assert _radix_ran()
    np.testing.assert_array_equal(gk.numpy(), keys[perm])
    np.testing.assert_array_equal(gv.numpy(), vals[perm])


def test_sort_pairs_assume_unique_matches_jax(monkeypatch):
    _radix_geometry(monkeypatch)
    rng = np.random.default_rng(22)
    n = N - 3
    keys = rng.permutation(N - 1)[:n].astype(np.uint32) * np.uint32(7)
    vals = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    wk, wv = (np.asarray(x) for x in js.sort_pairs(keys, vals, JCFG,
                                                   assume_unique=True))
    _no_preparation(monkeypatch)
    tm.reset_counts()
    gk, gv = sort_pairs(keys, vals, PCFG, assume_unique=True, device="cpu")
    assert _radix_ran()
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gv.numpy(), wv)


def test_groupby_matches_jax(monkeypatch):
    """The rider sort with 1000 pads as real rows (key 0xFFFFFFFF, the
    neutral rider).  No real key is 0xFFFFFFFF: the JAX radix sort loses
    such rows' riders to the slots' fill (ROADMAP Queue 3, F4), which
    tests/test_torch_radix_sort.py holds on its own."""
    _radix_geometry(monkeypatch)
    rng = np.random.default_rng(23)
    n = N - 1000
    keys = rng.integers(0, 3000, n, dtype=np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    juk, jout, jng = j_groupby(keys, vals, "sum", JCFG)
    g = int(jng)
    _no_preparation(monkeypatch)
    tm.reset_counts()
    uk, out, ng = groupby(keys, vals, "sum", PCFG, device="cpu")
    assert _radix_ran()
    assert int(ng) == g
    np.testing.assert_array_equal(uk[:g].numpy(), np.asarray(juk)[:g])
    np.testing.assert_array_equal(out[:g].numpy(), np.asarray(jout)[:g])
