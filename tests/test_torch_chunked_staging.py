"""The streaming operators' staged copies (radx_tpu_torch/ops/_staging.py)
on the CPU, with a ring of two pieces of 96 four-byte rows, so that the
pieces wrap the ring many times inside one slab.

Every output is held bit for bit against the port's own result with one
piece for the whole call (the piece size at least n), and one case of each
operator against the JAX package's (radx_tpu/ops/chunked.py, Pallas in
interpret mode, ``chunk_rows=8``, one JAX call a case).  On the CPU the
kernel wrappers run their plain PyTorch versions, and the ring is ordinary
host memory with no stream: the piece arithmetic, the ring's reuse and the
offsets are the code under test.
"""

import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import chunked as jc
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.ops import _staging
from radx_tpu_torch.ops import chunked as tc

JCFG = JaxSortConfig(chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SLAB = 1024
N = 5 * SLAB + 7  # six slabs, the last ragged; eight sorted runs
PIECE_ROWS = 96  # four-byte rows a piece: neither a divisor of SLAB nor of N

torch.set_num_threads(1)


@pytest.fixture
def tiny_ring(monkeypatch):
    monkeypatch.setattr(_staging, "PIECE_BYTES", 4 * PIECE_ROWS)
    monkeypatch.setattr(_staging, "RING", 2)
    _staging.reset_stats()


def _one_piece(monkeypatch, fn, n):
    """``fn()`` with one piece holding every row of the call."""
    with monkeypatch.context() as m:
        m.setattr(_staging, "PIECE_BYTES", 8 * max(n, 1))
        return fn()


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.view(np.uint8).tobytes()


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits(g) == _bits(w)


# --- the piece schedule ------------------------------------------------------


@pytest.mark.parametrize("itemsize", [1, 4, 8])
@pytest.mark.parametrize("piece_bytes", [8, 384, 386, 4096])
@pytest.mark.parametrize("n", [0, 1, 95, 96, 97, 1000])
def test_spans_cover_every_row_once_in_order(n, itemsize, piece_bytes):
    pieces = _staging.spans(n, itemsize, piece_bytes)
    rows = [r for lo, hi in pieces for r in range(lo, hi)]
    assert rows == list(range(n))
    assert all(0 < (hi - lo) * itemsize <= piece_bytes for lo, hi in pieces)
    assert all(hi - lo == piece_bytes // itemsize for lo, hi in pieces[:-1])


def test_spans_reject_a_row_wider_than_a_piece():
    with pytest.raises(ValueError):
        _staging.spans(4, 8, 4)


def _offsets(base, calls):
    """(byte offset into ``base``, bytes) of each view in ``calls``."""
    return [(v.ctypes.data - base.ctypes.data, v.nbytes) for v in calls]


@pytest.mark.parametrize("dtype", [np.bool_, np.uint32, np.float32])
@pytest.mark.parametrize("n", [1, 95, 96, 1000])
def test_every_row_is_copied_once_in_order_to_its_offset(tiny_ring,
                                                         monkeypatch, n,
                                                         dtype):
    """put then get through a ring of two pieces: the host copies read the
    source's bytes once each, in order, and write the output's bytes once
    each, in order; the rows land at their offsets."""
    rng = np.random.default_rng(n)
    src = (rng.integers(0, 2, n) if dtype is np.bool_
           else rng.integers(0, 2**31, n)).astype(dtype)
    out = np.zeros(n + 2, dtype)[1:-1]  # a view at an offset
    seen = []
    real = _staging._Ring.host_copy

    def spy(self, dst, s):
        seen.append((dst, s))
        real(self, dst, s)

    monkeypatch.setattr(_staging._Ring, "host_copy", spy)
    with _staging.Staging("cpu") as st:
        dev = st.empty(n, _staging.torch_dtype(np.dtype(dtype)))
        st.put(src, dev)
        st.handoff(dev)
        ups = [s for _, s in seen]
        seen.clear()
        st.get(dev, out)
        st.wait()
        downs = [d for d, _ in seen]
    want = [(lo * src.itemsize, (hi - lo) * src.itemsize) for lo, hi in
            _staging.spans(n, src.itemsize, 4 * PIECE_ROWS)]
    assert _offsets(src.view(np.uint8), ups) == want
    assert _offsets(out.view(np.uint8), downs) == want
    np.testing.assert_array_equal(out, src)
    assert _staging.STATS["pieces_up"] == _staging.STATS["pieces_down"] == len(want)
    assert _staging.STATS["pinned_pieces"] == 0  # no card, no stream


def test_put_and_get_reject_mismatched_rows(tiny_ring):
    with _staging.Staging("cpu") as st:
        dev = st.empty(10, torch.int32)
        with pytest.raises(ValueError):
            st.put(np.zeros(9, np.int32), dev)
        with pytest.raises(ValueError):
            st.put(np.zeros(10, np.int64), dev)
        with pytest.raises(ValueError):
            st.get(dev, np.zeros(11, np.int32))


def test_queued_gets_write_their_outputs_by_wait(tiny_ring):
    """Downloads run on the download thread in the order queued; ``wait``
    returns when every output is written, and the context manager waits
    too."""
    srcs = [torch.arange(i, i + 7 * PIECE_ROWS + i, dtype=torch.int32)
            for i in range(5)]
    with _staging.Staging("cpu") as st:
        outs = [st.fetch(t) for t in srcs]
        st.wait()
        for o, t in zip(outs, srcs):
            np.testing.assert_array_equal(o, t.numpy())
        late = st.fetch(srcs[0] * 3)
    np.testing.assert_array_equal(late, srcs[0].numpy() * 3)


def test_a_failed_download_raises_at_wait(tiny_ring, monkeypatch):
    def broken(self, dst, src):
        raise OSError("host copy failed")

    with _staging.Staging("cpu") as st:
        out = np.zeros(10, np.int32)
        monkeypatch.setattr(_staging._Ring, "host_copy", broken)
        st.get(torch.arange(10, dtype=torch.int32), out)
        with pytest.raises(OSError):
            st.wait()


def test_stats_under_thread_switches(tiny_ring):
    """Uploads on this thread and downloads on the download thread add to
    ``STATS`` at once: with a short switch interval no count is lost."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rows = 3 * PIECE_ROWS + 5
        src = np.arange(rows, dtype=np.int32)
        with _staging.Staging("cpu") as st:
            outs = []
            for _ in range(40):
                dev = st.upload(src)
                outs.append(st.fetch(dev))
        per = len(_staging.spans(rows, 4, 4 * PIECE_ROWS))
        assert _staging.STATS["pieces_up"] == _staging.STATS["pieces_down"] == 40 * per
        assert _staging.STATS["bytes_down"] == 40 * src.nbytes
        for o in outs:
            np.testing.assert_array_equal(o, src)
    finally:
        sys.setswitchinterval(old)


# --- filter_chunked ----------------------------------------------------------


def _filter_input(n, density, mask_dtype, seed):
    rng = np.random.default_rng(seed)
    keep = rng.random(n) < density
    if mask_dtype == "bool":
        mask = keep
    else:  # int32 with values other than 0 and 1: mask != 0 keeps (F5)
        mask = np.where(keep, rng.choice([1, 7, -1], n), 0).astype(np.int32)
    cols = [rng.integers(0, 2**32, n, dtype=np.uint32),
            rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32),
            (rng.standard_normal(n) * 100).astype(np.float32)]
    return mask, cols


FILTER_CASES = {
    "ragged_bool": (N, 0.5, "bool"),
    "ragged_int32": (N, 0.3, "int32"),
    "below_one_piece": (50, 0.5, "bool"),
    "all_kept": (3 * SLAB + 41, 1.0, "int32"),
    "none_kept": (3 * SLAB + 41, 0.0, "bool"),
    "one_slab_exactly": (SLAB, 0.5, "int32"),
}


@pytest.mark.parametrize("case", FILTER_CASES)
def test_filter_chunked_staged_equals_one_piece(tiny_ring, monkeypatch, case):
    n, density, mask_dtype = FILTER_CASES[case]
    mask, cols = _filter_input(n, density, mask_dtype, seed=len(case))
    got, count = tc.filter_chunked(mask, cols, CFG, slab=SLAB, device="cpu")
    per_slab = [min(SLAB, n - lo) for lo in range(0, n, SLAB)]
    up = sum(len(_staging.spans(m, s, 4 * PIECE_ROWS)) for m in per_slab
             for s in (mask.itemsize, 4, 4, 4))
    assert _staging.STATS["pieces_up"] == up
    assert _staging.STATS["bytes_up"] == mask.nbytes + sum(c.nbytes for c in cols)
    assert _staging.STATS["bytes_down"] == sum(g.nbytes for g in got)
    want, wcount = _one_piece(monkeypatch, lambda: tc.filter_chunked(
        mask, cols, CFG, slab=SLAB, device="cpu"), n)
    assert count == wcount == int((mask != 0).sum())
    _same_bits(got, want)
    _same_bits(got, [c[mask != 0] for c in cols])


def test_filter_chunked_strided_columns_and_count_only(tiny_ring):
    mask, cols = _filter_input(2 * N, 0.5, "bool", seed=11)
    strided = [c[::2] for c in cols]
    (a, b, c), count = tc.filter_chunked(mask[::2], strided, CFG, slab=SLAB,
                                         device="cpu")
    keep = mask[::2]
    _same_bits([a, b, c], [s[keep] for s in strided])
    outs, total = tc.filter_chunked(mask, [], CFG, slab=SLAB, device="cpu")
    assert outs == [] and total == int(mask.sum())


def test_filter_chunked_empty_input(tiny_ring):
    empty = np.zeros(0, np.int32)
    got, count = tc.filter_chunked(empty, [empty.view(np.uint32), empty],
                                   CFG, slab=SLAB, device="cpu")
    assert count == 0
    _same_bits(got, [np.empty((0,)), np.empty((0,))])  # float64, as JAX's


def test_filter_chunked_staged_matches_jax(tiny_ring):
    mask, cols = _filter_input(N, 0.4, "bool", seed=3)
    want, wcount = jc.filter_chunked(mask, cols, JCFG, slab=SLAB)
    got, count = tc.filter_chunked(mask, cols, CFG, slab=SLAB, device="cpu")
    assert count == wcount
    _same_bits(got, [np.asarray(w) for w in want])


# --- groupby_chunked ---------------------------------------------------------


def _group_input(n, distinct, vdtype, seed):
    rng = np.random.default_rng(seed)
    keys = (rng.permutation(n).astype(np.uint32) if distinct is None
            else rng.integers(0, distinct, n, dtype=np.uint32))
    if vdtype == "float32":
        vals = (rng.standard_normal(n) * 100).astype(np.float32)
    else:
        vals = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(vdtype)
    return keys, vals


GROUP_CASES = {
    # 6 slabs of 64 partials, grouped again in one slab
    "recursion_sum_u32": (N, 64, "uint32", "sum"),
    "recursion_count_i32": (N, 64, "int32", "count"),
    "recursion_min_f32": (N, 64, "float32", "min"),
    "recursion_sum_f32": (N, 64, "float32", "sum"),
    # every key distinct: the partials do not shrink, _host_merge ends
    "host_merge_max_u32": (N, None, "uint32", "max"),
    "one_slab": (SLAB - 3, 100, "int32", "max"),
    "below_one_piece": (50, 7, "uint32", "sum"),
}


@pytest.mark.parametrize("case", GROUP_CASES)
def test_groupby_chunked_staged_equals_one_piece(tiny_ring, monkeypatch,
                                                 case):
    n, distinct, vdtype, agg = GROUP_CASES[case]
    keys, vals = _group_input(n, distinct, vdtype, seed=len(case))
    got = tc.groupby_chunked(keys, vals, agg, CFG, slab=SLAB, device="cpu")
    want = _one_piece(monkeypatch, lambda: tc.groupby_chunked(
        keys, vals, agg, CFG, slab=SLAB, device="cpu"), n)
    groups = np.unique(keys)
    assert got[2] == want[2] == groups.size
    _same_bits(got[:2], want[:2])
    np.testing.assert_array_equal(got[0], groups)


def test_groupby_chunked_empty_input(tiny_ring):
    empty = np.zeros(0, np.uint32)
    uk, out, ng = tc.groupby_chunked(empty, empty, "sum", CFG, slab=SLAB,
                                     device="cpu")
    assert ng == 0
    _same_bits([uk, out], [empty, empty])


def test_groupby_chunked_staged_matches_jax(tiny_ring):
    keys, vals = _group_input(N, 64, "uint32", seed=2)
    want = jc.groupby_chunked(keys, vals, "sum", JCFG, slab=SLAB)
    got = tc.groupby_chunked(keys, vals, "sum", CFG, slab=SLAB, device="cpu")
    assert got[2] == want[2] == 64
    _same_bits(got[:2], [np.asarray(w) for w in want[:2]])


# --- sort_chunked ------------------------------------------------------------


@pytest.mark.parametrize("n", [N, SLAB - 3, 0])
def test_sort_chunked_staged_equals_one_piece(tiny_ring, monkeypatch, n):
    """N: eight runs of a slab, three merge levels; below a slab: ``sort``;
    empty input."""
    keys = np.random.default_rng(5).integers(0, 2**32, n, dtype=np.uint32)
    keys[::97] = 0xFFFFFFFF  # real keys equal to the fill
    got = tc.sort_chunked(keys, CFG, slab=SLAB, device="cpu")
    want = _one_piece(monkeypatch, lambda: tc.sort_chunked(
        keys, CFG, slab=SLAB, device="cpu"), 8 * SLAB)
    _same_bits([got], [want])
    _same_bits([got], [np.sort(keys)])


def test_sort_chunked_staged_matches_jax(tiny_ring):
    keys = np.random.default_rng(8).integers(0, 2**32, N, dtype=np.uint32)
    want = jc.sort_chunked(keys, JCFG, slab=SLAB)
    got = tc.sort_chunked(keys, CFG, slab=SLAB, device="cpu")
    _same_bits([got], [np.asarray(want)])
