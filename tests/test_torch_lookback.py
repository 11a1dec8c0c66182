"""The single-pass kernels' decoupled look-back (csrc/compact.cu ``compact``,
csrc/segscan.cu ``segscan``) modelled on the CPU, against the plain
versions.

``compact.compact_lookback`` and ``segscan.segscan_lookback`` run each
kernel's pass in pure torch: tiles claimed in order, the per-tile summary,
and the walk back over the predecessors' status words (``lookback.lookback_stop``),
where what each read sees of a predecessor (A, P, or A then P, possibly
after empty reads) is drawn from a seeded generator.  Tolerances:
compaction, integer scans, float32 min / max and fill bit for bit; float32
sums within 1e-5 times the run's sum of |v| of ``segscan_ref`` (another
order of additions), and bit-identical across visibility patterns (the
kernel's left fold).  No JAX here; torch on one intra-op thread.
"""

import numpy as np
import pytest
import torch

from radx_tpu_torch.kernels import compact as tc
from radx_tpu_torch.kernels import lookback as tlb
from radx_tpu_torch.kernels import segscan as tsg


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensor ops run fastest on one intra-op thread, which also keeps
    them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _i32(rng, n):
    return torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                            .astype(np.int32))


# --- compaction ----------------------------------------------------------------


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_compact_model_matches_plain(planes, density, mask_dtype):
    """Ragged n over many tiles of 16 and 64 rows: outputs (zeros after the
    kept rows) and count bit-equal to ``compact_ref``."""
    rng = np.random.default_rng(planes * 10 + int(density * 2))
    n = 16 * 150 + 7
    keep = rng.random(n) < density
    mask = torch.from_numpy(keep).to(mask_dtype)
    if mask_dtype == torch.int32:
        mask = mask * torch.from_numpy(rng.integers(1, 99, n).astype(np.int32))
    ps = [_i32(rng, n) for _ in range(planes)]
    want, wcount = tc.compact_ref(mask, ps)
    for tile, seed in ((16, 1), (64, 2)):
        outs, count = tc.compact_lookback(mask, ps, tile, _gen(seed))
        assert count.dtype == torch.int32 and count.dim() == 0
        assert int(count) == int(wcount) == int(keep.sum())
        for got, w in zip(outs, want):
            assert torch.equal(got, w)


def test_compact_model_one_row_and_one_tile():
    for n, tile in ((1, 16), (5, 16), (16, 16), (100, 128)):
        mask = torch.arange(n) % 3 != 1
        ps = [torch.arange(n, dtype=torch.int32) * 7]
        outs, count = tc.compact_lookback(mask, ps, tile, _gen(n))
        want, wcount = tc.compact_ref(mask, ps)
        assert int(count) == int(wcount) and torch.equal(outs[0], want[0])


def test_compact_n_valid_and_mask_dtypes():
    """The wrapper's plain path: only rows below n_valid are kept; bool,
    uint8 and int32 masks; other dtypes and a bad n_valid are refused."""
    mask = torch.tensor([1, 0, 3, 1, 1], dtype=torch.int32)
    col = torch.arange(5, dtype=torch.int32)
    for m in (mask, mask != 0, (mask != 0).to(torch.uint8)):
        outs, count = tc.compact(m, [col], 1024,
                                 n_valid=torch.tensor(4, dtype=torch.int32))
        assert int(count) == 3 and outs[0][:3].tolist() == [0, 2, 3]
    with pytest.raises(ValueError, match="mask"):
        tc.compact(mask.float(), [col], 1024)
    with pytest.raises(ValueError, match="n_valid"):
        tc.compact(mask, [col], 1024, n_valid=torch.tensor(4))


# --- segmented scan --------------------------------------------------------------


def _keys(rng, n, groups):
    """Sorted keys: ``groups`` values, one long run across many tiles, and
    0xFFFFFFFF keys at the end (the kernel's key of the rows past n)."""
    k = rng.integers(0, groups, n).astype(np.uint32)
    k[n // 4: n // 2] = groups // 2
    k[-40:] = 0xFFFFFFFF
    return torch.from_numpy(np.sort(k).view(np.int32))


def _vals(rng, n, dtype):
    if dtype == torch.float32:
        v = (rng.standard_normal(n) * 100).astype(np.float32)
        v[rng.integers(0, n, 40)] = rng.choice(
            np.array([0.0, -0.0, np.inf, -np.inf], np.float32), 40)
        v[3] = np.nan
        return torch.from_numpy(v.view(np.int32))
    return _i32(rng, n)


def _float_sum_ok(k, v, got, want):
    absv = tsg.segscan_ref(k, v.view(torch.float32).abs().view(torch.int32),
                           "sum", torch.float32).view(torch.float32)
    err = (got.view(torch.float32) - want.view(torch.float32)).abs()
    return bool((err <= 1e-5 * absv).all())


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segscan_model_matches_plain(op, dtype):
    """Short runs and a run across many tiles, tiles of 32, 64 and 256
    rows (threads of one row and of several)."""
    rng = np.random.default_rng([len(op), tsg.DTYPES[dtype]])
    n = 32 * 120 + 5
    k = _keys(rng, n, 300)
    v = _vals(rng, n, dtype)
    if op == "sum" and dtype == torch.float32:
        v = torch.where(torch.isfinite(v.view(torch.float32)), v,
                        torch.tensor(1.0).view(torch.int32))
    want = tsg.segscan_ref(k, v, op, dtype)
    for tile in (32, 64, 256):
        got = tsg.segscan_lookback(k, v, op, dtype, tile, _gen(tile))
        if op == "sum" and dtype == torch.float32:
            assert _float_sum_ok(k, v, got, want)
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_segscan_model_fill_matches_plain(m):
    rng = np.random.default_rng(70 + m)
    n = 64 * 60 + 3
    k = _keys(rng, n, 200)
    vals = [_i32(rng, n) for _ in range(m)]
    flags = [torch.from_numpy((rng.random(n) < 0.03).astype(np.int32))
             for _ in range(m)]
    wv, wh = tsg.segscan_ref(k, vals, "fill", torch.int32, flags)
    gv, gh = tsg.segscan_lookback(k, vals, "fill", torch.int32, 64, _gen(m),
                                  flags)
    for a, b in zip(gv + gh, wv + wh):
        assert torch.equal(a, b)


@pytest.mark.parametrize("groups", [1, 3, 400])
def test_float_sums_bit_identical_across_visibility(groups):
    """The left fold: whatever each walk saw, every tile's prefix is the same
    float, so the output bits do not depend on the visibility seed."""
    rng = np.random.default_rng(groups)
    n = 32 * 200 + 11
    k = torch.from_numpy(np.sort(rng.integers(0, groups, n).astype(np.int32)))
    v = torch.from_numpy((rng.standard_normal(n) * 1e3).astype(np.float32)
                         .view(np.int32))
    runs = [tsg.segscan_lookback(k, v, "sum", torch.float32, 32, _gen(s))
            for s in range(4)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    assert _float_sum_ok(k, v, runs[0], tsg.segscan_ref(k, v, "sum",
                                                        torch.float32))


@pytest.mark.parametrize("dtype", [torch.uint32, torch.float32])
def test_all_equal_keys_across_hundreds_of_tiles(dtype):
    """One run over 400 tiles (the group-by's pad group at the tail): each
    walk stops only at a P."""
    rng = np.random.default_rng(5)
    n = 32 * 400 + 9
    k = torch.full((n,), -1, dtype=torch.int32)
    v = _vals(rng, n, dtype)
    if dtype == torch.float32:
        v = torch.where(torch.isfinite(v.view(torch.float32)), v,
                        torch.tensor(0.5).view(torch.int32))
    got = tsg.segscan_lookback(k, v, "sum", dtype, 32, _gen(9))
    want = tsg.segscan_ref(k, v, "sum", dtype)
    if dtype == torch.float32:
        assert _float_sum_ok(k, v, got, want)
    else:
        assert torch.equal(got, want)


def test_segscan_model_one_row_and_one_tile():
    for n in (1, 2, 31, 32, 200):
        k = torch.zeros(n, dtype=torch.int32)
        v = torch.arange(n, dtype=torch.int32) - 7
        for op in ("sum", "max"):
            got = tsg.segscan_lookback(k, v, op, torch.int32, 256, _gen(n))
            assert torch.equal(got, tsg.segscan_ref(k, v, op, torch.int32))


# --- the walk itself --------------------------------------------------------------


def test_lookback_stop_follows_the_visibility():
    """The compaction's walk ends at a P; the scan's also at a halting A.
    Different visibility draws end it at different tiles, never past tile
    0 and never before the nearest P-only view."""
    stops = set()
    for seed in range(30):
        u, flag = tlb.lookback_stop(100, lambda _: False, _gen(seed))
        assert 0 <= u <= 99 and flag == tlb.PREFIX
        stops.add(u)
    assert len(stops) > 3
    u, flag = tlb.lookback_stop(1, lambda _: False, _gen(0))
    assert (u, flag) == (0, tlb.PREFIX)
    for seed in range(10):  # every A halts: the walk ends at t - 1
        u, flag = tlb.lookback_stop(50, lambda _: True, _gen(seed))
        assert u == 49 and flag in (tlb.AGGREGATE, tlb.PREFIX)
    # a long walk: only A halts at tile 10, so it ends there or at a P above
    ends = {tlb.lookback_stop(300, lambda u: u == 10, _gen(s))[0]
            for s in range(20)}
    assert all(10 <= u < 300 for u in ends)


def test_models_count_as_plain_calls():
    tc.reset_counts()
    tsg.reset_counts()
    k = torch.zeros(40, dtype=torch.int32)
    tc.compact_lookback(k != 0, [k], 16, _gen(0))
    tsg.segscan_lookback(k, k, "sum", torch.int32, 32, _gen(0))
    assert tc.PLAIN_CALLS["compact_lookback"] == 1
    assert tsg.PLAIN_CALLS["segscan_lookback"] == 1
    assert not any(tc.LAUNCHES.values()) and not any(tsg.LAUNCHES.values())
