"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and ``sort`` / ``sort_any`` against ``torch.sort``, bit for bit.

Marked ``gpu``; without a CUDA device they skip with a reason (decided in a
fixture, never at import).  On a machine with a card (``--noconftest``
skips tests/conftest.py, which needs JAX for the reference's tests):

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

import json

import numpy as np
import pytest
import torch

from radx_tpu_torch import SortConfig, bench_suite, config, sort, sort_any, tuned
from radx_tpu_torch.bench import torch_sort_u32
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.utils import timing

pytestmark = pytest.mark.gpu

N = 1 << 20
CFG = SortConfig()
LOG_T = CFG.finish_elems.bit_length() - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _keys(cuda, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(x).to(cuda)


CASES = {
    "chunk_sort": (lambda x: tb.chunk_sort(x, CFG.chunk_elems),
                   lambda x: tb.chunk_sort_ref(x, CFG.chunk_elems)),
    "chunk_sort_invert": (
        lambda x: tb.chunk_sort(x, CFG.chunk_elems, invert=True),
        lambda x: tb.chunk_sort_ref(x, CFG.chunk_elems, invert=True)),
    "chunk_sort_ascending": (
        lambda x: tb.chunk_sort(x, CFG.chunk_elems, ascending=True),
        lambda x: tb.chunk_sort_ref(x, CFG.chunk_elems, ascending=True)),
    # the lowest distance at the finish tile while f distances fit 2^20 rows
    **{f"cross_stage<{f}>": (
        lambda x, f=f, j=min(LOG_T, 20 - f): tb.cross_stage(
            x, j, f, j + f, f % 2 == 0),
        lambda x, f=f, j=min(LOG_T, 20 - f): tb.cross_stage_ref(
            x, j, f, j + f, f % 2 == 0))
       for f in tb.CROSS_FUSION},
    "finish": (lambda x: tb.finish(x, CFG.finish_elems, 20, True),
               lambda x: tb.finish_ref(x, CFG.finish_elems, 20, True)),
    "finish_low_level": (lambda x: tb.finish(x, CFG.finish_elems, 6),
                         lambda x: tb.finish_ref(x, CFG.finish_elems, 6)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, case):
    kernel, ref = CASES[case]
    base = _keys(cuda, N)
    x = base.clone()
    kernel(x)
    want = ref(base)
    torch.cuda.synchronize()
    assert torch.equal(x, want)


@pytest.mark.parametrize(
    "n", [1, 2, 1000, 4097, 1 << 20, 3_000_000, (1 << 22) + 12345]
)
def test_sort_matches_torch_sort(cuda, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda)
    got = sort(keys)
    assert got.dtype == torch.uint32 and got.device == keys.device
    assert torch.equal(got.view(torch.int32),
                       torch_sort_u32(keys).view(torch.int32))


def test_sort_any_matches_torch_sort(cuda):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(
        rng.integers(-(2**31), 2**31, 1 << 18, dtype=np.int64).astype(np.int32)
    ).to(cuda)
    for descending in (False, True):
        want = torch.sort(x, descending=descending).values
        assert torch.equal(sort_any(x, descending), want)


# --- slice 2: rider mode of K1-K3, compact (K7), segscan (K6), the ops ------

from radx_tpu_torch import filter_columns, groupby, unique  # noqa: E402
from radx_tpu_torch.kernels import compact as tc  # noqa: E402
from radx_tpu_torch.kernels import segscan as tsg  # noqa: E402

R_T = CFG.rider_finish_elems
R_LOG_T = R_T.bit_length() - 1
R_C = CFG.rider_chunk_elems

RIDER_CASES = {
    "chunk_sort": (lambda x, r: tb.chunk_sort(x, R_C, rider=r),
                   lambda x, r: tb.chunk_sort_ref(x, R_C, rider=r)),
    "chunk_sort_ascending": (
        lambda x, r: tb.chunk_sort(x, R_C, ascending=True, rider=r),
        lambda x, r: tb.chunk_sort_ref(x, R_C, ascending=True, rider=r)),
    **{f"cross_stage<{f}>": (
        lambda x, r, f=f, j=min(R_LOG_T, 20 - f): tb.cross_stage(
            x, j, f, j + f, f % 2 == 0, rider=r),
        lambda x, r, f=f, j=min(R_LOG_T, 20 - f): tb.cross_stage_ref(
            x, j, f, j + f, f % 2 == 0, rider=r))
       for f in range(1, tb.cross_fusion(2) + 1)},
    "finish": (lambda x, r: tb.finish(x, R_T, 20, True, rider=r),
               lambda x, r: tb.finish_ref(x, R_T, 20, True, rider=r)),
}


@pytest.mark.parametrize("case", list(RIDER_CASES))
def test_rider_kernel_matches_plain(cuda, case):
    """Keys in [0, 16): ties everywhere; both planes bit-equal."""
    kernel, ref = RIDER_CASES[case]
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 16, N).astype(np.int32)).to(cuda)
    rider = torch.arange(N, dtype=torch.int32, device=cuda)
    x, r = keys.clone(), rider.clone()
    kernel(x, r)
    wk, wr = ref(keys, rider)
    torch.cuda.synchronize()
    assert torch.equal(x, wk) and torch.equal(r, wr)
    assert torch.equal(torch.sort(r).values, rider)  # no rider lost


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("mask_dtype", [torch.int32, torch.bool])
def test_compact_matches_plain(cuda, planes, density, mask_dtype):
    """The single pass over many tiles (1025) on a ragged n, int32 and
    bool masks."""
    rng = np.random.default_rng(planes)
    n = 4 * N + 17
    mask = torch.from_numpy(rng.random(n) < density).to(mask_dtype).to(cuda)
    ps = [_keys(cuda, n, seed=p) for p in range(planes)]
    want, wcount = tc.compact_ref(mask, ps)
    c = int(wcount)
    outs, count = tc.compact(mask, ps, CFG.compact_elems)
    torch.cuda.synchronize()
    assert int(count) == c
    for o, w in zip(outs, want):
        assert torch.equal(o[:c], w[:c])


@pytest.mark.parametrize("density", [0.01, 0.4])
def test_compact_unaligned_planes_and_n_valid(cuda, density):
    """Planes and mask offset by one row (scalar loads), few and many kept
    rows a warp (direct and staged writes), a device row limit n_valid."""
    rng = np.random.default_rng(21)
    n = N + 3
    mask = torch.from_numpy(rng.random(n + 1) < density).to(cuda)[1:]
    ps = [_keys(cuda, n + 1, seed=p)[1:] for p in range(3)]
    for n_valid in (None, torch.tensor(n // 3, dtype=torch.int32,
                                       device=cuda)):
        outs, count = tc.compact(mask, ps, CFG.compact_elems,
                                 n_valid=n_valid)
        want, wcount = tc.compact_ref(mask, ps, n_valid)
        torch.cuda.synchronize()
        c = int(wcount)
        assert int(count) == c
        for o, w in zip(outs, want):
            assert torch.equal(o[:c], w[:c])


def _sorted_keys(cuda, n, groups, seed=0):
    rng = np.random.default_rng(seed)
    k = np.sort(rng.integers(0, groups, n).astype(np.uint32))
    return torch.from_numpy(k.view(np.int32)).to(cuda)


def _values(cuda, n, dtype, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == torch.float32:
        v = rng.standard_normal(n).astype(np.float32)
        v[::97] = 0.0
        v[::89] = -0.0
        return torch.from_numpy(v.view(np.int32)).to(cuda)
    v = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(v).to(cuda)


@pytest.mark.parametrize("tile", [256, CFG.scan_elems])
@pytest.mark.parametrize("groups", [1, 7, 5000, "all_ffffffff"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32])
def test_segscan_matches_plain(cuda, tile, groups, op, dtype):
    """One run over every tile (also of 0xFFFFFFFF keys, the group-by's pad
    key), runs across many tiles, short runs; tile 256 gives 4097 tiles
    for the look-back.  Float32 sums: the same bits in two runs."""
    n = N + 33
    k = (torch.full((n,), -1, dtype=torch.int32, device=cuda)
         if groups == "all_ffffffff" else _sorted_keys(cuda, n, groups))
    v = _values(cuda, n, dtype)
    got = tsg.segscan_planes(k, v, op, dtype, tile)
    again = tsg.segscan_planes(k, v, op, dtype, tile)
    want = tsg.segscan_ref(k, v, op, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if op == "sum" and dtype == torch.float32:
        # |got - want| <= 1e-5 * (running sum of |v| over the run so far)
        absv = tsg.segscan_ref(k, (v.view(torch.float32).abs()).view(
            torch.int32), "sum", torch.float32).view(torch.float32)
        err = (got.view(torch.float32) - want.view(torch.float32)).abs()
        assert bool((err <= 1e-5 * absv).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_segscan_fill_matches_plain(cuda, m):
    n = N + 5
    k = _sorted_keys(cuda, n, 300)
    rng = np.random.default_rng(9)
    vals = [_values(cuda, n, torch.int32, seed=j) for j in range(m)]
    flags = [torch.from_numpy((rng.random(n) < 0.01).astype(np.int32)).to(cuda)
             for _ in range(m)]
    for tile in (256, CFG.scan_elems):
        got_v, got_h = tsg.segscan_planes(k, vals, "fill", torch.int32, tile,
                                          flags)
        want_v, want_h = tsg.segscan_ref(k, vals, "fill", torch.int32, flags)
        torch.cuda.synchronize()
        for a, b in zip(got_v + got_h, want_v + want_h):
            assert torch.equal(a, b)


def test_segscan_offset_planes_and_model(cuda):
    """Keys and values offset by one row; the float32 sum bit-equal to the
    CPU model of the kernel (``segscan_lookback``)."""
    n = (1 << 16) + 7
    k = _sorted_keys(cuda, n + 1, 40)[1:]
    v = _values(cuda, n + 1, torch.float32)[1:]
    got = tsg.segscan_planes(k, v, "sum", torch.float32, 256)
    model = tsg.segscan_lookback(k.cpu(), v.cpu(), "sum", torch.float32, 256,
                                 torch.Generator().manual_seed(0))
    assert torch.equal(got.cpu(), model)
    vi = _values(cuda, n + 1, torch.int32)[1:]
    assert torch.equal(tsg.segscan_planes(k, vi, "max", torch.int32, 256),
                       tsg.segscan_ref(k, vi, "max", torch.int32))


def _group_ref(keys, vals):
    """torch.sort + unique_consecutive + int64 sums at the run ends."""
    order = torch.sort(keys.view(torch.int32) ^ (-(1 << 31)), stable=True)
    sk = order.values
    sv = vals.view(torch.int32).to(torch.int64)[order.indices] & 0xFFFFFFFF
    uk, counts = torch.unique_consecutive(sk, return_counts=True)
    ends = torch.cumsum(counts, 0) - 1
    sums = torch.cumsum(sv, 0)[ends]
    sums = sums - torch.cat((sums.new_zeros(1), sums[:-1]))
    return (uk ^ (-(1 << 31))), counts, sums & 0xFFFFFFFF


def test_filter_groupby_unique_match_torch(cuda):
    rng = np.random.default_rng(11)
    n = 3_000_017
    key = torch.from_numpy(rng.integers(0, 1 << 16, n, dtype=np.uint32)).to(cuda)
    val = torch.from_numpy(rng.integers(0, 1 << 11, n, dtype=np.uint32)).to(cuda)
    pred = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda)
    mask = pred.view(torch.int32) >= 0  # pred < 2^31
    (fk, fv), count = filter_columns(mask, [key, val])
    c = int(count)
    i32 = torch.int32  # (no uint32 indexing on the card)
    assert torch.equal(fk[:c].view(i32), key.view(i32)[mask])
    assert torch.equal(fv[:c].view(i32), val.view(i32)[mask])
    fk, fv = fk[:c], fv[:c]
    uk_want, cnt_want, sum_want = _group_ref(fk, fv)
    g = uk_want.numel()
    for agg in ("sum", "count"):
        uk, out, ng = groupby(fk, fv, agg)
        assert int(ng) == g
        assert torch.equal(uk[:g].view(torch.int32), uk_want)
        want = sum_want if agg == "sum" else cnt_want
        assert torch.equal(out[:g].view(torch.int32).to(torch.int64) & 0xFFFFFFFF,
                           want)
    vals, cnts, cu = unique(fk, return_counts=True)
    assert int(cu) == g
    assert torch.equal(vals[:g].view(torch.int32), uk_want)
    assert torch.equal(cnts[:g].to(torch.int64), cnt_want)


def test_groupby_arbitrary_n_rider_sort_matches_torch(cuda):
    """3 * 2^24 + 5 rows: the rider sort takes the arbitrary-N path (pieces
    of 2^25, 2^24 and 2^21 rows, then two valley merges) instead of 2^26
    rows; a few keys are 0xFFFFFFFF, the pads' key."""
    from radx_tpu_torch.ops import sort as ts

    n = 3 * (1 << 24) + 5
    cfg = SortConfig()
    assert ts._use_decomposition(n, cfg)
    gen = torch.Generator(device=cuda).manual_seed(12)
    keys = torch.randint(0, 1_000_003, (n,), dtype=torch.int32, generator=gen,
                         device=cuda)
    keys[::4099] = -1  # 0xFFFFFFFF
    vals = torch.randint(0, 1 << 20, (n,), dtype=torch.int32, generator=gen,
                         device=cuda)
    ids, inv = torch.unique(keys ^ (-(1 << 31)), sorted=True,
                            return_inverse=True)
    want_sum = torch.zeros(ids.numel(), dtype=torch.int64, device=cuda)
    want_sum.index_add_(0, inv, vals.long())
    want_count = torch.bincount(inv, minlength=ids.numel())
    g = ids.numel()
    for agg, want in (("sum", want_sum), ("count", want_count)):
        uk, out, ng = groupby(keys.view(torch.uint32), vals.view(torch.uint32),
                              agg, cfg)
        blocks, _ = ts._decompose_blocks(n, cfg.rider_chunk_elems)
        assert uk.numel() == blocks * cfg.rider_chunk_elems < ts._pad_len(n)
        assert int(ng) == g
        assert torch.equal(uk[:g].view(torch.int32) ^ (-(1 << 31)), ids)
        assert torch.equal(out[:g].view(torch.int32).long() & 0xFFFFFFFF,
                           want & 0xFFFFFFFF)


# --- slice 3: the lexicographic mode of K1-K3, the dense aggregates (K8, K9),
# the Table query path ---------------------------------------------------------

from radx_tpu_torch import LazyTable, Table, sort_pairs  # noqa: E402
from radx_tpu_torch.examples.query_pipeline import no_sync  # noqa: E402
from radx_tpu_torch.kernels import aggregate as tag  # noqa: E402


def _lex_cases():
    cases = {}
    for p in tb.LEX_PLANES:
        c, f = CFG.lex_tiles(p)
        lt = f.bit_length() - 1
        cases[f"chunk_sort/lex{p}"] = (
            p, lambda x, lx, c=c: tb.chunk_sort(x, c, lex=lx),
            lambda x, lx, c=c: tb.chunk_sort_ref(x, c, lex=lx))
        cases[f"finish/lex{p}"] = (
            p, lambda x, lx, f=f: tb.finish(x, f, 20, True, lex=lx),
            lambda x, lx, f=f: tb.finish_ref(x, f, 20, True, lex=lx))
        for fu in range(1, tb.cross_fusion(p) + 1):
            j = min(lt, 19 - fu)
            cases[f"cross_stage<{fu}>/lex{p}"] = (
                p, lambda x, lx, j=j, fu=fu: tb.cross_stage(
                    x, j, fu, j + fu + 1, fu % 2 == 0, lex=lx),
                lambda x, lx, j=j, fu=fu: tb.cross_stage_ref(
                    x, j, fu, j + fu + 1, fu % 2 == 0, lex=lx))
    return cases


LEX_CASES = _lex_cases()


@pytest.mark.parametrize("case", list(LEX_CASES))
def test_lex_kernel_matches_plain(cuda, case):
    """Keys in [0, 16), a unique tie plane, riders: every plane bit-equal."""
    planes, kernel, ref = LEX_CASES[case]
    rng = np.random.default_rng(planes)
    base = [torch.from_numpy(rng.integers(0, 16, N).astype(np.int32)).to(cuda),
            torch.randperm(N, device=cuda).to(torch.int32)]
    base += [_keys(cuda, N, seed=j) for j in range(planes - 2)]
    got = [p.clone() for p in base]
    kernel(got[0], got[1:])
    want = ref(base[0], base[1:])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# the strided tile pass (f > max_fusion(P)) in the keys, rider and lex2
# modes: ascending and descending, at the finish tile and at the top
# distances, and under a radix span of 2^19
STRIDED = [(mode, f) for mode, p in (("keys", 1), ("rider", 2), ("lex2", 2))
           for f in range(tb.max_fusion(p) + 1, tb.cross_fusion(p) + 1)]


@pytest.mark.parametrize("mode,f", STRIDED)
def test_strided_cross_pass_matches_plain(cuda, mode, f):
    rng = np.random.default_rng(f)
    if mode == "keys":
        base = [_keys(cuda, N, seed=f)]
    else:  # ties, and a unique second plane
        base = [torch.from_numpy(rng.integers(0, 16, N).astype(np.int32))
                .to(cuda), torch.randperm(N, device=cuda).to(torch.int32)]

    def kw(planes):
        if mode == "keys":
            return {}
        return {"rider": planes[1]} if mode == "rider" else {"lex": planes[1:]}

    log_n = N.bit_length() - 1
    lt = LOG_T if mode == "keys" else R_LOG_T
    for j, kk, inv, span in ((min(lt, log_n - f), log_n, False, None),
                             (min(lt, log_n - f), log_n, True, None),
                             (log_n - f, log_n, True, None),
                             (min(lt, 19 - f), 19, False, 1 << 19),
                             (min(lt, 19 - f), 19, True, 1 << 19)):
        got = [x.clone() for x in base]
        tb.cross_stage(got[0], j, f, kk, inv, span=span, **kw(got))
        want = tb.cross_stage_ref(base[0], j, f, kk, inv, span=span,
                                  **kw(base))
        torch.cuda.synchronize()
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (j, kk,
                                                                    inv, span)


@pytest.mark.parametrize("mode", ["keys", "rider", "lex2", "lex5"])
def test_sort_at_the_cross_cap_matches_the_old_grouping(cuda, mode,
                                                        monkeypatch):
    """A whole sort with at most cross_fusion(P) distances a pass and with
    the old max_fusion(P): bit-identical planes, riders included."""
    ncmp, p = {"keys": (1, 1), "rider": (1, 2), "lex2": (2, 2),
               "lex5": (2, 5)}[mode]
    n = 1 << 22
    rng = np.random.default_rng(p)
    src = [torch.from_numpy(rng.integers(0, 1 << 12, n).astype(np.int32))
           .to(cuda)]
    src += [torch.randperm(n, device=cuda).to(torch.int32)
            for _ in range(p - 1)]
    chunk, fin = CFG.mode_tiles(p, ncmp)
    outs = []
    for cap in (tb.cross_fusion, tb.max_fusion):
        monkeypatch.setattr(tb, "cross_fusion", cap)
        got = [x.clone() for x in src]
        k, rd, lx = tb._keywords(got, ncmp)
        tb.sort_planes(k, chunk, fin, mode == "lex5", rd, lx)
        outs.append(got)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    want = torch.sort(src[0], descending=mode == "lex5").values
    assert torch.equal(outs[0][0], want)


@pytest.mark.parametrize("bins", [128, 256, 8192, 65536])
@pytest.mark.parametrize("dist", ["uniform", "one_key", "out_of_range"])
def test_dense_aggregates_match_plain(cuda, bins, dist):
    rng = np.random.default_rng(bins)
    n = N + 77
    if dist == "uniform":
        k = rng.integers(0, bins, n, dtype=np.uint32)
    elif dist == "one_key":
        k = np.full(n, 5, np.uint32)
    else:
        k = rng.integers(0, 2**32, n, dtype=np.uint32)
        k[::3] %= bins
    k, v = torch.from_numpy(k).to(cuda), _keys(cuda, n, seed=2)
    nv = torch.full((), n - 1001, dtype=torch.int32, device=cuda)
    got, want = tag.dense_sums(k, v, bins, nv), tag.dense_sums_ref(k, v, bins, nv)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    if bins <= tag.MAX_EXTREMA_BINS:
        for is_min in (True, False):
            got = tag.dense_extrema(k, v, bins, is_min, nv)
            want = tag.dense_extrema_ref(k, v, bins, is_min, nv)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sort_pairs_and_lazy_dense_query(cuda):
    """Stable pairs against torch.sort; the dense LazyTable query under the
    sync guard against a plain reference."""
    rng = np.random.default_rng(12)
    n = 3_000_017
    k = torch.from_numpy(rng.integers(0, 1 << 12, n, dtype=np.uint32)).to(cuda)
    p = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda)
    gk, gp = sort_pairs(k, p)
    o = torch.sort(k.view(torch.int32), stable=True)
    assert torch.equal(gk.view(torch.int32), o.values)
    assert torch.equal(gp.view(torch.int32), p.view(torch.int32)[o.indices])
    t = Table({"b": (k.view(torch.int32) & 255).view(torch.uint32), "v": p})
    with no_sync(cuda):
        lt = t.lazy()
        assert isinstance(lt, LazyTable)
        lazy = lt.filter(lt.column("v").view(torch.int32) >= 0).groupby(
            "b", "v", "count", bins=256)
    got = lazy.collect()
    keep = p.view(torch.int32) >= 0
    want = torch.bincount(t.column("b").view(torch.int32)[keep].long(),
                          minlength=256)
    assert torch.equal(got.column("b").view(torch.int32).long(),
                       want.nonzero().flatten())
    assert torch.equal(got.column("count").long(), want[want > 0])


# --- the value-plane gather (csrc/gather.cu) ------------------------------------

from radx_tpu_torch.kernels import gather as tgt  # noqa: E402
from radx_tpu_torch.ops import join as tj  # noqa: E402
from radx_tpu_torch.ops.sort import sort_multi  # noqa: E402


def _tagged_ties(cuda, n, gen):
    """A shuffled tie plane of n rows: build ties, probe ties and pads."""
    nb, np_ = n // 2 - 5, n - n // 2 - 1000
    tie = torch.cat((torch.arange(nb, device=cuda),
                     torch.arange(np_, device=cuda) + tgt.PROBE_TIE,
                     torch.full((n - nb - np_,), tgt.PAD_TIE, device=cuda)))
    tie = tie[torch.randperm(n, generator=gen, device=cuda)]
    return tie.to(torch.int32), nb, np_


def _route_launches(srcs, mode):
    """The launches one ``gather_planes`` call makes: one direct launch, or
    the partitioned route's count / scan / part once and window / place
    once a value plane (one in tagged mode)."""
    if not tgt.takes_partitioned(srcs):
        return {tgt._KERNEL[mode]: 1}
    tag = "tagged/" if mode == "tagged" else ""
    planes = 1 if mode == "tagged" else len(srcs)
    return {f"gather_planes/{tag}{s}": planes if s in ("window", "place")
            else 1 for s in tgt.STEPS}


def _scratch_bound(idx, srcs, mode):
    """The outputs, one plane of the index's length (P) and the route's
    two tables (counts and their prefixes, with the totals), bytes."""
    n = idx.numel()
    outs = 4 * n * len(srcs)
    if not tgt.takes_partitioned(srcs):
        return outs
    geo = tgt.geometry(idx, srcs, mode)
    return outs + 4 * n + 16 * (geo.nb + 1) * (geo.tiles + 1)


def _gather_on_card(index, srcs, mode):
    """One routed call: (outputs, launches, extra device bytes at the
    peak)."""
    tgt.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = tgt.gather_planes(index, srcs, mode)
    torch.cuda.synchronize()
    return (got, {k: v for k, v in tgt.LAUNCHES.items() if v},
            torch.cuda.max_memory_allocated() - base)


W4 = tgt.WINDOW_BYTES // 4  # rows of one source that one window holds


@pytest.mark.parametrize("n", [1 << 26, (1 << 20) + 4099, W4, W4 + 1])
@pytest.mark.parametrize("mode", ["index", "tagged"])
def test_gather_planes_matches_plain(cuda, n, mode):
    """Index mode with 1..4 sources on a permutation with out-of-range
    indices, tagged mode on build / probe / pad ties; each also on an index
    plane one row off 16-byte alignment (the scalar paths).  Sizes on both
    sides of the route threshold (one window of sources: direct; above:
    partitioned).  Bit-equal to ``gather_planes_ref``, the route's launches
    a call (one direct launch; count / scan / part once, window / place
    once a value plane), no plain call, and no device memory beyond the
    outputs, one plane and the route's tables."""
    gen = torch.Generator(device=cuda).manual_seed(n % 1000)
    if mode == "index":
        idx = torch.randperm(n, generator=gen, device=cuda).to(torch.int32)
        idx[:3] = torch.tensor([-1, n, 2**31 - 1], device=cuda)
        srcs = [_keys(cuda, n, seed=j) for j in range(4)]
        cases = [srcs[:g] for g in range(1, 5)]
    else:
        idx, nb, np_ = _tagged_ties(cuda, n, gen)
        cases = [[_keys(cuda, nb, seed=1), _keys(cuda, np_, seed=2)]]
    shifted = torch.empty(n + 1, dtype=torch.int32, device=cuda)
    shifted[1:] = idx
    for index in (idx, shifted[1:]):
        for srcs in cases:
            got, launches, extra = _gather_on_card(index, srcs, mode)
            want = tgt.gather_planes_ref(index, srcs, mode)
            assert len(got) == len(want)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert launches == _route_launches(srcs, mode)
            assert extra <= _scratch_bound(index, srcs, mode) + (1 << 20)


SKEWS = ["identity", "reversal", "one_index", "quarter_out_of_range"]


@pytest.mark.parametrize("skew", SKEWS)
def test_gather_partitioned_skew_cases(cuda, skew):
    """The partitioned route at 2^26 rows on skewed index planes (one
    bucket a tile; tiles in reverse; one bucket holds every row; a quarter
    in the null bucket), step by step: each kernel (counts, prefixes and
    totals, P, V, the outputs) bit-equal to its plain version on the same
    inputs, then the routed call to ``gather_planes_ref``."""
    n = 1 << 26
    gen = torch.Generator(device=cuda).manual_seed(SKEWS.index(skew))
    ar = torch.arange(n, dtype=torch.int32, device=cuda)
    if skew == "quarter_out_of_range":
        idx = torch.randperm(n, generator=gen, device=cuda).to(torch.int32)
        idx[: n // 4] += n
    else:
        idx = {"identity": ar, "reversal": ar.flip(0),
               "one_index": torch.full_like(ar, 12345)}[skew]
    srcs = [_keys(cuda, n, seed=7)]
    geo = tgt.geometry(idx, srcs, "index")
    counts = tgt.count(idx, geo)
    assert torch.equal(counts, tgt.count_ref(idx, geo))
    off, tot = tgt.scan(counts, geo)
    want_off, want_tot = tgt.scan_ref(counts, geo)
    assert torch.equal(off, want_off) and torch.equal(tot, want_tot)
    p = tgt.part(idx, geo, off, tot)
    assert torch.equal(p, tgt.part_ref(idx, geo, off, tot))
    v = tgt.window(p, srcs, geo, torch.empty_like(p))
    assert torch.equal(v, tgt.window_ref(p, srcs, geo, torch.empty_like(p)))
    (out,) = tgt.place(idx, geo, off, tot, v, [torch.empty_like(idx)])
    (want,) = tgt.place_ref(idx, geo, off, tot, v, [torch.empty_like(idx)])
    assert torch.equal(out, want)
    got, launches, extra = _gather_on_card(idx, srcs, "index")
    assert torch.equal(got[0], tgt.gather_planes_ref(idx, srcs, "index")[0])
    assert launches == _route_launches(srcs, "index")
    assert extra <= _scratch_bound(idx, srcs, "index") + (1 << 20)


@pytest.mark.parametrize("n", [3_000_017, (1 << 23) + 5])
def test_two_plane_sorts_gather_on_the_card(cuda, n):
    """sort_pairs, sort_multi (seven payloads: two gathers of four and
    three) and the join's union: the lex2 network and the gather kernels,
    no plain call; every value plane exact against torch.  3,000,017 rows:
    one payload or the union's two sides within one window (direct), the
    payload groups above it; 2^23 + 5 rows: every gather partitioned."""
    rng = np.random.default_rng(14)
    k = torch.from_numpy(rng.integers(0, 1 << 12, n, dtype=np.uint32)).to(cuda)
    pays = [_keys(cuda, n, seed=j) for j in range(7)]
    o = torch.sort(k.view(torch.int32), stable=True).indices
    _reset_all()
    _, gp = sort_pairs(k, pays[0])
    torch.cuda.synchronize()
    assert {k: v for k, v in tgt.LAUNCHES.items() if v} == _route_launches(
        pays[:1], "index") and _no_plain_calls()
    _reset_all()
    _, gps = sort_multi(k, pays)
    torch.cuda.synchronize()
    want = {}
    for group in (pays[:4], pays[4:]):
        for name, count in _route_launches(group, "index").items():
            want[name] = want.get(name, 0) + count
    assert {k: v for k, v in tgt.LAUNCHES.items() if v} == want
    assert _no_plain_calls()
    # the (key, index) planes made by the network's first launch
    assert tb.LAUNCHES["chunk_sort/src/lex2"]
    assert not tb.LAUNCHES["chunk_sort/lex3"]
    assert torch.equal(gp.view(torch.int32), pays[0][o])
    assert all(torch.equal(g, p[o]) for g, p in zip(gps, pays))
    bk = k[: n // 2]
    pk = k[n // 2:]
    bv, pv = pays[1][: n // 2], pays[2][n // 2:]
    _reset_all()
    key, tie, bval, pval = tj.tagged_union(bk, bv, pk, pv, CFG)
    torch.cuda.synchronize()
    assert {k: v for k, v in tgt.LAUNCHES.items() if v} == _route_launches(
        [bv, pv], "tagged") and _no_plain_calls()
    assert tb.LAUNCHES["chunk_sort/src/lex2"]
    assert not tb.LAUNCHES["chunk_sort/lex4"]
    build = tie < tgt.PROBE_TIE
    assert torch.equal(bval, torch.where(build, bv[tie.clamp(
        max=n // 2 - 1).long()], 0))
    assert torch.equal(pval, torch.where(build, 0, pv[
        (tie - tgt.PROBE_TIE).clamp(min=0).long()]))


# --- slice 4: strategy="radix" (K4, K5, K10-K14, the span passes) -------------

from radx_tpu_torch.kernels import msd as tm  # noqa: E402
from radx_tpu_torch.kernels import radix as tr  # noqa: E402
from radx_tpu_torch.kernels import radix_sort as trs  # noqa: E402

RADIX = SortConfig(strategy="radix")
R_CHUNK = 1 << 17  # the radix chunk at 2^23 keys; N = 2^20 holds 8 of them
MODES = {"keys": (1, 1), "rider": (1, 2), "lex2": (2, 2), "lex3": (2, 3),
         "lex8": (2, 8)}


def _mode_planes(cuda, mode, n=N):
    """Keys in [0, 64) (ties), then a rider, or a unique tie plane and
    riders."""
    ncmp, p = MODES[mode]
    rng = np.random.default_rng(p)
    planes = [torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(cuda)]
    if ncmp == 2:
        planes.append(torch.randperm(n, device=cuda).to(torch.int32))
    planes += [_keys(cuda, n, seed=j) for j in range(p - len(planes))]
    return planes


def _assert_planes_equal(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", list(MODES))
def test_radix_phase_kernels_match_plain(cuda, mode):
    """chunk_sort_cyclic, slot_merge and the span passes, every plane
    bit-equal to the plain versions (ties included: one decision per
    pair in both)."""
    ncmp, p = MODES[mode]
    c, f = RADIX.mode_tiles(p, ncmp)
    src = _mode_planes(cuda, mode)
    out = [torch.empty_like(x) for x in src]
    tb.chunk_sort_cyclic(src, out, ncmp, R_CHUNK, c)
    _assert_planes_equal(out, tb.chunk_sort_cyclic_ref(src, ncmp, R_CHUNK, c))
    slot = 2048
    sl = [torch.sort(x.view(-1, slot), 1).values.view(-1) for x in src[:1]]
    sl += [x.clone() for x in src[1:]]
    out = [torch.empty_like(x) for x in sl]
    tb.slot_merge(sl, out, ncmp, R_CHUNK, slot, f)
    _assert_planes_equal(out, tb.slot_merge_ref(sl, ncmp, R_CHUNK, slot, f))
    k, rd, lx = tb._keywords(out, ncmp)
    log_f = f.bit_length() - 1
    want = tb.cross_stage_ref(k, log_f, 1, 17, False, rd, lx, span=R_CHUNK)
    tb.cross_stage(k, log_f, 1, 17, False, rd, lx, span=R_CHUNK)
    _assert_planes_equal(out, want if isinstance(want, tuple) else (want,))
    want = tb.finish_ref(k, f, 17, False, rd, lx, span=R_CHUNK)
    tb.finish(k, f, 17, False, rd, lx, span=R_CHUNK)
    _assert_planes_equal(out, want if isinstance(want, tuple) else (want,))


@pytest.mark.parametrize("shift,bias", [(0, 0), (8, 0), (16, 0), (24, 0),
                                        (24, 0x80000000)])
def test_radix_hist_matches_plain(cuda, shift, bias):
    """With and without the totals row, on uniform, all-equal and
    two-valued keys, a ragged n and a misaligned start."""
    x = _keys(cuda, N + 4097)
    two = torch.where(x[: N] < 0, 0x11223344, -0x11223345).to(torch.int32)
    for keys in (x, x[1:], torch.full_like(x, 0x12345678), two):
        for tile, n in ((1024, keys.numel()), (R_CHUNK, N - 12345),
                        (1 << 13, N - 3), (1 << 14, N - 5)):
            for totals in (False, True):
                want = tr.histograms_ref(keys, tile, shift, bias, n, totals)
                got = tr.histograms(keys, tile, shift, bias, n, totals=totals)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (tile, totals)


@pytest.mark.parametrize("mode", list(MODES))
def test_radix_rank_pack_concat_match_plain(cuda, mode):
    ncmp, p = MODES[mode]
    planes = _mode_planes(cuda, mode)
    c, f = RADIX.mode_tiles(p, ncmp)
    plan = trs.plan(N, 1 << 18)  # 4 chunks of 2^18, slots of 2^16
    sorted_ = tb.sort_chunks_ascending_cyclic(planes, ncmp, plan.C, c, f)
    nv = N - 999
    args = trs.rank_args(sorted_[0], planes[0], plan, nv,
                         RADIX.mode_tiles(1, 1), True)
    for pads in (None, args[6]):
        args = args[:6] + (pads, True)
        b = trs.rank_runs(*args)
        want = trs.rank_runs_ref(*args)
        torch.cuda.synchronize()
        for field in (*trs.Ranked._fields, "ranks"):
            assert torch.equal(getattr(b, field), getattr(want, field)), field
    packed = tm.pack(sorted_, b.bounds, plan.C, plan.slot, plan.nb_pad, ncmp)
    _assert_planes_equal(packed, tm.pack_ref(sorted_, b.bounds, plan.C,
                                             plan.slot, plan.nb_pad, ncmp))
    out = [torch.empty_like(x) for x in planes]
    tm.concat(packed, sorted_, out, b.start, b.src, plan.nb_pad, ncmp)
    _assert_planes_equal(out, tm.concat_ref(packed, sorted_, b.start, b.src,
                                            plan.nb_pad, N, ncmp))


@pytest.mark.parametrize("n", [1 << 20, 1 << 23, (1 << 23) - 4321])
def test_radix_sort_matches_torch_sort(cuda, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda)
    tm.reset_counts()
    got = sort(keys, RADIX)
    assert torch.equal(got.view(torch.int32),
                       torch_sort_u32(keys).view(torch.int32))
    assert tm.LAUNCHES["radix_concat/unbias"] == 1
    same = torch.full((n,), 7, dtype=torch.uint32, device=cuda)
    tm.reset_counts()
    assert torch.equal(sort(same, RADIX).view(torch.int32),
                       same.view(torch.int32))  # overflow: the network
    assert tm.LAUNCHES["radix_rank"] == 1
    assert tm.LAUNCHES["radix_concat/unbias"] == 0


# --- slice 9: the streaming operators and the in-process mesh ----------------

from radx_tpu_torch.kernels import compact as tcp  # noqa: E402
from radx_tpu_torch.kernels import merge as tmg  # noqa: E402
from radx_tpu_torch.kernels import segscan as tsg  # noqa: E402
from radx_tpu_torch.ops import chunked as tch  # noqa: E402
from radx_tpu_torch.parallel import Mesh, dist_sort as tds  # noqa: E402

SLAB9 = 1 << 16
N9 = 5 * SLAB9 + 7


def _reset_all():
    for m in (tb, tcp, tsg, tgt, tmg):
        m.reset_counts()


def _no_plain_calls():
    return not any(v for m in (tb, tcp, tsg, tgt, tmg)
                   for v in m.PLAIN_CALLS.values())


def test_chunked_ops_match_torch(cuda):
    """filter_chunked, groupby_chunked (recursive merge) and sort_chunked
    (8 runs) on the card, against torch; the network, compaction and scan
    kernels launched, no plain version called."""
    rng = np.random.default_rng(91)
    keys = rng.integers(0, 2**32, N9, dtype=np.uint32)
    vals = rng.integers(0, 2**32, N9, dtype=np.uint32)
    mask = keys.view(np.int32) >= 0
    _reset_all()
    (fk, fv), count = tch.filter_chunked(mask, [keys, vals], slab=SLAB9)
    gk = (keys & 63).astype(np.uint32)
    uk, sums, ng = tch.groupby_chunked(gk, vals, "sum", slab=SLAB9)
    got = tch.sort_chunked(keys, slab=SLAB9)
    torch.cuda.synchronize()
    assert _no_plain_calls()
    # the group-by's rider sort from its sources; the slabs' own planes
    assert tb.LAUNCHES["chunk_sort/src/rider"] and tb.LAUNCHES["chunk_sort"]
    assert tcp.LAUNCHES["compact"] and tsg.LAUNCHES["segscan"]
    m = torch.from_numpy(mask).to(cuda)
    kd, vd = (torch.from_numpy(x).to(cuda) for x in (keys, vals))
    assert count == int(m.sum())
    assert torch.equal(torch.from_numpy(fk).to(cuda).view(torch.int32),
                       kd.view(torch.int32)[m])
    assert torch.equal(torch.from_numpy(fv).to(cuda).view(torch.int32),
                       vd.view(torch.int32)[m])
    g = torch.from_numpy(gk.view(np.int32)).to(cuda).long()
    want = torch.zeros(64, dtype=torch.int64, device=cuda).index_add_(
        0, g, vd.view(torch.int32).long() & 0xFFFFFFFF) & 0xFFFFFFFF
    assert ng == 64 and np.array_equal(uk, np.arange(64, dtype=np.uint32))
    assert np.array_equal(sums.astype(np.int64), want.cpu().numpy())
    assert torch.equal(torch.from_numpy(got).to(cuda).view(torch.int32),
                       torch_sort_u32(kd).view(torch.int32))


def test_chunked_staging_pinned_on_the_card(cuda, monkeypatch):
    """The streamed copies through a ring of two 1 MiB pieces (each slab
    wraps it many times) on the card: every piece pinned and on the copy
    stream, and every output equal to the default ring's."""
    from radx_tpu_torch.ops import _staging

    rng = np.random.default_rng(92)
    keys = rng.integers(0, 2**32, N9, dtype=np.uint32)
    vals = rng.integers(0, 2**32, N9, dtype=np.uint32)
    mask = keys.view(np.int32) >= 0
    gk = (keys & 63).astype(np.uint32)

    def run():
        return (tch.filter_chunked(mask, [keys, vals], slab=SLAB9),
                tch.groupby_chunked(gk, vals, "min", slab=SLAB9),
                tch.sort_chunked(keys, slab=SLAB9))

    want = run()
    monkeypatch.setattr(_staging, "PIECE_BYTES", 1 << 20)
    monkeypatch.setattr(_staging, "RING", 2)
    _staging.reset_stats()
    (fcols, count), (uk, mins, ng), keys_sorted = run()
    st = _staging.STATS
    assert st["pinned_pieces"] == st["pieces_up"] + st["pieces_down"] > 64
    assert count == want[0][1] and ng == want[1][2] == 64
    for got, exp in zip([*fcols, uk, mins, keys_sorted],
                        [*want[0][0], *want[1][:2], want[2]]):
        assert got.dtype == exp.dtype and np.array_equal(got, exp)
    assert np.array_equal(keys_sorted, np.sort(keys))


@pytest.mark.parametrize("exchange,overlap", [("flat", True), ("flat", False),
                                              ("hier", True)])
def test_in_process_mesh_matches_torch(cuda, exchange, overlap):
    """The distributed sort on 4 shards of the one card: keys, stable
    pairs and argsort against torch.sort, network kernels only."""
    rng = np.random.default_rng(92)
    n = (1 << 20) - 333
    keys = torch.from_numpy(rng.integers(0, 1 << 12, n, dtype=np.uint32)).to(cuda)
    vals = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda)
    mesh = Mesh([cuda] * 4)
    _reset_all()
    out, valid, ovf = tds.sort_sharded(keys, mesh, exchange=exchange,
                                       overlap=overlap)
    k, v, pvalid, povf = tds.sort_pairs_sharded(keys, vals, mesh, stable=True,
                                                exchange=exchange,
                                                overlap=overlap)
    ak, idx, avalid, aovf = tds.argsort_sharded(keys, mesh, overlap=overlap)
    torch.cuda.synchronize()
    # keys and (key, index) local sorts from the shards; lex3 prepared
    assert _no_plain_calls() and tb.LAUNCHES["chunk_sort/src"]
    assert tb.LAUNCHES["chunk_sort/lex3"] and tb.LAUNCHES["chunk_sort/src/lex2"]
    assert tmg.LAUNCHES["merge_runs"]
    assert not (ovf.any() or povf.any() or aovf.any())
    o = torch.sort(keys.view(torch.int32), stable=True)
    assert np.array_equal(tds.collect(out, valid), o.values.cpu().numpy())
    assert np.array_equal(tds.collect(k, pvalid), o.values.cpu().numpy())
    assert np.array_equal(tds.collect(v, pvalid), vals.view(torch.int32)[
        o.indices].cpu().numpy().view(np.uint32))
    assert np.array_equal(tds.collect(idx, avalid),
                          o.indices.to(torch.int32).cpu().numpy())


def _merge_case(cuda, na, nb, ncmp, planes, keys, seed, offsets=(0, 0)):
    """Two ascending runs (lists of int32 planes on the card), their planes
    views that start ``offsets`` rows (A's, B's) past a 16-byte
    boundary."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def run(n):
        if keys == "equal":
            k = torch.full((n,), 0x12345, dtype=torch.int32, device=cuda)
        elif keys == "ffffffff":
            k = torch.randint(0, 2, (n,), generator=gen, device=cuda,
                              dtype=torch.int32) * 0x7FFFFFFF
        else:
            k = torch.randint(-(2**31), 2**31, (n,), generator=gen,
                              device=cuda, dtype=torch.int32)
        rest = [torch.randint(-(2**31), 2**31, (n,), generator=gen,
                              device=cuda, dtype=torch.int32)
                for _ in range(planes - 1)]
        order = torch.sort(k, stable=True).indices
        if ncmp == 2:
            order = order[torch.sort(rest[0][order], stable=True).indices]
            order = order[torch.sort(k[order], stable=True).indices]
        return [k[order], *(r[order] for r in rest)]

    def at(run, off):
        held = torch.empty((len(run), run[0].numel() + 4), dtype=torch.int32,
                           device=cuda)
        held[:, off:off + run[0].numel()] = torch.stack(run)
        return [h[off:off + run[0].numel()] for h in held]

    return at(run(na), offsets[0]), at(run(nb), offsets[1])


@pytest.mark.parametrize("offsets", [(0, 0), (1, 3)])
@pytest.mark.parametrize("na,nb,ncmp,planes,keys", [
    (0, 1, 1, 1, "uniform"), (1, 0, 2, 2, "uniform"), (1, 1, 1, 1, "equal"),
    (2047, 2049, 1, 1, "uniform"), ((1 << 22) + 3, (1 << 21) - 5, 1, 1,
                                    "uniform"),
    ((1 << 20) + 1, 1 << 20, 2, 3, "uniform"), (1 << 20, 3, 2, 4, "equal"),
    (123457, 98765, 1, 1, "ffffffff"), (123457, 98765, 2, 2, "ffffffff")])
def test_merge_runs_matches_plain(cuda, na, nb, ncmp, planes, keys,
                                  offsets):
    """merge_runs (one launch, no path launch) against the plain version
    on the same runs, bit for bit, the key XOR on: runs at a 16-byte
    boundary and runs 1 / 3 rows past one (``offsets``), into new planes
    and into planes that start 2 rows past a 16-byte boundary."""
    a, b = _merge_case(cuda, na, nb, ncmp, planes, keys, na + nb, offsets)
    _reset_all()
    got = tmg.merge_runs(a, b, ncmp, key_xor=-(1 << 31))
    held = torch.zeros((planes, na + nb + 4), dtype=torch.int32, device=cuda)
    tmg.merge_runs(a, b, ncmp, out=[h[2:2 + na + nb] for h in held],
                   key_xor=-(1 << 31))
    torch.cuda.synchronize()
    assert tmg.LAUNCHES == {"merge_runs": 2} and _no_plain_calls()
    want = tmg.merge_runs_ref(a, b, ncmp, key_xor=-(1 << 31))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(h[2:2 + na + nb], w) for h, w in zip(held, want))
    assert not held[:, :2].any() and not held[:, 2 + na + nb:].any()


def test_sort_sharded_eight_shards_matches_torch_sort(cuda):
    """sort_sharded on 8 shards of the card (ragged n) against torch.sort:
    the runs merged by merge_runs, no plain version."""
    n = (1 << 22) - 12345
    keys = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                         device=cuda)
    _reset_all()
    out, valid, ovf = tds.sort_sharded(keys.view(torch.uint32),
                                       Mesh([cuda] * 8))
    torch.cuda.synchronize()
    assert _no_plain_calls() and tmg.LAUNCHES["merge_runs"] >= 8
    assert not ovf.any() and int(valid.sum()) == n
    want = torch.sort(keys.view(torch.int32) ^ (-(1 << 31))).values
    got = tds.collect(out, valid).view(np.int32) ^ np.int32(-(1 << 31))
    assert np.array_equal(got, want.cpu().numpy())


# the benchmark suite's configs at small n (radx_tpu_torch/bench_suite.py):
# every gate on the card's own output, arbn at a size that takes the
# arbitrary-N path
SUITE_N = {"arbn_600m": (1 << 22) + (1 << 20)}


@pytest.mark.parametrize("name", list(bench_suite.CONFIGS))
def test_suite_config_gated(cuda, name):
    bench_suite.make_and_gate(name, SUITE_N.get(name, 1 << 16), cuda)


def test_suite_run_tuned_and_trace(cuda, tmp_path):
    m, row = bench_suite.run("sort_8m", 1 << 20, iters=2, repeats=2)
    assert m.seconds > 0 and row["peak_mem_gb"] > 0 and m.items == 1 << 20
    if config.device_kind().startswith("NVIDIA H100"):
        assert tuned() == SortConfig(**config.TUNING["NVIDIA H100"])
    path = tmp_path / "trace.json"
    with timing.trace(path):
        sort(torch.arange(1 << 16, dtype=torch.int32, device=cuda).view(
            torch.uint32))
    assert json.load(open(path))["traceEvents"]


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
def test_compact_with_no_planes_counts(cuda, mask_dtype):
    """K7's zero-plane case (the count-only filter): the count of a launch
    with no planes equals the plain count and the one-plane launch's."""
    rng = np.random.default_rng(33)
    n = (1 << 20) + 4097
    mask = torch.from_numpy(rng.random(n) < 0.3).to(mask_dtype).to(cuda)
    plane = torch.arange(n, dtype=torch.int32, device=cuda)
    _reset_all()
    outs, count = tc.compact(mask, [], tc.TILE)
    _, one = tc.compact(mask, [plane], tc.TILE)
    torch.cuda.synchronize()
    assert outs == [] and count.dtype == torch.int32 and count.is_cuda
    assert int(count) == int(one) == int(torch.count_nonzero(mask))
    assert tc.LAUNCHES["compact"] == 2 and _no_plain_calls()
    got, c = filter_columns(mask, [])
    assert got == [] and int(c) == int(count)


def test_scaling_model_rates_and_audit(cuda):
    """The model's rates measured on the card, then the exchange audit on
    8 shards of the card, flat and hier, and the calibration reading."""
    from radx_tpu_torch.tools import scaling_model as sm

    rates = sm.measure_rates(cuda)
    assert set(rates["sort"]) == set(sm.SORT_SIZES)
    assert all(r > 0 for r in rates["sort"].values())
    assert rates["merge_per_level"] > 0 and rates["card"]
    for exchange in ("flat", "hier"):
        a = sm.audit(8, 1 << 16, exchange, device=cuda)
        assert a["agrees"], a
    cal = sm.calibrate(rates, 1 << 16, device=cuda)
    assert cal["measured_s"] > 0 and cal["modelled_s"] > 0


# --- a sort's first and last launches (csrc/bitonic_io.cu) ---------------------


def _col(cuda, n, off, seed):
    """n int32 rows 4 * off bytes past a 16-byte boundary, every seventh
    0xFFFFFFFF."""
    v = torch.empty(n + 4, dtype=torch.int32, device=cuda)[off: off + n]
    v.copy_(_keys(cuda, n, seed))
    v[::7] = -1
    return v


def _sources(cuda, mode, n, off, total):
    keys = _col(cuda, n, off, n + off)
    if mode == "keys":
        return 1, [tb.key_source(keys)]
    if mode == "rider":
        return 1, [tb.key_source(keys),
                   tb.column_source(_col(cuda, n, 3 - off, 5), -7)]
    if mode == "lex2":
        return 2, [tb.key_source(keys), tb.index_source(total)]
    nb = n // 3 + off  # the union: two key columns, the tie from the row
    b, p = _col(cuda, nb, 1, 6), _col(cuda, n - nb, 2, 7)
    return 2, [tb.key_source(b, p),
               tb.index_source(n, nb, (0, (1 << 30) - nb), 0x7FFFFFFF)]


@pytest.mark.parametrize("mode", ["keys", "rider", "lex2", "union"])
@pytest.mark.parametrize("n", [(1 << 20) - 17, (1 << 20) - 16, 1 << 20,
                               12345])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_sort_edges_match_plain(cuda, mode, n, off):
    """chunk_sort's source form and finish's unbiasing form (keys, rider,
    lex2, the join's two-source lex2) on the mode's tiles (compile-time
    plans) and at half the tile (run-time plans), against the plain
    versions: the planes from ``source_planes_ref`` sorted by
    ``chunk_sort_ref``; the top level's ``finish_ref``, its keys unbiased
    in place and into n - 1 rows."""
    total = 1 << 20
    ncmp, sources = _sources(cuda, mode, n, off, total)
    p = len(sources)
    chunk, tile = CFG.mode_tiles(p, ncmp)
    made = tb.source_planes_ref(sources, 0, total, cuda)
    for c in (chunk, chunk // 2):
        k, rd, lx = tb._keywords(made, ncmp)
        want = tb.chunk_sort_ref(k, c, rider=rd, lex=lx)
        want = want if isinstance(want, tuple) else (want,)
        planes = [torch.full((total,), 5, dtype=torch.int32, device=cuda)
                  for _ in range(p)]
        k, rd, lx = tb._keywords(planes, ncmp)
        _reset_all()
        tb.chunk_sort_sources(k, c, sources, rider=rd, lex=lx)
        torch.cuda.synchronize()
        assert _no_plain_calls() and tb.LAUNCHES[tb.source_kernels(ncmp,
                                                                   p)[0]]
        assert all(torch.equal(a, b) for a, b in zip(planes, want)), c
    for t in (tile, tile // 2):
        k, rd, lx = tb._keywords(list(want), ncmp)
        ref = tb.finish_ref(k, t, 20, rider=rd, lex=lx)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for rows in (None, total - 1):
            got = [w.clone() for w in want]
            out = got[0] if rows is None else torch.zeros(
                rows, dtype=torch.int32, device=cuda)
            k, rd, lx = tb._keywords(got, ncmp)
            tb.finish(k, t, 20, rider=rd, lex=lx, key_out=(out, 0))
            torch.cuda.synchronize()
            assert torch.equal(out, ref[0][: out.numel()] ^ tb.SIGN), (t, rows)
            assert all(torch.equal(a, b) for a, b in zip(got[1:], ref[1:]))


def test_sorts_from_sources_on_the_card(cuda):
    """sort, sort_pairs, argsort, groupby and the union of a join on the
    card from their sources: no PyTorch preparation, the edges launched,
    every result against torch; peak memory of the keys sort: the input,
    the plane, no temporary."""
    from radx_tpu_torch import argsort, groupby, sort_pairs
    from radx_tpu_torch.ops import sort as ts

    n = (1 << 22) - 3
    k = _keys(cuda, n, 3).view(torch.uint32)
    v = _keys(cuda, n, 4)
    kb = k.view(torch.int32) ^ (-(1 << 31))
    o = torch.sort(kb, stable=True)
    ts.reset_prep_counts()
    _reset_all()
    got = sort(k)
    gk, gv = sort_pairs(k, v)
    ga = argsort(k)
    torch.cuda.synchronize()
    assert not any(ts.PREP_CALLS.values()) and _no_plain_calls()
    assert tb.LAUNCHES["chunk_sort/src"] and tb.LAUNCHES["finish/unbias"]
    assert tb.LAUNCHES["finish/unbias/lex2"]
    assert torch.equal(got.view(torch.int32), o.values ^ (-(1 << 31)))
    assert torch.equal(gk.view(torch.int32), o.values ^ (-(1 << 31)))
    assert torch.equal(gv, v[o.indices]) and torch.equal(ga.long(),
                                                         o.indices)
    g = (k.view(torch.int32) & 1023).view(torch.uint32)
    uk, sums, ng = groupby(g, v, "sum")
    assert tb.LAUNCHES["chunk_sort/src/rider"] and int(ng) == 1024
    want = torch.zeros(1024, dtype=torch.int64, device=cuda).index_add_(
        0, g.view(torch.int32).long(), v.long())
    assert torch.equal(sums[:1024].long() & 0xFFFFFFFF, want & 0xFFFFFFFF)
    n26 = 1 << 26
    keys = _keys(cuda, n26, 9).view(torch.uint32)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = sort(keys)
    torch.cuda.synchronize()
    # the plane (the result) and nothing of the keys' size beside it
    assert torch.cuda.max_memory_allocated() - before < 4 * n26 + (1 << 20)
    assert torch.equal(out.view(torch.int32), torch_sort_u32(keys).view(
        torch.int32))
    assert not any(ts.PREP_CALLS.values())


# --- the radix sort's first and last launches (K4's source form, K13's
# unbiasing form) ---------------------------------------------------------------


def _radix_sources(cuda, mode, n, off):
    """Sources of a radix sort of ``N`` rows: n random keys (1% 0xFFFFFFFF:
    a real run of the pads' key below a slot) ``off`` rows past a 16-byte
    boundary; a rider, or the index made from the row."""
    keys = _col(cuda, n, off, n + off)
    keys[::7] = _keys(cuda, n, 11)[::7]
    keys[::101] = -1
    if mode == "keys":
        return 1, [tb.key_source(keys)]
    if mode == "rider":
        return 1, [tb.key_source(keys),
                   tb.column_source(_col(cuda, n, 3 - off, 5), -7)]
    return 2, [tb.key_source(keys), tb.index_source(N)]


@pytest.mark.parametrize("mode", ["keys", "rider", "lex2"])
@pytest.mark.parametrize("n, off", [(N, 0), (N - 17, 1), (N - 1000, 3)])
def test_radix_edges_match_plain(cuda, mode, n, off):
    """K4's source form on both plans against ``chunk_sort_cyclic_ref`` of
    ``source_planes_ref``'s planes (radix chunks of 2^17, the mode's tile),
    and K13's unbiasing form against ``concat_ref``, plane 0 XORed, in
    place and into the first N - 3 rows, on the merged buckets of a sort
    from those sources (counted from the key source)."""
    from radx_tpu_torch.kernels import msd as tm
    from radx_tpu_torch.kernels import radix_sort as trs

    ncmp, sources = _radix_sources(cuda, mode, n, off)
    p = len(sources)
    c, f = RADIX.mode_tiles(p, ncmp)
    lc = c.bit_length() - 1
    made = tb.source_planes_ref(sources, 0, N, cuda)
    want = tb.chunk_sort_cyclic_ref(made, ncmp, R_CHUNK, c)
    for top in {False, tb.compile_time_plan("chunk_sort_cyclic", p, lc, lc)}:
        out = [torch.full((N,), 5, dtype=torch.int32, device=cuda)
               for _ in range(p)]
        _reset_all()
        tb._launch_cyclic_src(out, ncmp, R_CHUNK, c, sources, 0, top)
        _assert_planes_equal(out, want)
        assert tb.LAUNCHES[tb.radix_source_kernel(ncmp, p)] == 1
        assert tb.TOP_LAUNCHES[tb.radix_source_kernel(ncmp, p)] == int(top)
    plan = trs.plan(N, R_CHUNK)
    tail = ncmp == 1 and p == 2
    nv = N if tail else n
    sorted_ = tb.sort_chunks_ascending_cyclic(
        [torch.empty_like(x) for x in made], ncmp, plan.C, c, f,
        sources=sources)
    b = trs.rank_runs(*trs.rank_args(sorted_[0], sources[0], plan, nv,
                                     RADIX.mode_tiles(1, 1), tail))
    assert not bool(b.overflow)
    packed = tm.pack(sorted_, b.bounds, plan.C, plan.slot, plan.nb_pad, ncmp)
    merged = tb.merge_slots_ascending(packed, ncmp, plan.C, plan.slot, c, f)
    src = sorted_ if tail else None
    ref = tm.concat_ref(merged, src, b.start, b.src, plan.nb_pad, N, ncmp)
    for rows in (N, N - 3):
        out = [torch.full((N,), 5, dtype=torch.int32, device=cuda)
               for _ in range(p)]
        keys = out[0] if rows == N else torch.full(
            (rows,), 5, dtype=torch.int32, device=cuda)
        if rows != N:
            out[0] = keys if p == 1 else None
        tm.reset_counts()
        tm.concat(merged, src, out, b.start, b.src, plan.nb_pad, ncmp,
                  (keys, 0))
        torch.cuda.synchronize()
        assert tm.LAUNCHES[tm.unbias_kernel(ncmp, p)] == 1
        assert torch.equal(keys, ref[0][:rows] ^ tb.SIGN), rows
        assert all(torch.equal(a, w) for a, w in zip(out[1:], ref[1:]))


def test_radix_sorts_from_sources_on_the_card(cuda):
    """sort, sort_pairs, argsort and groupby under strategy="radix" on the
    card from their sources (2^23 rows: radix chunks of 2^17, slots of
    2048): no PyTorch preparation, K4's source form first and (where the
    keys come back) K13's unbiasing form last, every result against torch;
    the keys sort's peak memory: the input, then at most the sorted chunks
    and the packed slots, or the packed slots and the merged buckets, or
    the merged buckets and the output (no plane of the keys' size
    prepared beside them)."""
    from radx_tpu_torch import argsort, groupby, sort_pairs
    from radx_tpu_torch.kernels import msd as tm
    from radx_tpu_torch.kernels import radix_sort as trs
    from radx_tpu_torch.ops import sort as ts

    n = 1 << 23
    k = _keys(cuda, n, 3).view(torch.uint32)
    v = _keys(cuda, n, 4)
    kb = k.view(torch.int32) ^ (-(1 << 31))
    o = torch.sort(kb, stable=True)
    ts.reset_prep_counts()
    _reset_all()
    tm.reset_counts()
    got = sort(k, RADIX)
    gk, gv = sort_pairs(k, v, RADIX)
    ga = argsort(k, RADIX)
    torch.cuda.synchronize()
    assert not any(ts.PREP_CALLS.values()) and _no_plain_calls()
    assert tb.LAUNCHES["chunk_sort_cyclic/src"] == 1
    assert tb.LAUNCHES["chunk_sort_cyclic/src/lex2"] == 2
    assert tm.LAUNCHES["radix_concat/unbias"] == 1
    assert tm.LAUNCHES["radix_concat/unbias/lex2"] == 1  # argsort: none
    assert tm.LAUNCHES["radix_concat/lex2"] == 1
    assert torch.equal(got.view(torch.int32), o.values ^ (-(1 << 31)))
    assert torch.equal(gk.view(torch.int32), o.values ^ (-(1 << 31)))
    assert torch.equal(gv, v[o.indices]) and torch.equal(ga.long(),
                                                         o.indices)
    g = (k.view(torch.int32) & 1023).view(torch.uint32)
    uk, sums, ng = groupby(g[: n - 999], v[: n - 999], "sum", RADIX)
    assert tm.LAUNCHES["radix_concat/unbias/rider"] == 1 and int(ng) == 1024
    want = torch.zeros(1024, dtype=torch.int64, device=cuda).index_add_(
        0, g[: n - 999].view(torch.int32).long(), v[: n - 999].long())
    assert torch.equal(sums[:1024].long() & 0xFFFFFFFF, want & 0xFFFFFFFF)
    assert not any(ts.PREP_CALLS.values())
    p = trs.plan(n, trs.pick_chunk(n, RADIX.chunk_elems))
    slots = 4 * p.nb_pad * p.C
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = sort(k, RADIX)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < max(
        4 * n + slots, 2 * slots) + (8 << 20)
    assert torch.equal(out.view(torch.int32), o.values ^ (-(1 << 31)))
