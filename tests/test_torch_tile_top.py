"""The compile-time plans of ``chunk_sort`` (K1) and of K2's strided tile
pass (csrc/bitonic.cu ``chunk_sort_kernel`` with LOG_T > 0 and
``cross_stage_kernel`` with F > R, both through ``top_pass``), on the CPU,
without JAX.

A chunk sort of the mode's chunk tile and a strided cross pass over the
mode's cross tile run plans that depend only on the plane count; the
kernels lay them out at compile time (``csrc/bitonic.cu`` ``top_code``,
mirrored by ``kernels/bitonic.py::top_plan``) and pick each level's
direction rule at compile time (``top_levels``): the tile's base bit, a
register bit, or a bit of the group index, which is branched on only where
it is one for a warp's 32 lanes and otherwise taken without a branch.  For
keys, rider and lex2..lex8, at the modes' own tiles and at small ones:

  * the layout equals ``tile_plan``;
  * every phase holds every row of the tile once, so the first phase reads
    each row once and the last one writes each row once;
  * the network run phase by phase with the kernel's direction rule equals
    ``chunk_sort_ref`` / ``cross_stage_ref`` bit for bit (tolerance 0, keys
    with ties, 0x7FFFFFFF and -1, ``invert``, ``ascending``, a span);
  * every level the kernel branches on has one direction across each warp,
    and the levels it takes without a branch are the ones whose lanes
    differ (30 + 6 of 105 substages at 2^14 keys, register-bit levels
    second);
  * the rule ``compile_time_plan`` picks the compile-time kernel exactly
    where it applies, and the wrappers pass its answer to the launch;
  * a sort's first load from its sources at PH == 0 (csrc/tile_engine.cuh
    ``Sources``: int4 runs only inside one column, below n and aligned,
    so every read stays inside its column and reads each row once) and
    its last store of the keys unbiased (``KeyOut``), around the chunk
    sort's compile-time plan, equal to ``source_planes_ref`` and
    ``chunk_sort_ref`` bit for bit.
"""

import collections

import numpy as np
import pytest
import torch

from radx_tpu_torch import SortConfig
from radx_tpu_torch.kernels import bitonic as tb

MODES = {"keys": (1, 1), "rider": (1, 2),
         **{f"lex{p}": (2, p) for p in range(2, 9)}}
LANES = 32  # a warp's lanes: the low five bits of the group index


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planes(rng, ncmp, p, n):
    """Keys in [0, 4) with 0x7FFFFFFF (the largest key, 0xFFFFFFFF before
    the bias) and -1 among them; in lex mode plane 1 in [0, 4) too; random
    riders."""
    keys = rng.integers(0, 4, n).astype(np.int32)
    keys[rng.random(n) < 0.2] = 0x7FFFFFFF
    keys[rng.random(n) < 0.1] = -1
    out = [keys]
    if ncmp == 2:
        out.append(rng.integers(0, 4, n).astype(np.int32))
    while len(out) < p:
        out.append(rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                   .astype(np.int32))
    return [torch.from_numpy(x) for x in out]


def _log(x):
    return x.bit_length() - 1


def _strided_cases():
    """(mode, f): every strided pass a mode's cap allows (f > R)."""
    return [(mode, f) for mode, (_, p) in MODES.items()
            for f in range(tb.max_fusion(p) + 1, tb.cross_fusion(p) + 1)]


def _exchange(ncmp, a, b, up):
    """The kernel's tie-safe exchange of the register columns a (low) and b
    (high), lists of plane tensors; returns the new (a, b)."""
    if len(a) == 1:
        mn, mx = torch.minimum(a[0], b[0]), torch.maximum(a[0], b[0])
        return [torch.where(up, mn, mx)], [torch.where(up, mx, mn)]
    a1, b1 = (a[1], b[1]) if ncmp == 2 else (None, None)
    swap = torch.where(up, tb._after(ncmp, a[0], b[0], a1, b1),
                       tb._after(ncmp, b[0], a[0], b1, a1))
    return ([torch.where(swap, y, x) for x, y in zip(a, b)],
            [torch.where(swap, x, y) for x, y in zip(a, b)])


def _rule(ph, kk, log_t, r):
    """Where top_levels takes level kk's direction in phase ``ph``:
    "tile" (the tile's base bit), "register" (a register bit, known at
    compile time), "warp" (a group-index bit above the lanes: a branch
    that never splits a warp) or "lanes" (a lane bit: no branch)."""
    wlo = ph[4]
    if kk >= log_t:
        return "tile"
    if kk - wlo < r:
        return "register"
    return "warp" if kk - r >= 5 else "lanes"


def _top_network(views, ncmp, log_t, r, plan, tile_bits, invert):
    """The kernel's top_pass in plain torch over (tiles, 2^log_t) views of
    the planes (changed in place): every phase of ``plan`` in (tiles,
    groups, 2^r) register views, each level's direction by the kernel's
    rule; ``tile_bits(kk)``: bit kk of each tile's direction base."""
    w = 1 << r
    for ph in plan:
        kk_a, kk_b, hi, lo, wlo = ph
        rows = tb.phase_rows(ph, log_t, r)
        gb = rows[:, 0]
        v = [x[:, rows] for x in views]
        for kk in range(kk_a, kk_b + 1):
            how = _rule(ph, kk, log_t, r)
            if how == "tile":
                up = (tile_bits(kk) == int(invert))[:, None, None]
            elif how == "register":
                u = torch.arange(w)
                up = (((u >> (kk - wlo)) & 1) == int(invert))[None, None, :]
            else:  # bit kk of the group's first row
                up = (((gb >> kk) & 1) == int(invert))[None, :, None]
            up = up.expand(v[0].shape)
            for sb in range(min(hi, kk - 1) - wlo, lo - wlo - 1, -1):
                shape = (*v[0].shape[:-1], w >> (sb + 1), 2, 1 << sb)
                pairs = [q.view(shape) for q in v]
                a, b = _exchange(ncmp, [q[..., 0, :] for q in pairs],
                                 [q[..., 1, :] for q in pairs],
                                 up.reshape(shape)[..., 0, :])
                for q, na, nb in zip(pairs, a, b):
                    q[..., 0, :] = na
                    q[..., 1, :] = nb
        for x, y in zip(views, v):
            x[:, rows] = y


# --- the layouts -------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_chunk_layout_is_tile_plan(mode):
    ncmp, p = MODES[mode]
    r = tb.max_fusion(p)
    tile = SortConfig().mode_tiles(p, ncmp)[0]
    assert tile == tb.top_tile(p)
    for log_t in (r + 1, 7, 9, _log(tile)):
        assert tb.top_plan(log_t, 0, r) == tb.tile_plan(log_t, 1, log_t, r)
    # 28 round trips a 2^14 chunk at R = 4 (105 in a loop of one substage)
    if p == 1:
        assert len(tb.top_plan(14, 0, 4)) - 1 == tb.round_trips(14, 1, 14, 1)


@pytest.mark.parametrize("mode, f", _strided_cases())
def test_strided_layout_is_tile_plan(mode, f):
    _, p = MODES[mode]
    r = tb.max_fusion(p)
    log_t = _log(tb.cross_tile(p))
    lo_bit = log_t - f
    assert lo_bit >= 0
    for kk in (log_t, log_t + 3, 40):
        plan = tb.tile_plan(log_t, kk, kk, r, lo_bit)
        assert tb.top_plan(log_t, kk, r, lo_bit) == plan
        # the tile's bits log_t - 1 .. lo_bit, highest first, R a phase
        bits = [b for ph in plan for b in range(ph[2], ph[3] - 1, -1)]
        assert bits == list(range(log_t - 1, lo_bit - 1, -1))
        assert len(plan) == -(-f // r)
    # what a sort path runs: j_low at the finish tile or above, which is at
    # least the cross tile, so the segment is the cross tile's
    fin = SortConfig().mode_tiles(p, MODES[mode][0])[1]
    for j_low in (_log(fin), _log(fin) + 5):
        log_l = tb.cross_segment(p, j_low, f)
        assert log_l + f == log_t


def _every_row_once(plan, log_t, r):
    t = 1 << log_t
    for ph in plan:
        rows = tb.phase_rows(ph, log_t, r).reshape(-1)
        assert torch.equal(torch.bincount(rows, minlength=t),
                           torch.ones(t, dtype=torch.int64)), ph
        kk_a, kk_b, hi, lo, wlo = ph
        assert wlo <= lo <= hi < wlo + r  # its bits in its register window


@pytest.mark.parametrize("mode", list(MODES))
def test_chunk_phases_read_and_write_every_row_once(mode):
    _, p = MODES[mode]
    r = tb.max_fusion(p)
    log_t = _log(tb.top_tile(p))
    plan = tb.top_plan(log_t, 0, r)
    _every_row_once(plan, log_t, r)
    # the first and the last phase hold runs of 2^r rows: int4 rows
    for ph in (plan[0], plan[-1]):
        rows = tb.phase_rows(ph, log_t, r)
        assert ph[4] == 0 and torch.equal(rows[1], torch.arange(1 << r,
                                                                2 << r))


@pytest.mark.parametrize("mode, f", _strided_cases())
def test_strided_phases_read_and_write_every_row_once(mode, f):
    _, p = MODES[mode]
    r = tb.max_fusion(p)
    log_t = _log(tb.cross_tile(p))
    plan = tb.top_plan(log_t, log_t, r, log_t - f)
    _every_row_once(plan, log_t, r)
    # the first and last phases' lanes hold consecutive rows of a segment
    # (of 2^(log_t - f) rows): coalesced loads and stores
    run = min(LANES, 1 << (log_t - f))
    for ph in (plan[0], plan[-1]):
        rows = tb.phase_rows(ph, log_t, r)
        assert torch.equal(rows[:run, 0] - rows[0, 0], torch.arange(run))
    # and the tiles of a pass cover the array once
    j_low = log_t - f + 2
    idx, _ = _strided_tiles(1 << (j_low + f + 1), j_low, f, log_t - f)
    n = 1 << (j_low + f + 1)
    assert torch.equal(torch.bincount(idx.reshape(-1), minlength=n),
                       torch.ones(n, dtype=torch.int64))


# --- the network through the compile-time plan -------------------------------


def _chunk_case(ncmp, p, log_t, n_tiles, invert, ascending, seed):
    r = tb.max_fusion(p)
    t = 1 << log_t
    planes = _planes(np.random.default_rng(seed), ncmp, p, n_tiles * t)
    views = [q.reshape(-1, t).clone() for q in planes]
    base = torch.arange(n_tiles, dtype=torch.int64) * t
    dbase = torch.zeros_like(base) if ascending else base
    _top_network(views, ncmp, log_t, r, tb.top_plan(log_t, 0, r),
                 lambda kk: (dbase >> kk) & 1, invert)
    k, rd, lx = tb._keywords(planes, ncmp)
    want = tb.chunk_sort_ref(k, t, invert=invert, ascending=ascending,
                             rider=rd, lex=lx)
    want = want if isinstance(want, tuple) else (want,)
    got = [x.reshape(-1) for x in views]
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (
        log_t, invert, ascending)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("invert, ascending",
                         ((False, False), (True, False), (False, True),
                          (True, True)))
def test_chunk_network_matches_chunk_sort_ref(mode, invert, ascending):
    """Small tiles (every rule of top_levels but the widest warp bits) on
    eight tiles of both directions."""
    ncmp, p = MODES[mode]
    for log_t in (tb.max_fusion(p) + 1, 8):
        _chunk_case(ncmp, p, log_t, 8, invert, ascending, 10 * log_t + p)


@pytest.mark.parametrize("mode", list(MODES))
def test_chunk_network_at_the_mode_tile(mode):
    """The mode's own tile, as the kernel instance runs it: two chunks
    (one of each direction), and one inverted chunk sort ascending."""
    ncmp, p = MODES[mode]
    log_t = _log(tb.top_tile(p))
    _chunk_case(ncmp, p, log_t, 2, False, False, 7 * p)
    _chunk_case(ncmp, p, log_t, 1, True, True, 7 * p + 1)


def _strided_tiles(n, j_low, f, log_l):
    """(blocks, 2^(log_l + f)) rows of each strided tile as the kernel maps
    them (``Strided``: segment u at base + u * 2^j_low), and each tile's
    base: the block's bits between the segment and j_low, and above j_low +
    f."""
    t = 1 << (log_l + f)
    b = torch.arange(n // t, dtype=torch.int64)
    low = j_low - log_l
    base = ((b >> low) << (j_low + f)) | ((b & ((1 << low) - 1)) << log_l)
    i = torch.arange(t, dtype=torch.int64)
    rows = ((i >> log_l) << j_low) + (i & ((1 << log_l) - 1))
    return base[:, None] + rows[None, :], base


def _strided_case(ncmp, p, f, log_t, j_low, kk, invert, span, seed):
    r = tb.max_fusion(p)
    log_l = log_t - f
    n = 1 << (j_low + f + 1)
    planes = _planes(np.random.default_rng(seed), ncmp, p, n)
    idx, base = _strided_tiles(n, j_low, f, log_l)
    dbase = base & (n - 1 if span is None else span - 1)
    views = [q[idx] for q in planes]
    _top_network(views, ncmp, log_t, r, tb.top_plan(log_t, kk, r, log_l),
                 lambda k: (dbase >> k) & 1, invert)
    got = [q.clone() for q in planes]
    for q, v in zip(got, views):
        q[idx] = v
    k, rd, lx = tb._keywords(planes, ncmp)
    want = tb.cross_stage_ref(k, j_low, f, kk, invert, rd, lx, span)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (
        f, log_t, j_low, kk, invert, span)


@pytest.mark.parametrize("mode, f", _strided_cases())
def test_strided_network_matches_cross_stage_ref(mode, f):
    """Segments of 4 rows (the layout at a small tile), then the mode's own
    cross tile: the lowest distance at the segment and above it, a level
    just above the pass and the top level, inverted, under a span."""
    ncmp, p = MODES[mode]
    seed = 100 * f + p
    log_t = f + 2
    for j_low, kk, invert, span in ((2, f + 2, False, None),
                                    (4, f + 5, True, None),
                                    (3, f + 3, False, 1 << (f + 3))):
        _strided_case(ncmp, p, f, log_t, j_low, kk, invert, span, seed)
    log_t = _log(tb.cross_tile(p))
    j_low = log_t - f + 1
    _strided_case(ncmp, p, f, log_t, j_low, j_low + f + 1, True, None, seed)


# --- which levels branch -----------------------------------------------------


@pytest.mark.parametrize("mode, counts",
                         (("keys", (105, 30, 6)), ("rider", (91, 30, 6)),
                          ("lex2", (91, 30, 6)), ("lex3", (91, 30, 6)),
                          ("lex4", (78, 25, 3)), ("lex6", (78, 25, 3)),
                          ("lex7", (66, 20, 1)), ("lex8", (66, 20, 1))))
def test_no_branch_splits_a_warp(mode, counts):
    """At the mode's chunk tile: every level whose direction is a bit of
    the group index that top_levels branches on ("warp") is one direction
    for each warp's 32 lanes; the levels it runs without a branch
    ("lanes") are exactly those whose lanes differ; the substages of each
    rule (all, lanes, register) as counted from the plan."""
    _, p = MODES[mode]
    r = tb.max_fusion(p)
    log_t = _log(tb.top_tile(p))
    total = {"tile": 0, "register": 0, "warp": 0, "lanes": 0}
    for ph in tb.top_plan(log_t, 0, r):
        kk_a, kk_b, hi, lo, wlo = ph
        rows = tb.phase_rows(ph, log_t, r)
        gb = rows[:, 0]
        g = torch.arange(rows.shape[0])
        assert rows.shape[0] % LANES == 0
        for kk in range(kk_a, kk_b + 1):
            how = _rule(ph, kk, log_t, r)
            total[how] += min(hi, kk - 1) - lo + 1
            if how in ("warp", "lanes"):
                bit = (gb >> kk) & 1
                assert torch.equal(bit, (g >> (kk - r)) & 1)
                one = (bit.view(-1, LANES) == bit.view(-1, LANES)[:, :1])
                assert bool(one.all()) == (how == "warp"), (ph, kk)
    assert (sum(total.values()), total["lanes"], total["register"]) == counts
    # the compile-time finish and strided plans take one direction a tile
    for plan in (tb.top_plan(log_t, log_t, r),
                 tb.top_plan(_log(tb.cross_tile(p)), 40, r,
                             _log(tb.cross_tile(p)) - r - 1)):
        assert {_rule(ph, ph[0], log_t, r) for ph in plan} == {"tile"}


# --- the rule and the wrappers -----------------------------------------------


def test_rule_picks_each_compile_time_plan_where_it_applies():
    rule = tb.compile_time_plan
    for mode, (ncmp, p) in MODES.items():
        r = tb.max_fusion(p)
        lt = _log(tb.top_tile(p))
        ct = _log(tb.cross_tile(p))
        assert rule("chunk_sort", p, lt, lt)
        assert not rule("chunk_sort", p, lt - 1, lt - 1)  # another chunk
        assert not rule("chunk_sort", p, lt + 1, lt + 1)
        landed = p in tb.TOP_MODES["cross_stage"]
        for f in range(1, tb.cross_fusion(p) + 1):
            # the sort paths' geometry: the segment fills the cross tile
            assert rule("cross_stage", p, ct, ct + 3, ct - f) == (
                f > r and landed), f
            # a segment cut by j_low below the cross tile: run-time plan
            assert not rule("cross_stage", p, ct - 1, ct + 3, ct - 1 - f)
        assert rule("finish", p, lt, lt + 3)
        assert not rule("finish", p, lt, lt - 1)
    assert set(tb.TOP_MODES) == {"chunk_sort", "cross_stage", "finish",
                                 "chunk_sort_cyclic", "slot_merge"}
    # the strided pass's compile-time plan measured faster for keys only
    assert tb.TOP_MODES["cross_stage"] == {1}
    assert tb.TOP_MODES["chunk_sort"] == tb.TOP_MODES["finish"] == set(
        range(1, 9))


def _recorded_launches(monkeypatch, run):
    """The launches ``run`` makes, as (name, C function, arguments), with
    the card's launch replaced by a recorder (no kernel runs)."""
    seen = []
    monkeypatch.setattr(tb, "_on_cuda", lambda *a, **k: True)
    monkeypatch.setattr(tb._build, "launch",
                        lambda counts, name, fn, dev, *args:
                        seen.append((name, fn, args)))
    run()
    return seen


@pytest.mark.parametrize("mode", ("keys", "rider", "lex2", "lex5", "lex8"))
def test_wrappers_pass_the_rule_to_the_launch(monkeypatch, mode):
    """A whole sort's launches on the mode's tiles: the chunk sort, every
    finish level and (keys) every strided pass on the compile-time plan,
    every register pass (f <= R) and the other modes' strided passes on
    theirs; with other tiles, the chunk sort and finish on the run-time
    plan."""
    ncmp, p = MODES[mode]
    r = tb.max_fusion(p)
    chunk, fin = SortConfig().mode_tiles(p, ncmp)
    n = fin << 12  # meta tensors: shapes only, no kernel runs
    planes = [torch.empty(n, dtype=torch.int32, device="meta")
              for _ in range(p)]
    k, rd, lx = tb._keywords(planes, ncmp)
    for c, t, top in ((chunk, fin, 1), (chunk // 2, fin * 2, 0)):
        seen = _recorded_launches(
            monkeypatch, lambda: tb.sort_planes(k, c, t, rider=rd, lex=lx))
        by_fn = {}
        for name, fn, args in seen:
            by_fn.setdefault(fn, []).append((name, args))
        ((_, chunk_args),) = by_fn["radx_chunk_sort"]
        assert chunk_args[-1] == top
        for name, args in by_fn["radx_cross_stage"]:
            f = args[6]  # after planes, np, ncmp, n, rows, j_low
            assert name.startswith(f"cross_stage<{f}>")
            landed = p in tb.TOP_MODES["cross_stage"]
            assert args[-1] == int(f > r and landed), (name, args)
        assert {args[-1] for _, args in by_fn["radx_finish"]} == {top}
        assert any(args[6] > r for _, args in by_fn["radx_cross_stage"])


# --- a sort's first load and last store (csrc/tile_engine.cuh Sources, KeyOut)


def _source_load(sources, base, log_t, r):
    """The kernel's first load of a tile from sources (``rows_from_global``
    over ``Sources``, PH == 0: runs of 2^r rows, wlo = 0): a run of a column
    moves as int4 vectors where it lies in one column, below n, at a 16-byte
    aligned address, else row by row; an index is made, not read.  Returns
    the tile's planes and, per plane, the column elements each read
    touched, as (column, first, last) element ranges."""
    w, t = 1 << r, 1 << log_t
    planes, reads = [], []
    for s in sources:
        vals, touched = [], []
        starts = [0]
        for c in s.cols:
            starts.append(starts[-1] + c.numel())
        for gb in range(0, t, w):
            r0 = base + gb
            second = r0 >= s.split
            c = 1 if second and len(s.cols) > 1 else 0
            at = r0 - starts[c]
            addr = (s.cols[c].data_ptr() + 4 * at) if s.cols else 1
            if (s.cols and r0 + w <= s.n and (second or r0 + w <= s.split)
                    and addr % 16 == 0):
                touched.append((c, at, at + w - 1))
                vals += (s.cols[c][at: at + w] ^ s.xor).tolist()
                continue
            for row in range(r0, r0 + w):
                if row >= s.n:
                    vals.append(row if s.pad is None else s.pad)
                elif not s.cols:
                    vals.append(row + s.add[row >= s.split])
                else:
                    c = int(row >= s.split and len(s.cols) > 1)
                    touched.append((c, row - starts[c], row - starts[c]))
                    vals.append(int(s.cols[c][row - starts[c]]) ^ s.xor)
        planes.append(torch.tensor(vals, dtype=torch.int64).to(torch.int32))
        reads.append(touched)
    return planes, reads


def _key_store(out, row_limit, base, plane0):
    """The kernel's last store of plane 0 (``rows_to_global`` over
    ``KeyOut``): rows below the limit XORed with 0x80000000."""
    m = min(max(row_limit - base, 0), plane0.numel())
    out[base: base + m] = plane0[:m] ^ tb.SIGN


@pytest.mark.parametrize("mode", ("keys", "rider", "lex2"))
@pytest.mark.parametrize("n, off", ((4096, 0), (4095, 1), (4097, 3),
                                    (4000, 2), (16 * 200 + 1, 0)))
def test_top_pass_from_sources_to_an_unbiased_store(mode, n, off):
    """The compile-time chunk sort's plan with the first phase loading from
    sources (the keys biased, a rider with a neutral pad, or, lex2, the
    join's two key columns and its tie) and the last phase storing plane 0
    unbiased into n rows: every read inside its column, each column row
    read once, the loaded tile equal to ``source_planes_ref``, the network
    then ``chunk_sort_ref``'s, the store the rows below n XORed."""
    ncmp, p = MODES[mode]
    r = tb.max_fusion(p)
    log_t = 8
    t = 1 << log_t
    total = -(-n // t) * t + t
    rng = np.random.default_rng(n + off)
    k = rng.integers(0, 2**32, n, dtype=np.uint32)
    k[rng.random(n) < 0.3] = 0xFFFFFFFF
    buf = torch.empty(n + 8, dtype=torch.int32)
    keys = buf[off: off + n]
    keys.copy_(torch.from_numpy(k.view(np.int32)))
    if mode == "keys":
        sources = [tb.key_source(keys)]
    elif mode == "rider":
        sources = [tb.key_source(keys), tb.column_source(keys.flip(0)
                                                         .contiguous(), -7)]
    else:
        nb = n // 3 + off
        other = torch.empty(n + 8, dtype=torch.int32)[3 - off:]
        other[: n - nb] = keys[nb:]
        sources = [tb.key_source(keys[:nb], other[: n - nb]),
                   tb.index_source(n, nb, (0, (1 << 30) - nb), 0x7FFFFFFF)]
    want = tb.source_planes_ref(sources, 0, total, "cpu")
    tiles = [[] for _ in range(p)]
    seen = [collections.Counter() for _ in range(p)]
    for base in range(0, total, t):
        planes, reads = _source_load(sources, base, log_t, r)
        for j in range(p):
            tiles[j].append(planes[j])
            for c, a, b in reads[j]:
                cols = sources[j].cols
                assert 0 <= a <= b < cols[c].numel(), (mode, base, a, b)
                seen[j].update((c, i) for i in range(a, b + 1))
    for j, s in enumerate(sources):
        assert all(v == 1 for v in seen[j].values())
        assert sum(seen[j].values()) == (s.n if s.cols else 0)
    views = [torch.stack(x) for x in tiles]
    assert all(torch.equal(v.reshape(-1), w) for v, w in zip(views, want))
    base = torch.arange(total // t, dtype=torch.int64) * t
    _top_network(views, ncmp, log_t, r, tb.top_plan(log_t, 0, r),
                 lambda kk: (base >> kk) & 1, False)
    kw, rd, lx = tb._keywords(want, ncmp)
    ref = tb.chunk_sort_ref(kw, t, rider=rd, lex=lx)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = [v.reshape(-1) for v in views]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    out = torch.zeros(n, dtype=torch.int32)
    for b in range(0, total, t):
        _key_store(out, n, b, got[0][b: b + t])
    assert torch.equal(out, ref[0][:n] ^ tb.SIGN)
