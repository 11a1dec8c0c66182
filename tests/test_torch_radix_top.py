"""The compile-time plans of the radix sort's tile passes, K4
``chunk_sort_cyclic`` and K5 ``slot_merge`` (csrc/bitonic.cu
``chunk_sort_cyclic_kernel`` / ``slot_merge_kernel`` with LOG_T > 0, both
through the out-of-place ``top_pass``), on the CPU, without JAX.

K4 runs the chunk sort's plan (``top_plan(log_t, 0, r)``) over tiles read
through the block-cyclic map (``Cyclic``); K5 the levels log_s + 1 ..
log_t (``top_plan(log_t, log_s + 1, r)``) over tiles read with the odd
slots reversed (``SlotReversed``); both write their tile contiguously to
other planes.  For keys, rider and lex2..lex8, at the modes' own tiles and
at small ones:

  * K5's layout equals ``tile_plan(log_t, log_s + 1, log_t, R)`` for every
    slot, among them every slot with a kernel (2^10 up to half the tile);
  * through the kernels' maps, every input row is read once and every
    output row written once across a pass's tiles;
  * the network run phase by phase with the kernel's direction rule
    (``top_levels``) equals ``chunk_sort_cyclic_ref`` / ``slot_merge_ref``
    bit for bit (tolerance 0; keys with ties, 0x7FFFFFFF and -1; radix
    chunks larger than the tile);
  * every level that the K5 kernel branches on has one direction for each
    warp;
  * the rule ``compile_time_plan`` picks the two kernels exactly where they
    apply, and the wrappers, and a whole ``sort_radix``, pass its answer to
    the launch.
"""

import numpy as np
import pytest
import torch

from radx_tpu_torch import SortConfig
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.kernels import msd
from radx_tpu_torch.kernels import radix_sort as RS

MODES = {"keys": (1, 1), "rider": (1, 2),
         **{f"lex{p}": (2, p) for p in range(2, 9)}}
LANES = 32  # a warp's lanes: the low five bits of the group index
LANDED = {"chunk_sort_cyclic": {1, 2}, "slot_merge": {1, 2}}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _log(x):
    return x.bit_length() - 1


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


def _slots(log_t):
    """log2 of every slot that has a compile-time kernel at a tile of
    2^log_t rows: 2^10 up to half the tile."""
    return range(tb.MIN_TOP_SLOT_LOG, log_t)


# --- the kernels' maps, block by block (csrc/bitonic.cu) ---------------------


def _cyclic_rows(n, chunk, log_t):
    """(blocks, 2^log_t) input rows of K4's tiles (``Cyclic``: block b is
    tile lb = (b << log_t) mod chunk of radix chunk b >> (log_c - log_t),
    whose rows are the chunk's 1024-row tiles {g * n_chunks + c}) and each
    tile's base lb within its chunk."""
    b = torch.arange(n >> log_t, dtype=torch.int64)
    lb = (b << log_t) & (chunk - 1)
    c = b >> (_log(chunk) - log_t)
    e = lb[:, None] + torch.arange(1 << log_t)[None, :]
    cyc = tb.CYCLIC_TILE
    return ((e // cyc) * (n // chunk) + c[:, None]) * cyc + e % cyc, lb


def _slot_rows(n, log_t, log_s):
    """(blocks, 2^log_t) input rows of K5's tiles (``SlotReversed``: row g =
    base + i, read at g ^ (S - 1) in an odd slot of S = 2^log_s rows) and
    each tile's base."""
    base = torch.arange(n >> log_t, dtype=torch.int64) << log_t
    g = base[:, None] + torch.arange(1 << log_t)[None, :]
    return torch.where(((g >> log_s) & 1) == 1, g ^ ((1 << log_s) - 1),
                       g), base


# --- the network as top_levels runs it ---------------------------------------


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
    "tile" (the tile's base bit), "register" (a register bit), "warp" (a
    group-index bit above the lanes: a branch that never splits a warp) or
    "lanes" (a lane bit: no branch)."""
    if kk >= log_t:
        return "tile"
    if kk - ph[4] < r:
        return "register"
    return "warp" if kk - r >= 5 else "lanes"


def _top_pass(planes, rows, ncmp, log_t, r, plan, tile_bits):
    """The kernel's out-of-place top_pass in plain torch: every tile's rows
    read through ``rows`` (blocks, 2^log_t), every phase of ``plan`` in
    (blocks, groups, 2^r) register views with each level's direction by the
    kernel's rule (``invert`` 0), each tile written contiguously;
    ``tile_bits(kk)``: bit kk of each tile's direction base."""
    w = 1 << r
    views = [q[rows] for q in planes]
    for ph in plan:
        kk_a, kk_b, hi, lo, wlo = ph
        at = tb.phase_rows(ph, log_t, r)
        gb = at[:, 0]
        v = [x[:, at] for x in views]
        for kk in range(kk_a, kk_b + 1):
            how = _rule(ph, kk, log_t, r)
            if how == "tile":
                up = (tile_bits(kk) == 0)[:, None, None]
            elif how == "register":
                up = (((torch.arange(w) >> (kk - wlo)) & 1) == 0)[None, None]
            else:  # bit kk of the group's first row
                up = (((gb >> kk) & 1) == 0)[None, :, None]
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
            x[:, at] = y
    return [x.reshape(-1) for x in views]


# --- the layouts -------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_slot_layout_is_tile_plan(mode):
    ncmp, p = MODES[mode]
    r = tb.max_fusion(p)
    lt = _log(tb.top_tile(p))
    assert 1 << lt == max(SortConfig().mode_tiles(p, ncmp))
    for log_t in (r + 1, 7, 9, lt):
        for log_s in range(0, log_t):
            want = tb.tile_plan(log_t, log_s + 1, log_t, r)
            assert tb.top_plan(log_t, log_s + 1, r) == want, (log_t, log_s)
        # K4 runs the chunk sort's layout
        assert tb.top_plan(log_t, 0, r) == tb.tile_plan(log_t, 1, log_t, r)
    # every slot with a kernel: level k at bits k - 1 .. 0 in ceil(k / R)
    # phases, highest first, no level merged into another's phase
    for log_s in _slots(lt):
        plan = tb.top_plan(lt, log_s + 1, r)
        assert [ph[0] for ph in plan] == [k for k in range(log_s + 1, lt + 1)
                                          for _ in range(-(-k // r))]
        assert all(ph[0] == ph[1] for ph in plan)
        assert len(plan) - 1 == tb.round_trips(lt, log_s + 1, lt, p)


@pytest.mark.parametrize("mode, log_t, slot, trips",
                         (("keys", 14, 1024, 13), ("keys", 14, 4096, 7),
                          ("rider", 13, 1024, 9), ("lex2", 13, 4096, 3)))
def test_slot_round_trips_at_the_radix_geometries(mode, log_t, slot, trips):
    """The cells' geometries: 2^28 keys (slots of 1024), 2^26 (4096)."""
    r = tb.max_fusion(MODES[mode][1])
    assert len(tb.top_plan(log_t, _log(slot) + 1, r)) - 1 == trips


def _every_row_once(idx, n):
    assert torch.equal(torch.bincount(idx.reshape(-1), minlength=n),
                       torch.ones(n, dtype=torch.int64))


@pytest.mark.parametrize("mode", list(MODES))
def test_maps_read_and_write_every_row_once(mode):
    """Across a pass's tiles, at the mode's tile (radix chunks of one and
    of four tiles) and a small one: the first phase reads every input row
    once (K4 as int4 runs of 2^R rows at consecutive addresses, K5's lanes
    on consecutive rows), the last writes every output row once
    (contiguously, int4 runs)."""
    _, p = MODES[mode]
    r = tb.max_fusion(p)
    lt = _log(tb.top_tile(p))
    for log_t in (lt, 7):
        t = 1 << log_t
        plan = tb.top_plan(log_t, 0, r)
        first, last = plan[0], plan[-1]
        for chunk in sorted({max(t, tb.CYCLIC_TILE), max(4 * t, 2048)}):
            n = 2 * chunk
            rows, _ = _cyclic_rows(n, chunk, log_t)
            _every_row_once(rows, n)
            at = tb.phase_rows(first, log_t, r)
            runs = rows[:, at]  # (blocks, groups, 2^r)
            assert first[4] == 0 and torch.equal(
                runs - runs[..., :1], torch.arange(1 << r).expand_as(runs))
            assert last[4] == 0
            out = (torch.arange(n >> log_t)[:, None] << log_t) + \
                tb.phase_rows(last, log_t, r).reshape(-1)[None, :]
            _every_row_once(out, n)
        n = 8 * t
        for log_s in range(max(0, log_t - 4), log_t):
            rows, _ = _slot_rows(n, log_t, log_s)
            _every_row_once(rows, n)
            plan = tb.top_plan(log_t, log_s + 1, r)
            assert plan[-1][4] == 0
            if log_t == lt and log_s in _slots(lt):
                # a kernel's first phase: its window 2^7 rows or more apart,
                # so a warp's lanes read consecutive rows, ascending or
                # descending
                at = tb.phase_rows(plan[0], log_t, r)
                assert plan[0][4] >= 7
                step = rows[:, at[1:LANES, 0]] - rows[:, at[:LANES - 1, 0]]
                assert bool((step.abs() == 1).all())


# --- the network through the compile-time plans -----------------------------


def _cyclic_case(ncmp, p, log_t, chunk, n, seed):
    r = tb.max_fusion(p)
    planes = _planes(np.random.default_rng(seed), ncmp, p, n)
    rows, lb = _cyclic_rows(n, chunk, log_t)
    got = _top_pass(planes, rows, ncmp, log_t, r, tb.top_plan(log_t, 0, r),
                    lambda kk: (lb >> kk) & 1)
    want = tb.chunk_sort_cyclic_ref(planes, ncmp, chunk, 1 << log_t)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (log_t, chunk)


def _slot_case(ncmp, p, log_t, log_s, chunk, n, seed):
    r = tb.max_fusion(p)
    planes = _planes(np.random.default_rng(seed), ncmp, p, n)
    rows, base = _slot_rows(n, log_t, log_s)
    got = _top_pass(planes, rows, ncmp, log_t, r,
                    tb.top_plan(log_t, log_s + 1, r),
                    lambda kk: ((base & (chunk - 1)) >> kk) & 1)
    want = tb.slot_merge_ref(planes, ncmp, chunk, 1 << log_s, 1 << log_t)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (log_t, log_s)


@pytest.mark.parametrize("mode", list(MODES))
def test_cyclic_network_matches_chunk_sort_cyclic_ref(mode):
    """The mode's tile in radix chunks of one and of two tiles (the tiles
    of a chunk alternate), then small tiles in chunks of 2^11."""
    ncmp, p = MODES[mode]
    lt = _log(tb.top_tile(p))
    _cyclic_case(ncmp, p, lt, 1 << lt, 2 << lt, 11 * p)
    _cyclic_case(ncmp, p, lt, 2 << lt, 4 << lt, 11 * p + 1)
    for log_t in (tb.max_fusion(p) + 1, 9):
        _cyclic_case(ncmp, p, log_t, 1 << 11, 1 << 13, 11 * p + log_t)


@pytest.mark.parametrize("mode", list(MODES))
def test_slot_network_matches_slot_merge_ref(mode):
    """The mode's tile with every slot that has a kernel, in radix chunks
    of two tiles; then a tile of 2^9 with slots of 2^2 .. 2^8."""
    ncmp, p = MODES[mode]
    lt = _log(tb.top_tile(p))
    for log_s in _slots(lt):
        _slot_case(ncmp, p, lt, log_s, 2 << lt, 4 << lt, 13 * p + log_s)
    for log_s in (2, 5, 8):
        _slot_case(ncmp, p, 9, log_s, 1 << 11, 1 << 12, 17 * p + log_s)


# --- which levels branch -----------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_slot_merge_branches_one_way_a_warp(mode):
    """At the mode's tile, for every slot with a kernel: each level below
    the tile takes its direction from a bit of the group index above the
    lanes (one direction for each warp's 32 lanes), the top level from the
    tile's base; the substages of each rule as counted from the plan."""
    _, p = MODES[mode]
    r = tb.max_fusion(p)
    lt = _log(tb.top_tile(p))
    for log_s in _slots(lt):
        total = {"tile": 0, "warp": 0}
        for ph in tb.top_plan(lt, log_s + 1, r):
            kk = ph[0]
            how = _rule(ph, kk, lt, r)
            total[how] += min(ph[2], kk - 1) - ph[3] + 1
            if how == "warp":
                gb = tb.phase_rows(ph, lt, r)[:, 0]
                bit = ((gb >> kk) & 1).view(-1, LANES)
                assert torch.equal(bit, bit[:, :1].expand_as(bit)), (ph, kk)
        assert total == {"tile": lt,
                         "warp": sum(range(log_s + 1, lt))}, log_s


# --- the rule and the wrappers -----------------------------------------------


def test_rule_picks_the_radix_kernels_where_they_apply():
    rule = tb.compile_time_plan
    assert {k: set(v) for k, v in tb.TOP_MODES.items()
            if k in LANDED} == LANDED
    for mode, (_, p) in MODES.items():
        lt = _log(tb.top_tile(p))
        landed = p in LANDED["chunk_sort_cyclic"]
        assert rule("chunk_sort_cyclic", p, lt, lt) == landed, mode
        assert not rule("chunk_sort_cyclic", p, lt - 1, lt - 1)
        assert not rule("chunk_sort_cyclic", p, lt + 1, lt + 1)
        for log_s in range(6, lt + 2):
            want = (p in LANDED["slot_merge"]
                    and tb.MIN_TOP_SLOT_LOG <= log_s < lt)
            assert rule("slot_merge", p, lt, lt, log_s=log_s) == want, (
                mode, log_s)
            assert not rule("slot_merge", p, lt - 1, lt - 1, log_s=log_s)


def _recorder(monkeypatch):
    """The launches made after this, as (name, C function, arguments),
    with the card's launch replaced by a recorder (no kernel runs)."""
    seen = []

    def launch(counts, name, fn, dev, *args):
        seen.append((name, fn, args))
        counts[name] += 1

    monkeypatch.setattr(tb, "_on_cuda", lambda *a, **k: True)
    monkeypatch.setattr(tb._build, "launch", launch)
    return seen


@pytest.mark.parametrize("mode", ("keys", "rider", "lex2", "lex3", "lex8"))
def test_wrappers_pass_the_rule_to_the_launch(monkeypatch, mode):
    """K4 at the mode's tile and half of it, K5 at the mode's tile with
    slots 2^9 .. twice the tile: the last argument of each launch is the
    rule's answer, and a launch on the compile-time plan is counted in
    TOP_LAUNCHES."""
    ncmp, p = MODES[mode]
    t = tb.top_tile(p)
    chunk = 1 << 17
    src = [torch.zeros(2 * chunk, dtype=torch.int32) for _ in range(p)]
    dst = [torch.zeros(2 * chunk, dtype=torch.int32) for _ in range(p)]
    seen = _recorder(monkeypatch)
    tb.reset_counts()
    cyc, merge = tb.radix_kernels(ncmp, p)
    want = []
    for tile in (t, t // 2):
        tb.chunk_sort_cyclic(src, dst, ncmp, chunk, tile)
        want.append(("radx_chunk_sort_cyclic", tile == t
                     and p in LANDED["chunk_sort_cyclic"]))
    for slot in (1 << s for s in range(9, _log(t) + 2)):
        tb.slot_merge(src, dst, ncmp, chunk, slot, t)
        want.append(("radx_slot_merge", p in LANDED["slot_merge"]
                     and tb.MIN_TOP_SLOT_LOG <= _log(slot) < _log(t)))
    assert [(fn, bool(args[-1])) for _, fn, args in seen] == want
    assert tb.TOP_LAUNCHES[cyc] == sum(top for fn, top in want
                                       if fn == "radx_chunk_sort_cyclic")
    assert tb.TOP_LAUNCHES[merge] == sum(top for fn, top in want
                                         if fn == "radx_slot_merge")
    assert tb.LAUNCHES[cyc] + tb.LAUNCHES[merge] == len(want)


@pytest.mark.parametrize("mode", ("keys", "rider", "lex2", "lex3"))
def test_sort_radix_launches_on_the_rule(monkeypatch, mode):
    """A whole ``sort_radix`` of 2^16 rows (radix chunks of 2^14 rows,
    slots of 4096: a K5 instance at every landed mode's tile) with the
    card's launches recorded and the planning kernels' outputs stubbed
    (no overflow, so the path reaches K5): K4 and K5 launch once each, on
    the compile-time plan exactly in the landed modes, and every chunk sort
    / finish / strided pass as its own rule says."""
    ncmp, p = MODES[mode]
    cfg = SortConfig(strategy="radix")
    n = 1 << 16
    chunk = RS.pick_chunk(n, cfg.chunk_elems)
    geo = RS.plan(n, chunk)
    assert geo is not None and geo.slot == 4096
    planes = [torch.zeros(n, dtype=torch.int32) for _ in range(p)]
    seen = _recorder(monkeypatch)
    i64 = torch.int64
    monkeypatch.setattr(RS, "rank_args", lambda *a: ())
    monkeypatch.setattr(RS, "rank_runs", lambda *a: RS.Ranked(
        torch.zeros(geo.nb - 1, dtype=torch.int32),
        torch.zeros(geo.n_chunks, geo.nb_pad + 1, dtype=torch.int32),
        torch.tensor(0, dtype=i64), torch.zeros(geo.nb_pad + 1, dtype=i64),
        torch.zeros(geo.nb_pad, dtype=i64)))
    monkeypatch.setattr(msd, "pack", lambda src, *a: [
        torch.zeros(geo.nb_pad * geo.C, dtype=torch.int32) for _ in src])
    monkeypatch.setattr(msd, "concat", lambda *a: None)
    tb.reset_counts()
    _, overflow = RS.sort_radix(planes, chunk, ncmp, cfg)
    assert not overflow
    by_fn = {}
    for name, fn, args in seen:
        by_fn.setdefault(fn, []).append((name, args))
    (cyc,) = by_fn["radx_chunk_sort_cyclic"]
    (merge,) = by_fn["radx_slot_merge"]
    assert cyc[1][-1] == int(p in LANDED["chunk_sort_cyclic"])
    assert merge[1][-1] == int(p in LANDED["slot_merge"])
    for name, args in by_fn.get("radx_finish", ()):
        # planes, np, ncmp, n, log_t, invert, log_span, plan, phases, top
        kk = args[7][0] & 63
        assert args[-1] == int(tb.compile_time_plan("finish", p, args[4],
                                                    kk)), name
    tops = {k: v for k, v in tb.TOP_LAUNCHES.items() if v}
    assert (tb.radix_kernels(ncmp, p)[0] in tops) == (
        p in LANDED["chunk_sort_cyclic"])
    assert (tb.radix_kernels(ncmp, p)[1] in tops) == (
        p in LANDED["slot_merge"])
