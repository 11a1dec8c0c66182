"""The phase plan of the register tile engine (csrc/bitonic.cu ``tile_pass``,
the CUDA ``chunk_sort``, ``finish``, ``chunk_sort_cyclic`` and
``slot_merge``) against the plain network, on the CPU.

``kernels/bitonic.py::tile_plan`` is the plan the wrappers pass to the
kernels and ``phase_rows`` the rows a thread holds in a phase.  These tests
run the network through that plan the way a kernel does: the tile's rows
come in through the kernel's load map (the tile itself, the block-cyclic
tiles of a radix chunk, or the odd slots read backwards); per phase they
gather every tile's rows into a (groups, 2^r) register view, run the
phase's substages there with the kernel's direction rule (bit kk of the
tile's base for kk >= log_t, else of the group's first row XOR of the
register bits), and scatter the rows back.  Each result must be bit-equal
to ``chunk_sort_ref`` / ``finish_ref`` / ``chunk_sort_cyclic_ref`` /
``slot_merge_ref`` (tolerance 0: integer keys with ties, so the tie-safe
exchange and the riders' order are held too), and each phase's view a
permutation of the tile's rows.  No JAX here.
"""

import numpy as np
import pytest
import torch

from radx_tpu_torch.kernels import bitonic as tb

MODES = {"keys": (1, 1), "rider": (1, 2), "lex2": (2, 2), "lex5": (2, 5),
         "lex8": (2, 8)}
# tiles per input: with four, a span of two tiles masks the third and
# fourth; the large tiles take two (the span is then the whole input)
def _tiles(log_t):
    return 4 if log_t <= 10 else 2


def _planes(rng, mode, n):
    """Keys in [0, 4) (ties everywhere); in the lex modes plane 1 in [0, 4)
    too, so (plane 0, plane 1) ties; random riders."""
    ncmp, p = MODES[mode]
    out = [rng.integers(0, 4, n).astype(np.int32)]
    if ncmp == 2:
        out.append(rng.integers(0, 4, n).astype(np.int32))
    while len(out) < p:
        out.append(rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                   .astype(np.int32))
    return [torch.from_numpy(x) for x in out], ncmp


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


def _run_plan(planes, ncmp, log_t, plan, r, dbase, invert, src=None):
    """The planes after one tile pass of ``plan`` over every tile, computed
    phase by phase in (tiles, groups, 2^r) register views.  ``dbase``: each
    tile's base in the direction index, int64 (tiles,).  ``src``: the load
    map, the input row of every output row (default: in place); an empty
    plan is a copy through it."""
    t, w = 1 << log_t, 1 << r
    views = [(p if src is None else p[src]).reshape(-1, t).clone()
             for p in planes]
    for phase in plan:
        kk_a, kk_b, hi, lo, wlo = phase
        rows = tb.phase_rows(phase, log_t, r)
        real = rows < t
        assert real.all() or t < w  # only a tile below 2^r rows is short
        assert torch.equal(rows[real].sort().values, torch.arange(t))
        v = [x[:, rows.clamp(max=t - 1)] for x in views]
        gb = rows[:, 0]
        for kk in range(kk_a, kk_b + 1):
            top, ks = min(hi, kk - 1), min(kk, 31)
            if kk >= log_t:
                bit0 = ((dbase >> kk) & 1)[:, None]
            else:
                bit0 = ((gb >> kk) & 1)[None, :]
            flip = bit0 ^ int(invert)
            for sb in range(r - 1, -1, -1):
                if not lo <= wlo + sb <= top:
                    continue
                # registers u (bit sb clear) and u | 2^sb as the two sides
                # of a (..., w / 2^(sb+1), 2, 2^sb) view
                pairs = [x.view(*x.shape[:-1], w >> (sb + 1), 2, 1 << sb)
                         for x in v]
                u = torch.arange(w).view(-1, 2, 1 << sb)[:, 0]
                up = (flip[..., None, None] ^ (((u << wlo) >> ks) & 1)) == 0
                a, b = _exchange(ncmp, [p[..., 0, :] for p in pairs],
                                 [p[..., 1, :] for p in pairs], up)
                for p, na, nb in zip(pairs, a, b):
                    p[..., 0, :] = na
                    p[..., 1, :] = nb
        for x, y in zip(views, v):
            x[:, rows[real]] = y[:, real]
    return [x.reshape(-1) for x in views]


def _kw(planes, ncmp):
    k, rider, lex = tb._keywords(planes, ncmp)
    return k, {"rider": rider, "lex": lex}


def _equal(got, want):
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(a, b) for a, b in zip(got, want))


def test_plan_shapes():
    # the finish tile of 2^14 rows at R = 4: 4 phases, 3 round trips
    assert tb.tile_plan(14, 20, 20, 4) == (
        (20, 20, 13, 10, 10), (20, 20, 9, 6, 6), (20, 20, 5, 2, 2),
        (20, 20, 1, 0, 0))
    assert tb.round_trips(14, 20, 20, 1) == 3
    # a 2^14 chunk: stages 1..4 in one phase, then ceil(kk / 4) for kk > 4
    chunk = tb.tile_plan(14, 1, 14, 4)
    assert chunk[0] == (1, 4, 3, 0, 0)
    assert len(chunk) - 1 == sum(-(-kk // 4) for kk in range(5, 15)) == 28
    # below the window: one phase, every row of the tile in one thread
    assert tb.tile_plan(3, 1, 3, 4) == ((1, 3, 2, 0, 0),)
    assert tb.tile_plan(2, 9, 9, 4) == ((9, 9, 1, 0, 0),)
    # the largest plans fit the kernel's 64 phases
    assert len(tb.tile_plan(13, 1, 13, 2)) <= 64
    # slot_merge at the radix sort's 2^14 tile: slots of 4096 keys, 8 phases
    # (7 round trips); slots of 1024, 13 round trips
    assert len(tb.tile_plan(14, 13, 14, 4)) == 8
    assert tb.round_trips(14, 11, 14, 1) == 13
    # a slot wider than the tile: no level, an empty plan (a copy)
    assert tb.tile_plan(13, 14, 13, 4) == ()
    assert tb.round_trips(13, 14, 13, 2) == 0


@pytest.fixture(autouse=True)
def _one_thread():
    """These small tensor ops run fastest on one intra-op thread, which also
    keeps them from contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("log_t", range(1, 15))
def test_plan_matches_plain_network(log_t, mode):
    rng = np.random.default_rng(1000 * log_t + len(mode))
    t = 1 << log_t
    planes, ncmp = _planes(rng, mode, _tiles(log_t) * t)
    x, kw = _kw(planes, ncmp)
    tiles = torch.arange(_tiles(log_t), dtype=torch.int64) * t
    # every r of 2..5 (5: no kernel holds 32 rows a thread today) up to
    # 2^10-row tiles; above, the r of the mode's kernel
    rs = (2, 3, 4, 5) if log_t <= 10 else (tb.max_fusion(MODES[mode][1]),)
    for i, r in enumerate(rs):
        # chunk_sort: the (invert, ascending) pairs in turn
        invert, ascending = bool((i + log_t) & 1), bool((i + log_t) & 2)
        got = _run_plan(planes, ncmp, log_t, tb.tile_plan(log_t, 1, log_t, r),
                        r, tiles * 0 if ascending else tiles, invert)
        want = tb.chunk_sort_ref(x, t, invert=invert, ascending=ascending,
                                 **kw)
        assert _equal(got, want), ("chunk_sort", r, invert, ascending)
        # finish: kk below (a tile of several merge groups), at and above
        # log_t, with and without a span of two tiles
        for kk in (log_t - 1, log_t, log_t + 1):
            if kk < 1:
                continue
            span = None if (kk + r) % 2 else 2 * t
            mask = -1 if span is None else span - 1
            got = _run_plan(planes, ncmp, log_t, tb.tile_plan(log_t, kk, kk, r),
                            r, tiles & mask, invert)
            want = tb.finish_ref(x, t, kk, invert, span=span, **kw)
            assert _equal(got, want), ("finish", r, kk, span, invert)


def _cyclic_src(n, chunk):
    """K4's load map, as the kernel computes it: output row lb + i of radix
    chunk c reads row e = lb + i of the chunk's 1024-row tiles
    {g * n_chunks + c}."""
    o = torch.arange(n, dtype=torch.int64)
    c, e = o // chunk, o % chunk
    cyc = tb.CYCLIC_TILE
    return ((e // cyc) * (n // chunk) + c) * cyc + e % cyc


def _slot_src(n, slot):
    """K5's load map: row g of an odd slot reads g ^ (slot - 1)."""
    g = torch.arange(n, dtype=torch.int64)
    return torch.where((g // slot) % 2 == 1, g ^ (slot - 1), g)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("log_t", (1, 2, 3, 5, 8, 10, 11, 13))
def test_cyclic_plan_matches_plain(log_t, mode):
    """chunk_sort_cyclic: chunk_sort's plan over tiles loaded through the
    cyclic map, directions from the index within the radix chunk (chunks of
    several tiles, so the tiles of a chunk alternate until the span
    passes), bit-equal to ``chunk_sort_cyclic_ref``."""
    rng = np.random.default_rng(2000 + 10 * log_t + len(mode))
    t = 1 << log_t
    chunk = max(tb.CYCLIC_TILE, 4 * t if log_t < 13 else 2 * t)
    planes, ncmp = _planes(rng, mode, 2 * chunk)
    r = tb.max_fusion(MODES[mode][1])
    lb = torch.arange(2 * chunk // t, dtype=torch.int64) * t % chunk
    got = _run_plan(planes, ncmp, log_t, tb.tile_plan(log_t, 1, log_t, r), r,
                    lb, False, _cyclic_src(2 * chunk, chunk))
    want = tb.chunk_sort_cyclic_ref(planes, ncmp, chunk, t)
    assert _equal(got, tuple(want))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("log_t", (1, 2, 3, 5, 8, 11, 13))
def test_slot_merge_plan_matches_plain(log_t, mode):
    """slot_merge: levels log2(slot)+1 .. log_t over tiles loaded with the
    odd slots reversed, directions from the index within the chunk, for
    slots a quarter of the tile, half of it (one level), the tile and twice
    the tile (the empty plan: a copy), bit-equal to ``slot_merge_ref``."""
    rng = np.random.default_rng(3000 + 10 * log_t + len(mode))
    t = 1 << log_t
    chunk = 4 * t
    planes, ncmp = _planes(rng, mode, 2 * chunk)
    r = tb.max_fusion(MODES[mode][1])
    base = torch.arange(2 * chunk // t, dtype=torch.int64) * t % chunk
    for slot in (t // 4, t // 2, t, 2 * t):
        if slot < 1:
            continue
        log_s = slot.bit_length() - 1
        plan = tb.tile_plan(log_t, log_s + 1, log_t, r)
        assert (plan == ()) == (slot >= t)
        got = _run_plan(planes, ncmp, log_t, plan, r, base, False,
                        _slot_src(2 * chunk, slot))
        want = tb.slot_merge_ref(planes, ncmp, chunk, slot, t)
        assert _equal(got, tuple(want)), slot
