"""finish's compile-time plan (csrc/bitonic.cu ``finish_kernel`` with
LOG_T > 0, ``top_pass``) and the valley merge's overhang pass, on the
CPU, without JAX.

Every finish pass of a sort's merge levels is a level at or above the
mode's finish tile; the kernel runs those on a plan laid out at compile
time (``kernels/bitonic.py::top_plan``, the kernel's top_code) with one
direction for the whole tile.  Over keys, rider and lex2..lex8 at tiles of
2^11..2^14 rows: that plan must be ``tile_plan``'s for every such level
(the kernel refuses any other), its first phase must read every row of
the tile once and its last phase write every row once, each phase's rows
a permutation of the tile's, and the network run through it phase by phase
with the one direction must equal ``finish_ref`` bit for bit (tolerance 0:
integer keys with ties, so the tie-safe exchange and the riders are held
too).

``_overhang`` is the valley merge's top half-cleaner: on the card one
``cross_stage<1>`` launch limited to the rows present, on the CPU its plain
version ``_cx_directed``.  The launch, modelled as the kernel computes its
grid, pairs and direction, must equal ``_cx_directed`` bit for bit.
"""

import numpy as np
import pytest
import torch

from radx_tpu_torch import SortConfig
from radx_tpu_torch.kernels import bitonic as tb

MODES = {"keys": (1, 1), "rider": (1, 2),
         **{f"lex{p}": (2, p) for p in range(2, 9)}}
LOG_TILES = (11, 12, 13, 14)


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


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("log_t", LOG_TILES)
def test_top_plan_is_the_plan_of_every_level_above_the_tile(mode, log_t):
    _, p = MODES[mode]
    r = tb.max_fusion(p)
    top = tuple(ph[2:] for ph in tb.top_plan(log_t, log_t, r))
    for kk in (log_t, log_t + 1, log_t + 9, 40):
        plan = tb.tile_plan(log_t, kk, kk, r)
        assert plan == tb.top_plan(log_t, kk, r)
        assert tuple(ph[2:] for ph in plan) == top
        assert all(ph[:2] == (kk, kk) for ph in plan)
    # below the tile the plan is another (the run-time kernel takes it)
    below = tb.tile_plan(log_t, log_t - 1, log_t - 1, r)
    assert tuple(ph[2:] for ph in below) != top


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("log_t", LOG_TILES)
def test_every_row_is_read_once_and_written_once(mode, log_t):
    _, p = MODES[mode]
    r = tb.max_fusion(p)
    t = 1 << log_t
    phases = tb.top_plan(log_t, log_t + 1, r)
    for i, ph in enumerate(phases):
        rows = tb.phase_rows(ph, log_t, r).reshape(-1)
        # each phase holds every row of the tile once, in registers
        assert torch.equal(torch.bincount(rows, minlength=t),
                           torch.ones(t, dtype=torch.int64)), (i, ph)
        hi, lo, wlo = ph[2:]
        assert wlo <= lo <= hi < wlo + r  # its bits in its register window
    # the first phase's loads coalesce (lanes on consecutive rows), the last
    # phase's rows are runs of 2^r: int4 stores
    first = tb.phase_rows(phases[0], log_t, r)
    assert torch.equal(first[:32, 0], torch.arange(32))
    last = tb.phase_rows(phases[-1], log_t, r)
    assert phases[-1][4] == 0
    assert torch.equal(last[0], torch.arange(1 << r))
    # the phases cover the tile's bits log_t - 1 .. 0, highest first
    bits = [b for ph in phases for b in range(ph[2], ph[3] - 1, -1)]
    assert bits == list(range(log_t - 1, -1, -1))


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


def _top_network(planes, ncmp, log_t, r, kk, invert, span):
    """The kernel's top_pass in plain torch: every tile through the phases
    of ``top_plan`` in (tiles, groups, 2^r) register views, one direction
    a tile (bit kk of its span-masked base, XOR invert)."""
    t, w = 1 << log_t, 1 << r
    views = [q.reshape(-1, t).clone() for q in planes]
    base = torch.arange(views[0].shape[0], dtype=torch.int64) * t
    if span is not None:
        base &= span - 1
    up = ((((base >> kk) & 1) ^ int(invert)) == 0)[:, None, None, None]
    for _, _, hi, lo, wlo in tb.top_plan(log_t, kk, r):
        rows = tb.phase_rows((kk, kk, hi, lo, wlo), log_t, r)
        v = [x[:, rows] for x in views]
        for sb in range(hi - wlo, lo - wlo - 1, -1):
            pairs = [x.view(*x.shape[:-1], w >> (sb + 1), 2, 1 << sb)
                     for x in v]
            a, b = _exchange(ncmp, [q[..., 0, :] for q in pairs],
                             [q[..., 1, :] for q in pairs], up)
            for q, na, nb in zip(pairs, a, b):
                q[..., 0, :] = na
                q[..., 1, :] = nb
        for x, y in zip(views, v):
            x[:, rows] = y
    return [x.reshape(-1) for x in views]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("log_t", LOG_TILES)
def test_top_network_matches_finish_ref(mode, log_t):
    ncmp, p = MODES[mode]
    r = tb.max_fusion(p)
    rng = np.random.default_rng(100 * log_t + p)
    planes = _planes(rng, ncmp, p, 4 << log_t)
    k, rd, lx = tb._keywords(planes, ncmp)
    t = 1 << log_t
    # the top level of the whole input, a level inside it (tiles of both
    # directions) and a span of two tiles, descending
    for kk, invert, span in ((log_t + 2, False, None),
                             (log_t + 1, False, None),
                             (log_t, True, None),
                             (log_t + 1, True, 2 * t)):
        got = _top_network(planes, ncmp, log_t, r, kk, invert, span)
        want = tb.finish_ref(k, t, kk, invert, rd, lx, span)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            kk, invert, span)


def test_rule_takes_the_compile_time_plan_above_the_mode_tile():
    cfg = SortConfig()
    for mode, (ncmp, p) in MODES.items():
        tile = cfg.mode_tiles(p, ncmp)[1]
        assert tb.top_tile(p) == tile, mode
        lt = tile.bit_length() - 1
        rule = tb.compile_time_plan
        assert rule("finish", p, lt, lt) and rule("finish", p, lt, 40)
        assert not rule("finish", p, lt, lt - 1)  # below the tile
        assert not rule("finish", p, lt - 1, lt + 3)  # another tile
        assert not rule("finish", p, lt + 1, lt + 3)


def _overhang_launch(planes, ncmp, descending, threads=256):
    """The card's overhang launch in plain torch, as csrc/bitonic.cu
    computes it: ``cross_stage<1>`` over the virtual v = 2^(j_low+1) rows,
    rows - v/2 threads rounded up to whole blocks, each thread t the pair
    (i0, i0 + v/2) with i0 = ((t & ~jmask) << 1) | (t & jmask), returning
    where t >= v/2 or the high row is past the rows present, its direction
    bit kk = j_low + 1 of i0 within the span, XOR invert."""
    rows = planes[0].numel()
    half = tb._virtual_rows(rows) // 2
    j_low, kk, dmask = half.bit_length() - 1, half.bit_length(), 2 * half - 1
    groups = rows - half
    t = torch.arange(-(-groups // threads) * threads, dtype=torch.int64)
    t = t[t < half]
    jmask = half - 1
    i0 = ((t & ~jmask) << 1) | (t & jmask)
    i0 = i0[i0 + half < rows]
    up = (((i0 & dmask) >> kk) & 1) == int(descending)
    out = [q.clone() for q in planes]
    a, b = _exchange(ncmp, [q[i0] for q in planes],
                     [q[i0 + half] for q in planes], up)
    for q, na, nb in zip(out, a, b):
        q[i0], q[i0 + half] = na, nb
    return out


@pytest.mark.parametrize("mode", ("keys", "rider", "lex2"))
@pytest.mark.parametrize("descending", (False, True))
@pytest.mark.parametrize("log_half", (3, 6, 10))
@pytest.mark.parametrize("chunks", (1, 2, 3))
def test_overhang_launch_is_the_plain_overhang_exchange(mode, descending,
                                                        log_half, chunks):
    """The card's launch (modelled) against ``_cx_directed``, the plain
    version that ``_overhang`` runs on CPU planes, bit for bit."""
    ncmp, p = MODES[mode]
    half = 1 << log_half
    r = half + min(8 * chunks, half)  # an overhang of 1-3 chunks of 8 rows
    rng = np.random.default_rng(1000 * log_half + 10 * chunks + p)
    planes = _planes(rng, ncmp, p, r)
    want = [q.clone() for q in planes]
    tb._cx_directed([q[: r - half] for q in want], [q[half:] for q in want],
                    ncmp, descending)
    got = _overhang_launch(planes, ncmp, descending)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the wrapper on CPU planes: its plain version, in place
    done = [q.clone() for q in planes]
    tb.reset_counts()
    tb._overhang(done, ncmp, descending)
    assert all(torch.equal(a, b) for a, b in zip(done, want))
    assert tb.PLAIN_CALLS["_cx_directed"] == 1
    assert not any(tb.LAUNCHES.values())


def test_overhang_validation():
    with pytest.raises(ValueError, match="no overhang"):
        tb._overhang([torch.zeros(1, dtype=torch.int32)], 1, False)
    with pytest.raises(ValueError, match="int32"):
        tb._overhang([torch.zeros(24, dtype=torch.int64)], 1, False)


def test_valley_merge_counts_its_plain_overhang_on_the_cpu():
    rng = np.random.default_rng(7)
    x = np.sort(rng.integers(0, 50, 100).astype(np.int32))
    valley = torch.from_numpy(np.concatenate((x[::2][::-1], x[1::2])).copy())
    tb.reset_counts()
    tb.merge_valley_ascending(valley, 8, 16)
    assert torch.equal(valley, torch.from_numpy(x))
    assert tb.PLAIN_CALLS["_cx_directed"] >= 1
    assert not any(tb.LAUNCHES.values())
