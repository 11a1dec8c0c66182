"""The cross pass as a strided tile pass (csrc/bitonic.cu ``cross_stage``)
and the cross schedule at its cap (radx_tpu_torch/kernels/bitonic.py
``cross_fusion``, ``_cross_schedule``), on the CPU.

A pass of more distances than a thread's registers hold (f >
``max_fusion(P)``) runs as a strided tile pass.  ``_cross_model`` runs one
the way the kernel does: block b takes 2^f segments of L = 2^log_l rows,
segment u at base + u * 2^j_low (the ``Strided`` map), and runs
``tile_plan(log_l + f, kk, kk, r, log_l)`` phase by phase: the first phase
reads the planes through the map, each phase gathers its rows into a
(blocks, groups, 2^r) register view, exchanges them with the kernel's
direction rule (bit kk of the span-masked base) and puts them back into a
swizzled "shared-memory" array, and the last one writes through the map.  It must be bit-equal to ``cross_stage_ref`` (tolerance 0:
integer keys with ties, so the tie-safe exchange and the riders' order are
held too).

Grouping the distances into fewer passes runs the same compare-exchanges in
the same order, so the sorts' outputs must not change: ``sort``,
``sort_pairs``, ``groupby`` and ``join_inner`` are held bit for bit against
the old cap (``max_fusion``, at most 4 distances a pass), and against the
JAX package (Pallas in interpret mode) once per compare mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import join as jj
from radx_tpu.ops import sort as js
from radx_tpu_torch import SortConfig, groupby, sort, sort_pairs
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.ops.join import join_inner
from radx_tpu_torch.ops import sort as ts

MODES = {"keys": (1, 1), "rider": (1, 2), "lex2": (2, 2), "lex3": (2, 3),
         "lex4": (2, 4)}
# tiles small enough that f distances leave segments of 1..128 rows
TILES = (1 << 8, 1 << 10)
N = 1 << 13
# tiles of 16 rows: a sort of 2^12 rows has levels of up to 8 cross
# distances, so the new cap groups them into fewer passes than the old one
TINY = SortConfig(chunk_elems=16, finish_elems=16, rider_chunk_elems=16,
                  rider_finish_elems=16, stable_chunk_elems=16,
                  stable_finish_elems=16, compact_elems=64, scan_elems=256)
JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     rider_chunk_rows=8, compact_chunk_rows=8, interpret=True)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """The kernel's tie-safe exchange of register columns a (low) and b."""
    if len(a) == 1:
        mn, mx = torch.minimum(a[0], b[0]), torch.maximum(a[0], b[0])
        return [torch.where(up, mn, mx)], [torch.where(up, mx, mn)]
    a1, b1 = (a[1], b[1]) if ncmp == 2 else (None, None)
    swap = torch.where(up, tb._after(ncmp, a[0], b[0], a1, b1),
                       tb._after(ncmp, b[0], a[0], b1, a1))
    return ([torch.where(swap, y, x) for x, y in zip(a, b)],
            [torch.where(swap, x, y) for x, y in zip(a, b)])


def _cross_model(planes, ncmp, j_low, f, kk, invert, span, tile):
    """New planes after one cross pass, computed as the kernel does with a
    cross tile of ``tile`` rows a plane."""
    p = len(planes)
    r = tb.max_fusion(p)
    log_l = min(j_low, tile.bit_length() - 1 - f)
    log_t = log_l + f
    t = 1 << log_t
    n = planes[0].numel()
    b = torch.arange(n >> log_t, dtype=torch.int64)
    low = j_low - log_l
    base = ((b >> low) << (j_low + f)) | ((b & ((1 << low) - 1)) << log_l)
    rows = torch.arange(t, dtype=torch.int64)
    addr = base[:, None] + ((rows >> log_l) << j_low) + (rows & ((1 << log_l)
                                                                - 1))
    # every address once: the blocks' tiles partition the planes
    assert torch.equal(addr.reshape(-1).sort().values, torch.arange(n))
    dbase = base & (-1 if span is None else span - 1)
    flip = ((dbase >> kk) & 1) ^ int(invert)
    place = rows ^ ((rows >> r) & 31)  # the kernel's swizzle
    plan = tb.tile_plan(log_t, kk, kk, r, log_l)
    assert plan and plan[0][2] == log_t - 1 and plan[-1][3] == log_l
    smem = None
    for i, phase in enumerate(plan):
        _, _, hi, lo, wlo = phase
        prow = tb.phase_rows(phase, log_t, r)  # (groups, 2^r)
        assert (prow < t).all()
        if i == 0:
            v = [x[addr[:, prow]] for x in planes]  # through the map
        else:
            v = [s[:, place[prow]] for s in smem]
        w = 1 << r
        for sb in range(r - 1, -1, -1):
            if not lo <= wlo + sb <= hi:
                continue
            pairs = [x.view(*x.shape[:-1], w >> (sb + 1), 2, 1 << sb)
                     for x in v]
            up = (flip == 0)[:, None, None, None]
            a, c = _exchange(ncmp, [q[..., 0, :] for q in pairs],
                             [q[..., 1, :] for q in pairs], up)
            for q, na, nc in zip(pairs, a, c):
                q[..., 0, :] = na
                q[..., 1, :] = nc
        if i == len(plan) - 1:
            out = [x.clone() for x in planes]
            for o, x in zip(out, v):
                o[addr[:, prow]] = x  # in place through the same map
            return out
        smem = [torch.empty(len(b), t, dtype=torch.int32) for _ in planes]
        for s, x in zip(smem, v):
            s[:, place[prow]] = x


def _cases():
    """The passes the strided tile pass runs: more distances than the
    register pass's max_fusion(P)."""
    for mode, (_, p) in MODES.items():
        for f in range(tb.max_fusion(p) + 1, tb.cross_fusion(p) + 1):
            yield mode, f


@pytest.mark.parametrize("mode,f", list(_cases()))
def test_strided_tile_pass_matches_plain(mode, f):
    """Every (j_low, kk, invert, span) and two cross tiles: segments of
    one row up to 64, one block or many, the lowest distance at the
    segment (no base bits below it) or above it."""
    rng = np.random.default_rng(100 * f + len(mode))
    planes, ncmp = _planes(rng, mode, N)
    k, rider, lex = tb._keywords(planes, ncmp)
    log_n = N.bit_length() - 1
    checked = 0
    for tile in (t for t in TILES if t >= 1 << f):
        for j_low in sorted({min(3, log_n - f), log_n - f,
                             tile.bit_length() - 1 - f}):
            if j_low < 0 or j_low > log_n - f:
                continue
            for kk in sorted({j_low + f, log_n}):
                for invert in (False, True):
                    for span in (None, 1 << kk):
                        got = _cross_model(planes, ncmp, j_low, f, kk, invert,
                                           span, tile)
                        want = tb.cross_stage_ref(k, j_low, f, kk, invert,
                                                  rider, lex, span)
                        want = want if isinstance(want, tuple) else (want,)
                        assert all(torch.equal(a, w)
                                   for a, w in zip(got, want)), (
                            tile, j_low, kk, invert, span)
                        checked += 1
    assert checked >= 8


def test_cross_tile_geometry():
    """The plan of a strided tile runs the tile's top f bits only; the
    segment is as long as the tile allows and never past the lowest
    distance; the tiles keep 64 KB of shared memory."""
    assert tb.tile_plan(14, 28, 28, 4, 6) == ((28, 28, 13, 10, 10),
                                               (28, 28, 9, 6, 6))
    assert tb.tile_plan(14, 20, 20, 4, 12) == ((20, 20, 13, 12, 10),)
    assert tb.tile_plan(13, 22, 22, 4, 8) == ((22, 22, 12, 9, 9),
                                               (22, 22, 8, 8, 8))
    # lowest bit 0 is the plain plan (finish)
    assert tb.tile_plan(14, 20, 20, 4, 0) == tb.tile_plan(14, 20, 20, 4)
    assert [tb.cross_tile(p) for p in range(1, 9)] == [
        1 << 14, 1 << 13, 1 << 12, 1 << 12, 1 << 11, 1 << 11, 1 << 11,
        1 << 11]
    assert all(4 * p * tb.cross_tile(p) <= tb.CROSS_TILE_BYTES
               for p in range(1, 9))
    assert tb.cross_segment(1, 14, 8) == 6  # 256 segments of 64 keys
    assert tb.cross_segment(2, 13, 8) == 5  # 256 of 32 rows
    assert tb.cross_segment(1, 14, 1) == 13
    assert tb.cross_segment(1, 3, 2) == 3  # segments end at the distance
    assert tb.CROSS_FUSION == tuple(range(1, tb.cross_fusion(1) + 1))


def _passes(log_n, log_t, cap):
    return sum(len(list(tb._cross_schedule(kk, log_t, cap)))
               for kk in range(log_t + 1, log_n + 1))


def test_cross_schedule_at_the_cap():
    """Every distance of a level once, highest first, at most the cap a
    pass; at 2^28 rows 18 passes for keys (2^14 tile) and 21 for rider /
    lex2 (2^13), where the old cap made 32 and 36 (20 and 22 at a cap of
    8)."""
    for cap in (1, 4, 6, 8):
        for kk in range(12, 30):
            sched = list(tb._cross_schedule(kk, 11, cap))
            djs = [j + i for j, f in sched for i in range(f - 1, -1, -1)]
            assert djs == list(range(kk - 1, 10, -1))
            assert all(1 <= f <= cap for _, f in sched)
    assert list(tb._cross_schedule(28, 14, 8)) == [(20, 8), (14, 6)]
    cfg = SortConfig()
    keys = _passes(28, cfg.finish_elems.bit_length() - 1, tb.cross_fusion(1))
    rider = _passes(28, cfg.rider_finish_elems.bit_length() - 1,
                    tb.cross_fusion(2))
    lex2 = _passes(28, cfg.lex_tiles(2)[1].bit_length() - 1,
                   tb.cross_fusion(2))
    assert (keys, rider, lex2) == (18, 21, 21)
    assert (_passes(28, 14, 8), _passes(28, 13, 8)) == (20, 22)
    assert (_passes(28, 14, tb.max_fusion(1)),
            _passes(28, 13, tb.max_fusion(2))) == (32, 36)
    # the pieces of the join (2^27, 2^26) and of q3 (2^26, 2^25), lex2 /
    # rider tiles
    assert [_passes(m, 13, 8) for m in (27, 26, 25)] == [20, 18, 16]
    assert [_passes(m, 13, 4) for m in (27, 26, 25)] == [32, 28, 24]


def _old_cap(monkeypatch):
    """The schedule before the strided tile pass: at most max_fusion(P)
    distances a pass."""
    monkeypatch.setattr(tb, "cross_fusion", tb.max_fusion)


def _run_entry(entry, rng):
    n = 3000
    keys = rng.integers(0, 64, n, dtype=np.uint32)
    keys[:7] = 0xFFFFFFFF
    vals = rng.integers(0, 1 << 20, n, dtype=np.uint32)
    if entry == "sort":
        out = sort(keys, TINY, device="cpu"), sort(keys[:2048], TINY,
                                                    device="cpu")
    elif entry == "sort_pairs":
        out = sort_pairs(keys, vals, TINY, device="cpu")
    elif entry == "groupby":
        out = groupby(keys, vals, "sum", TINY, device="cpu")
    else:
        out = join_inner(keys[:1000], vals[:1000], keys[1000:2500],
                         vals[1000:2500], 4, TINY, device="cpu")
    return [o.numpy() if isinstance(o, torch.Tensor) else o for o in out]


@pytest.mark.parametrize("entry", ["sort", "sort_pairs", "groupby",
                                   "join_inner"])
def test_schedule_change_keeps_outputs(entry, monkeypatch):
    """The same sorts with the new cap and the old one: bit-identical
    outputs (groupby's riders included), fewer cross passes."""
    tb.reset_counts()
    new = _run_entry(entry, np.random.default_rng(7))
    new_calls = tb.PLAIN_CALLS["cross_stage_ref"]
    _old_cap(monkeypatch)
    tb.reset_counts()
    old = _run_entry(entry, np.random.default_rng(7))
    old_calls = tb.PLAIN_CALLS["cross_stage_ref"]
    for a, b in zip(new, old):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert 0 < new_calls < old_calls


def test_keys_match_jax():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    keys[:9] = 0xFFFFFFFF
    want = np.asarray(js.sort(jnp.asarray(keys), JCFG))
    np.testing.assert_array_equal(sort(keys, TINY, device="cpu").numpy(),
                                  want)


def test_rider_matches_jax():
    """Keys in [0, 16): the key plane bit for bit, the riders as a
    multiset per key (which tied rider comes first is not part of the
    contract)."""
    rng = np.random.default_rng(12)
    n = 4096
    keys = rng.integers(0, 16, n, dtype=np.uint32)
    payload = rng.permutation(n).astype(np.int32)
    jk, jr = js._sort_rider_jit(jnp.asarray(keys), jnp.asarray(payload), JCFG,
                                n, -1)
    k, r = ts._sort_rider(torch.from_numpy(keys), torch.from_numpy(payload),
                          TINY, n, -1)
    jk, jr = np.asarray(jk), np.asarray(jr)
    np.testing.assert_array_equal(k.numpy(), jk)
    a, b = np.lexsort((r.numpy(), k.numpy())), np.lexsort((jr, jk))
    np.testing.assert_array_equal(r.numpy()[a], jr[b])


def test_lex2_matches_jax():
    """sort_pairs (the (key, index) lex2 network, then the gather) and the
    inner join (the union's (key, tie) lex2 network), bit for bit."""
    rng = np.random.default_rng(13)
    n = 3000
    keys = rng.integers(0, 64, n, dtype=np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    jk, jv = js.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), JCFG)
    k, v = sort_pairs(keys, vals, TINY, device="cpu")
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    want = jj.join_inner(keys[:1000], vals[:1000], keys[1000:2500],
                         vals[1000:2500], 4, JCFG)
    got = join_inner(keys[:1000], vals[:1000], keys[1000:2500],
                     vals[1000:2500], 4, TINY, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
