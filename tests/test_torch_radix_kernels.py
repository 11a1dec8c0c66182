"""The radix distribution sort's kernels in the port against the JAX
package's, bit for bit (tolerance 0: integer keys), on the CPU:

  * the plan (radix_sort.plan / pick_chunk) for a set of sizes and bases;
  * K10 ``chunk_histograms`` (ragged n, sign bias) and K14
    ``tile_histograms`` at shifts 0 / 8 / 16 / 24;
  * K4 ``sort_chunks_ascending_cyclic`` (keys, rider, lex2, lex3);
  * K5 ``merge_slots_ascending`` on ascending slots with sentinel tails;
  * the ranks of K11 (``splitter_ranks_ref``, the plain version that the
    fused ``radix_sort.rank_runs`` is held to; tests/test_torch_radix_plan.py
    holds the kernel's CPU model) on sorted chunks.

On the CPU every port wrapper runs its kernel's plain PyTorch version; the
card-side comparison of kernel and plain version is tests/test_torch_gpu.py
and chip_smoke.py.  JAX runs its Pallas kernels in interpret mode at
chunk_rows = 32 (C = 4096 keys) and 16384 keys: 4 chunks, slots of 8 rows
(1024 keys), nb 6, nb_pad 16.  The rider mode's tied keys may keep their
riders in another order (ROADMAP Queue 3), so it compares (key, rider)
multisets per chunk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.kernels import bitonic as jb
from radx_tpu.kernels import msd as jm
from radx_tpu.kernels import radix as jr
from radx_tpu.kernels import radix_sort as jrs
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.kernels import msd as tm
from radx_tpu_torch.kernels import radix as tr
from radx_tpu_torch.kernels import radix_sort as trs

C_ROWS, N = 32, 16384
C = C_ROWS * 128
SLOT = 1024
PAD = 0x7FFFFFFF
# (chunk, finish) tiles of the port's network: the whole radix chunk in one
# tile, and tiles that leave levels to the span passes
TILES = pytest.mark.parametrize("tiles", [(C, C), (512, 1024)],
                                ids=["tile_is_chunk", "span_passes"])
MODES = {"keys": (1, 1), "rider": (1, 2), "lex2": (2, 2), "lex3": (2, 3)}


def _planes(rng, n, mode):
    """int32 planes of a mode: plane 0 keys with duplicates; a rider, or a
    unique tie plane (and a random rider) for the lex modes."""
    ncmp, p = MODES[mode]
    keys = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    keys[: n // 2] = rng.integers(0, 64, n // 2)
    keys = rng.permutation(keys)
    out = [keys]
    if p >= 2:
        out.append(rng.permutation(n).astype(np.int32) if ncmp == 2 else
                   rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                   .astype(np.int32))
    if p == 3:
        out.append(rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                   .astype(np.int32))
    return out


def _jax(planes):
    return [jnp.asarray(p.reshape(-1, 128)) for p in planes]


def _np(planes):
    return [np.asarray(p).reshape(-1) for p in planes]


def _torch(planes):
    return [torch.from_numpy(p.copy()) for p in planes]


def _assert_rows_equal(got, want, mode, block):
    """Bit-equal planes; in the rider mode plane 0 bit-equal and the (key,
    rider) rows of every block of ``block`` rows equal as multisets."""
    if mode != "rider":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    np.testing.assert_array_equal(got[0], want[0])

    def rows(planes):
        r = (planes[0].astype(np.int64) << 32) | (planes[1].astype(np.int64) & 0xFFFFFFFF)
        return np.sort(r.reshape(-1, block), 1)

    np.testing.assert_array_equal(rows(got), rows(want))


# --- the plan -----------------------------------------------------------------


@pytest.mark.parametrize("log_n", [14, 16, 20, 23, 26, 28, 30])
def test_plan_matches_jax(log_n):
    n = 1 << log_n
    for base_rows in (8, 16, 32, 64, 128, 256, 1024):
        rows = jrs.pick_chunk_rows(n, base_rows)
        assert trs.pick_chunk(n, base_rows * 128) == rows * 128
        for r in (base_rows, rows):
            jp, tp = jrs.plan(n, r), trs.plan(n, r * 128)
            if jp is None:
                assert tp is None, (n, r)
                continue
            assert tp == trs.Plan(jp.C, jp.n_chunks, jp.slot_rows * 128,
                                  jp.nb, jp.nb_pad, jp.s_pad, jp.t_rows * 128)


def test_plan_at_the_card_sizes():
    """The geometry chip_smoke drives: C = 2^17 at 2^23, 2^19 at 2^26 and
    2^28, 2^20 at 2^30 from the keys-only tile."""
    got = {log_n: trs.plan(1 << log_n, trs.pick_chunk(1 << log_n, 1 << 14))
           for log_n in (23, 26, 28, 30)}
    assert {k: p.C for k, p in got.items()} == {23: 1 << 17, 26: 1 << 19,
                                               28: 1 << 19, 30: 1 << 20}
    assert (got[26].n_chunks, got[26].slot, got[26].nb, got[26].nb_pad) == (
        128, 4096, 161, 168)
    assert (got[28].n_chunks, got[28].slot, got[28].nb, got[28].nb_pad) == (
        512, 1024, 717, 720)


# --- K10 / K14 -------------------------------------------------------------


@pytest.mark.parametrize("shift,bias", [(24, 0x80000000), (8, 0)])
def test_chunk_histograms_match_jax(shift, bias):
    rng = np.random.default_rng(1)
    x = rng.integers(-(2**31), 2**31, N, dtype=np.int64).astype(np.int32)
    nv = N - 517
    want = np.asarray(jr.chunk_histograms(jnp.asarray(x), shift, C_ROWS, n=nv,
                                          bias=bias, interpret=True))
    got = tr.chunk_histograms(torch.from_numpy(x), shift, C, n=nv, bias=bias)
    assert got.dtype == torch.int32 and got.shape == (N // C, 256)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_tile_histograms_match_jax(shift):
    keys = np.random.default_rng(2).integers(0, 2**32, 5000, dtype=np.uint32)
    want = np.asarray(jr.tile_histograms(keys, shift, tile_rows=8,
                                         interpret=True))
    got = tr.tile_histograms(torch.from_numpy(keys), shift)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.sum(0).numpy(), np.bincount((keys >> shift) & 0xFF, minlength=256))


def test_scan_bases_matches_jax():
    counts = np.random.default_rng(3).integers(0, 100, (7, 256)).astype(np.int32)
    np.testing.assert_array_equal(
        tr.scan_bases(torch.from_numpy(counts)).numpy(),
        np.asarray(jr.scan_bases(jnp.asarray(counts))))


# --- K4 ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_sort_chunks_ascending_cyclic_matches_jax(mode):
    ncmp, _ = MODES[mode]
    planes = _planes(np.random.default_rng(4), N, mode)
    want = _np(jb.sort_chunks_ascending_cyclic(
        _jax(planes), C_ROWS, ncmp, t_rows=8, interpret=True,
        unique=mode != "rider"))
    for tiles in ((C, C), (512, 1024)):
        inputs = _torch(planes)
        got = tb.sort_chunks_ascending_cyclic(inputs, ncmp, C, *tiles)
        for a, b in zip(inputs, planes):  # out of place
            np.testing.assert_array_equal(a.numpy(), b)
        _assert_rows_equal([g.numpy() for g in got], want, mode, C)
    # every chunk ascending, made of the tiles {g * n_chunks + c}
    view = planes[0].reshape(C // 1024, N // C, 1024).transpose(1, 0, 2)
    np.testing.assert_array_equal(want[0], np.sort(view.reshape(N // C, C), 1)
                                  .reshape(-1))


# --- K5 ------------------------------------------------------------------------


def _slots(rng, mode, blocks=4):
    """``blocks`` radix chunks of C keys, each of C / SLOT ascending slots
    with fill tails of random length (a packed bucket region)."""
    ncmp, p = MODES[mode]
    planes = _planes(rng, blocks * C, mode)
    for s in range(blocks * C // SLOT):
        sl = slice(s * SLOT, (s + 1) * SLOT)
        cnt = int(rng.integers(0, SLOT + 1))
        cols = [q[sl] for q in planes]
        order = np.lexsort(cols[:ncmp][::-1])
        for j, q in enumerate(planes):
            q[sl] = np.concatenate([cols[j][order][:cnt],
                                    np.full(SLOT - cnt, tm._fill(j, ncmp),
                                            np.int32)])
    return planes


@pytest.mark.parametrize("mode", list(MODES))
@TILES
def test_merge_slots_ascending_matches_jax(mode, tiles):
    ncmp, _ = MODES[mode]
    planes = _slots(np.random.default_rng(5), mode)
    want = _np(jb.merge_slots_ascending(_jax(planes), SLOT // 128, C_ROWS,
                                        ncmp, interpret=True,
                                        unique=mode != "rider"))
    got = tb.merge_slots_ascending(_torch(planes), ncmp, C, SLOT, *tiles)
    _assert_rows_equal([g.numpy() for g in got], want, mode, C)
    assert (np.diff(want[0].reshape(-1, C).astype(np.int64), axis=1)
            >= 0).all()


def test_slot_merge_wider_slot_than_tile():
    """A slot larger than the tile: the reversal of an odd slot reads
    another tile's keys (out of place); every chunk comes out sorted."""
    x = torch.from_numpy(_planes(np.random.default_rng(6), 4 * C, "keys")[0])
    x = torch.sort(x.view(-1, 2 * SLOT), 1).values.view(-1)
    got = tb.merge_slots_ascending([x], 1, C, 2 * SLOT, 256, 512)
    np.testing.assert_array_equal(
        got[0].numpy(), np.sort(x.numpy().reshape(-1, C), 1).reshape(-1))


# --- K11 -----------------------------------------------------------------------


def test_splitter_ranks_match_jax():
    rng = np.random.default_rng(7)
    keys = np.sort(_planes(rng, N, "keys")[0].reshape(-1, C), 1)
    keys[1, -100:] = PAD  # a sentinel tail
    splitters = np.array([-(2**31), 0, 17, 63, PAD, PAD, PAD, PAD], np.int32)
    p = jrs.plan(N, C_ROWS)
    want = np.asarray(jm._splitter_ranks(jnp.asarray(keys.reshape(-1, C_ROWS, 128)),
                                         jnp.asarray(splitters), p, True))
    got = tm.splitter_ranks_ref(torch.from_numpy(keys.reshape(-1)),
                                torch.from_numpy(splitters[: p.nb - 1]), C)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), [np.searchsorted(k, splitters[: p.nb - 1]) for k in keys])


# --- the port's own contracts -----------------------------------------------


def test_cpu_wrappers_count_plain_calls():
    for m in (tb, tr, tm):
        m.reset_counts()
    rng = np.random.default_rng(8)
    planes = _torch(_planes(rng, N, "lex2"))
    out = tb.sort_chunks_ascending_cyclic(planes, 2, C, 1024, 2048)
    trs.rank_runs(*trs.rank_args(out[0], planes[0], trs.plan(N, C), N,
                                 (1024, 2048), False))
    assert not any(tb.LAUNCHES.values()) and not any(tm.LAUNCHES.values())
    assert not any(tr.LAUNCHES.values())
    assert tb.PLAIN_CALLS["chunk_sort_cyclic_ref"] == 1
    assert tb.PLAIN_CALLS["cross_stage_ref"] > 0
    assert tr.PLAIN_CALLS["radix_hist_ref"] == 1
    assert tm.PLAIN_CALLS["radix_rank_ref"] == 1
    assert "slot_merge/lex3" in tb.KERNELS and "radix_pack/rider" in tm.KERNELS


def test_pack_and_concat_plain_versions():
    """Pack cuts a run at its slot and fills past it; concat reads each
    segment from its buffer and fills past the valid rows."""
    keys = torch.arange(4 * 8, dtype=torch.int32)  # 4 chunks of 8 keys
    rider = keys + 100
    bounds = torch.tensor([[0, 3, 8], [0, 0, 8], [0, 8, 8], [0, 1, 2]],
                          dtype=torch.int32)
    packed = tm.pack([keys, rider], bounds, 8, 2, 2, 1)
    assert packed[0].view(2, 4, 2).tolist() == [
        [[0, 1], [PAD, PAD], [16, 17], [24, PAD]],
        [[3, 4], [8, 9], [PAD, PAD], [25, PAD]]]
    assert packed[1].view(2, 4, 2)[0, 0].tolist() == [100, 101]
    assert packed[1].view(2, 4, 2)[0, 1].tolist() == [0, 0]
    out = [torch.zeros(10, dtype=torch.int32) for _ in range(2)]
    start = torch.tensor([0, 2, 2, 5, 7])
    src = torch.tensor([4, 0, 1, 20])
    tm.concat([keys, rider], [keys + 1000, rider + 1000], out, start, src, 2, 1)
    assert out[0].tolist() == [4, 5, 1001, 1002, 1003, 1020, 1021, PAD, PAD,
                               PAD]
    assert out[1].tolist()[7:] == [0, 0, 0]
    tm.concat([keys, keys], None, out, start[:3], src[:2], 2, 2)
    assert out[1].tolist()[2:] == [PAD] * 8  # the lex tie-plane fill


def test_wrappers_reject_bad_arguments():
    x = torch.zeros(N, dtype=torch.int32)
    with pytest.raises(ValueError, match="alias"):
        tb.chunk_sort_cyclic([x], [x], 1, C, 1024)
    with pytest.raises(ValueError):
        tb.chunk_sort_cyclic([x], [x.clone()], 1, 512, 512)  # < the cyclic tile
    with pytest.raises(ValueError):
        tb.slot_merge([x], [x.clone()], 1, C, C, 1024)  # slot == chunk
    with pytest.raises(ValueError, match="num_cmp"):
        tb.chunk_sort_cyclic([x, x, x], [x.clone()] * 3, 1, C, 1024)
    with pytest.raises(ValueError, match="bounds"):
        tm.pack([x], torch.zeros(4, 6, dtype=torch.int32), C, SLOT, 6, 1)
    with pytest.raises(ValueError, match="sorted planes"):
        tm.concat([x], None, [x.clone()], torch.zeros(3, dtype=torch.int64),
                  torch.zeros(2, dtype=torch.int64), 1, 1)
    with pytest.raises(ValueError, match="span"):
        tb.finish(x, 1024, 12, span=3 * 1024)
    with pytest.raises(ValueError, match="unsupported device"):
        tr.tile_histograms(torch.empty(8, dtype=torch.int32, device="meta"), 0)
