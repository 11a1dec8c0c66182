"""The radix sort's planning kernels modelled on the CPU: K11 ``radix_rank``
(csrc/radix.cu: from the sorted samples and the digit totals to the
splitters, ranks, run bounds, overflow flag and segment tables, in one
launch) and K10 / K14 ``radix_hist`` (warp-private histograms).

``radix_sort.rank_runs_model`` runs the K11 kernel's arithmetic in pure
torch: the prologue (digit CDF, the two-round count of samples below the
sentinel, the splitters' targets, top bytes and clamp), the two-level
search (the chunk's regular samples as heads, one window between two of
them a splitter, in parts of RANK_PART keys) and the epilogue (each block's bounds row, bucket sizes and tail
count; the last block's scan).  It is held bit for bit (integers:
tolerance 0) against the plain composition that ``rank_runs`` runs on the
CPU (``clamp_splitters`` -> ``msd.splitter_ranks_ref`` -> ``run_bounds``)
and, at the JAX test geometry (chunk_rows = 32: C = 4096 keys, 16384 keys,
nb 6, nb_pad 16), against ``radx_tpu.kernels.radix_sort.choose_splitters``
and ``msd._splitter_ranks`` in interpret mode (the JAX package has no tail
mode: that case is held against the plain composition only).
``radix.histograms_model`` runs the histogram kernel's thread mapping and
counting against ``histograms_ref``.  Torch on one intra-op thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.kernels import msd as jm
from radx_tpu.kernels import radix_sort as jrs
from radx_tpu_torch.config import SortConfig
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.kernels import msd as tm
from radx_tpu_torch.kernels import radix as tr
from radx_tpu_torch.kernels import radix_sort as trs

C_ROWS, N = 32, 16384
C = C_ROWS * 128
PAD = 0x7FFFFFFF
SAMPLE_TILES = SortConfig(chunk_elems=1024, finish_elems=2048).mode_tiles(1, 1)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(case, n, chunk, rng):
    """The pre-sort plane (sign-biased int32) of a case and its n_valid.
    Tile t (1024 keys) lands in radix chunk t % n_chunks (phase 1's
    block-cyclic layout)."""
    n_chunks = n // chunk
    keys = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    n_valid = n
    chunk_of = (np.arange(n) // 1024) % n_chunks
    if case == "split_chunks":  # chunk 0 above every splitter, 1 below
        keys[chunk_of == 0] = rng.integers(2**30, 2**31 - 1,
                                           (chunk_of == 0).sum())
        keys[chunk_of == 1] = rng.integers(-(2**31), -(2**30),
                                           (chunk_of == 1).sum())
    elif case == "pad_heavy":  # most keys are the sentinel
        keys[rng.random(n) < 0.7] = PAD
    elif case == "pad_splitters":  # every key: no sample below it
        keys[:] = PAD
    elif case == "all_equal":
        keys[:] = 12345
    elif case == "straddle":  # runs of ~400 equal keys across the heads
        keys = rng.integers(-20, 20, n).astype(np.int32) * 1000
    elif case == "ragged":
        n_valid = n - 517
    elif case == "tail_ragged":  # sentinel keys among the valid ones
        keys[rng.random(n) < 0.05] = PAD
        n_valid = n - 3000
    keys[n_valid:] = PAD
    return keys, n_valid


def _plan_inputs(case, n, chunk, seed=0):
    """The arguments of ``rank_runs`` for a case (``rank_args``) and the
    pre-sort plane."""
    keys, nv = _keys(case, n, chunk, np.random.default_rng(seed))
    p = trs.plan(n, chunk)
    flat = torch.from_numpy(keys)
    sorted_ = tb.sort_chunks_ascending_cyclic([flat], 1, p.C, 1024, 2048)[0]
    return trs.rank_args(sorted_, flat, p, nv, SAMPLE_TILES,
                         case == "tail_ragged"), flat


def _assert_ranked_equal(got, want):
    for f in (*trs.Ranked._fields, "ranks"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and torch.equal(g, w), f


CASES = ["uniform", "split_chunks", "pad_heavy", "pad_splitters", "all_equal",
         "straddle", "ragged", "tail_ragged"]


@pytest.mark.parametrize("geometry", [(N, C), (1 << 18, 1 << 14),
                                      (1 << 20, 1 << 16)],
                         ids=["jax_geometry", "2e18", "2e20"])
@pytest.mark.parametrize("case", CASES)
def test_rank_model_matches_plain_composition(case, geometry):
    args, _ = _plan_inputs(case, *geometry)
    keys, heads, _, _, p, n_valid, _, tail = args
    stride, first = trs.sample_stride(p)
    assert torch.equal(heads, keys.view(p.n_chunks, p.C)[:, first::stride])
    tm.reset_counts()
    want = trs.rank_runs(*args)
    assert tm.PLAIN_CALLS["radix_rank_ref"] == 1
    got = trs.rank_runs_model(*args)
    _assert_ranked_equal(got, want)
    m = p.nb - 1 + tail
    assert got.splitters.shape == (m,) and got.ranks.shape == (p.n_chunks, m)
    # a run outgrows its slot where a chunk's keys crowd into one bucket
    assert bool(got.overflow) == (case in ("all_equal", "split_chunks",
                                           "pad_heavy", "pad_splitters"))
    s, r = got.splitters, got.ranks
    if case == "split_chunks":  # below every key of chunk 0, above chunk 1
        assert (r[0] == 0).any() and (r[1] == p.C).any()
    if case == "pad_splitters":  # no key below any splitter
        assert (s == PAD).all() and (r == 0).all()
    if case == "straddle":  # a splitter inside a run that crosses a head
        x = keys.view(p.n_chunks, p.C)
        assert any(bool((heads == v).any()) and bool((x == v).sum() > stride)
                   for v in s.tolist())
    if tail:
        assert s[-1] == PAD and got.src.numel() == p.nb_pad + p.n_chunks
        assert int(got.start[-1]) == n_valid


@pytest.mark.parametrize("case", ["uniform", "split_chunks", "pad_splitters",
                                  "all_equal", "straddle", "ragged"])
def test_rank_model_matches_jax(case):
    """Splitters, ranks, bounds and the slot flag against the JAX package
    (radix_sort.py:227-245), from the same sorted chunks."""
    args, flat = _plan_inputs(case, N, C)
    got = trs.rank_runs_model(*args)
    n_valid = args[5]
    jp = jrs.plan(N, C_ROWS)
    x3 = jnp.asarray(args[0].numpy().reshape(jp.n_chunks, C_ROWS, 128))
    j_spl = jrs.choose_splitters(x3, jnp.asarray(flat.numpy()), jp, n_valid,
                                 True)
    np.testing.assert_array_equal(got.splitters.numpy(),
                                  np.asarray(j_spl)[: jp.nb - 1])
    j_ranks = np.asarray(jm._splitter_ranks(x3, j_spl, jp, True))
    np.testing.assert_array_equal(got.ranks.numpy(), j_ranks)
    gtile = (np.arange(C_ROWS // 8)[:, None] * jp.n_chunks
             + np.arange(jp.n_chunks)[None, :])
    valid = np.clip(n_valid - gtile * 1024, 0, 1024).sum(0)
    j_bounds = np.concatenate(
        [np.zeros((jp.n_chunks, 1), np.int32), j_ranks,
         np.broadcast_to(valid[:, None], (jp.n_chunks, jp.nb_pad + 1 - jp.nb))],
        1)
    np.testing.assert_array_equal(got.bounds.numpy(), j_bounds)
    slot = jp.slot_rows * 128
    assert bool(got.overflow) == bool(np.diff(j_bounds, axis=1).max() > slot)
    np.testing.assert_array_equal(got.start.numpy(), np.concatenate(
        [[0], np.cumsum(np.diff(j_bounds, axis=1).sum(0))]))


@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 5000, 1 << 21])
def test_samples_below_pad(n):
    """The kernel's two probe rounds give the lower bound of the sentinel
    in the sorted samples, whatever their number and pad count."""
    rng = np.random.default_rng(n)
    for pads in sorted({0, 1, n // 2, n - 1, n}):
        x = np.sort(rng.integers(-(2**31), PAD, n).astype(np.int32))
        x[n - pads:] = PAD
        t = torch.from_numpy(x)
        assert trs._samples_below_pad(t) == n - pads
        assert trs._samples_below_pad(t, threads=7) == n - pads


@pytest.mark.parametrize("geometry", [(N, C), (1 << 20, 1 << 16),
                                      (1 << 26, 1 << 19)])
def test_chunk_valid_matches_run_bounds(geometry):
    """The epilogue's closed form of the per-chunk valid rows equals the
    block-cyclic sum of ``run_bounds``."""
    p = trs.plan(*geometry)
    n = p.n_chunks * p.C
    g = (torch.arange(p.C // p.tile)[:, None] * p.n_chunks
         + torch.arange(p.n_chunks)[None, :])
    rng = np.random.default_rng(3)
    for nv in {0, 1, p.tile - 1, p.tile, n // 3, n - p.tile - 1, n - 1, n,
               *rng.integers(0, n, 5).tolist()}:
        want = (nv - g * p.tile).clamp(0, p.tile).sum(0)
        got = [trs._chunk_valid(nv, c, p) for c in range(p.n_chunks)]
        assert got == want.tolist(), nv


# --- radix_hist ------------------------------------------------------------------


HIST_CASES = {  # name: (keys, tile, shift, bias, n_valid, offset)
    "k14_ragged_last_tile": (5000, 1024, 8, 0, 5000, 0),
    "k14_n_valid_misaligned": (5003, 1024, 0, 0, 4001, 1),
    "tile_below_2e13": (9000, 4096, 16, 0, 8999, 3),
    "tile_at_2e13": (20000, 1 << 13, 24, 0x80000000, 19000, 2),
    "tile_above_2e13": (40000, 1 << 14, 24, 0x80000000, 39999, 1),
    "segments_of_a_tile": (150000, 1 << 17, 24, 0x80000000, 140001, 0),
    "tiny_tiles": (37, 2, 0, 0, 35, 1),
}


@pytest.mark.parametrize("dist", ["uniform", "all_equal", "two_keys"])
@pytest.mark.parametrize("case", list(HIST_CASES))
def test_hist_model_matches_plain(case, dist):
    """Every thread's keys as the kernel reads them (misaligned heads,
    vectors, ragged tails), counted into the warps' histograms, merged,
    with and without the totals row."""
    n, tile, shift, bias, nv, off = HIST_CASES[case]
    rng = np.random.default_rng(n)
    keys = rng.integers(-(2**31), 2**31, n + off, dtype=np.int64).astype(
        np.int32)
    if dist == "all_equal":
        keys[:] = -0x12345679
    elif dist == "two_keys":
        keys = np.where(rng.random(n + off) < 0.5, 0x11223344,
                        -0x11223345).astype(np.int32)
    x = torch.from_numpy(keys)[off:]
    assert (x.data_ptr() // 4) % 4 == off % 4
    for totals in (False, True):
        want = tr.histograms_ref(x, tile, shift, bias, nv, totals)
        got = tr.histograms_model(x, tile, shift, bias, nv, totals)
        assert torch.equal(got, want), totals
    assert torch.equal(tr.histograms(x, tile, shift, bias, nv),
                       tr.histograms_ref(x, tile, shift, bias, nv))


@pytest.mark.parametrize("word", range(4))
@pytest.mark.parametrize("lo,hi,nthr", [(0, 1024, 32), (1024, 1501, 32),
                                        (3, 4, 32), (0, 1 << 16, 256),
                                        (65536, 65536 + 4099, 256)])
def test_hist_threads_read_every_key_once(lo, hi, nthr, word):
    reads = tr._thread_reads(lo, hi, nthr, word)
    flat = sorted(i for r in reads for i in r)
    assert flat == list(range(lo, hi))
