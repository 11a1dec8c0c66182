"""Radix digit histograms on Hopper — port of radx_tpu/kernels/radix.py.

  * ``chunk_histograms(x, shift, chunk, n=None, bias=0)`` — counts[c, d] of
    digit d = ((x ^ bias) >> shift) & 255 among the first ``n`` keys, per
    chunk of ``chunk`` keys (the radix sort's counting step: the top byte of
    the pre-sort plane, bias 0x80000000 for the original uint32 order);
  * ``tile_histograms(keys, shift, tile=1024)`` — the same per tile of
    ``tile`` uint32 keys at a run-time shift, bias 0 (the JAX
    ``tile_histograms`` and its 8-row tiles);
  * ``scan_bases(counts)`` — the exclusive per-(tile, digit) base offsets, a
    plain cumulative sum with no kernel, as in the JAX package.

Both histograms run one kernel, ``radix_hist`` (CUDA C++ in
``radx_tpu_torch/csrc/radix.cu``; the TPU's nibble one-hot matmuls become
warp-private shared-memory histograms, one atomic a key), on a CUDA tensor,
and its plain
PyTorch version, a ``torch.bincount`` of tile * 256 + digit, on a CPU one.
Results are int32 (tiles, 256); with ``totals`` one more row, the 256 digit
totals (the radix sort's counting step hands them to ``radix_rank``).
Tiles of up to 2^13 keys need no zeroing of the output (one warp writes a
whole row); larger ones are zeroed first (several blocks add into a row).
``histograms_model`` is a pure-torch model of the kernel's pass (which
thread reads which key, the warps' histograms, the merge) for the CPU
tests.  ``LAUNCHES`` / ``PLAIN_CALLS`` count as in kernels/bitonic.py, the
launches of ``tile_histograms`` under ``radix_hist/tile``.
"""

from __future__ import annotations

import torch

from radx_tpu_torch.kernels import _build

KERNELS = ("radix_hist", "radix_hist/tile")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = {"radix_hist_ref": 0, "radix_hist_model": 0}
TILE = 1024  # tile_histograms' tile: the JAX tile_rows = 8 rows of 128
# the kernel's geometry (csrc/radix.cu): one warp a tile up to 2^13 keys,
# else blocks of THREADS threads over segments of 2^SEG_LOG keys of a tile;
# UNROLL 16-byte loads a thread in flight
TILE_LOG_MAX, SEG_LOG, THREADS, UNROLL = 13, 16, 256, 8


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _log2(x: int) -> int:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"{x} is not a power of two")
    return x.bit_length() - 1


def histograms_ref(x, tile, shift, bias, n, totals=False):
    """Plain version of ``radix_hist``: (ceil(len / tile), 256) int32 counts
    of the digits of the first n keys of the int32 / uint32 tensor x (with
    ``totals``, one more row: their sum)."""
    PLAIN_CALLS["radix_hist_ref"] += 1
    tiles = -(-x.numel() // tile)
    v = x[:n].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    d = ((v ^ (bias & 0xFFFFFFFF)) >> shift) & 255
    t = torch.arange(n, device=x.device) // tile
    h = torch.bincount(t * 256 + d, minlength=tiles * 256).view(tiles, 256)
    if totals:
        h = torch.cat((h, h.sum(0, keepdim=True)))
    return h.to(torch.int32)


def _check(x, tile, shift, n):
    if x.element_size() != 4 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("expected a contiguous 1-D 32-bit tensor")
    if not 0 <= shift <= 31:
        raise ValueError(f"shift {shift} outside [0, 31]")
    log_tile = _log2(tile)
    n = x.numel() if n is None else int(n)
    if not 0 <= n <= x.numel():
        raise ValueError(f"n {n} outside [0, {x.numel()}]")
    return log_tile, n, -(-x.numel() // tile)


def histograms(x, tile, shift, bias=0, n=None, name="radix_hist",
               totals=False):
    """Per-tile 256-bin digit histograms of the first n (default all) keys
    of the contiguous 1-D 32-bit tensor x; tiles of ``tile`` keys (a power
    of two), the last one ragged; with ``totals`` one more row, the totals.
    ``name``: the launch count to add to."""
    log_tile, n, rows = _check(x, tile, shift, n)
    if x.device.type == "cpu":
        return histograms_ref(x, tile, shift, bias, n, totals)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    zero = totals or log_tile > TILE_LOG_MAX or n == 0
    out = (torch.zeros if zero else torch.empty)(
        rows + totals, 256, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    _build.launch(LAUNCHES, name, "radx_radix_hist", x.device, x.data_ptr(),
                  n, rows, log_tile, shift, bias & 0xFFFFFFFF, out.data_ptr(),
                  out[rows].data_ptr() if totals else None)
    return out


def _thread_reads(lo, hi, nthr, word):
    """Key indices of [lo, hi) that each of ``nthr`` threads reads, in its
    order: one key of the head before the first 16-byte boundary (``word``:
    the 32-bit words of x's address past a boundary), one of the tail after
    the last whole vector, then its vectors of four, UNROLL a round."""
    head = (4 - (word + lo) % 4) % 4
    v0 = min(lo + head, hi)
    nv = (hi - v0) // 4
    t0 = v0 + 4 * nv
    reads = [[] for _ in range(nthr)]
    for tid in range(nthr):
        if tid < v0 - lo:
            reads[tid].append(lo + tid)
        if tid < hi - t0:
            reads[tid].append(t0 + tid)
        for i in range(tid, nv, nthr * UNROLL):
            for u in range(UNROLL):
                k = i + u * nthr
                if k < nv:
                    reads[tid].extend(range(v0 + 4 * k, v0 + 4 * k + 4))
    return reads


def histograms_model(x, tile, shift, bias=0, n=None, totals=False):
    """Pure-torch model of the ``radix_hist`` kernel's pass, for the CPU
    tests: a warp per tile up to 2^TILE_LOG_MAX keys, else a block of
    THREADS per segment of 2^SEG_LOG keys; each thread's keys as the kernel
    reads them (``_thread_reads``) counted into its warp's histogram; the
    histograms merged into the tile's row and the totals."""
    PLAIN_CALLS["radix_hist_model"] += 1
    log_tile, n, rows = _check(x, tile, shift, n)
    v = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    digits = ((v ^ (bias & 0xFFFFFFFF)) >> shift) & 255
    word = x.data_ptr() // 4 % 4
    out = torch.zeros(rows + totals, 256, dtype=torch.int64)
    if log_tile <= TILE_LOG_MAX:
        groups = [(t, t * tile, min(n, (t + 1) * tile), 32)
                  for t in range(rows)]
    else:
        seg = 1 << min(log_tile, SEG_LOG)
        groups = [(lo >> log_tile, lo, min(n, lo + seg), THREADS)
                  for lo in range(0, n, seg)]
    for row, lo, hi, nthr in groups:
        if lo >= hi:
            continue
        warps = torch.zeros(nthr // 32, 256, dtype=torch.int64)
        for tid, idx in enumerate(_thread_reads(lo, hi, nthr, word)):
            warps[tid // 32] += torch.bincount(digits[idx], minlength=256)
        merged = warps.sum(0)
        out[row] += merged
        if totals:
            out[rows] += merged
    return out.to(torch.int32)


def chunk_histograms(x, shift, chunk, n=None, bias=0, totals=False):
    """counts[c, d] = occurrences of digit d = ((x ^ bias) >> shift) & 0xFF
    in chunk c of ``chunk`` keys of the flat int32 plane x (its length a
    multiple of ``chunk``), over the first n keys (default all).  Returns
    (n_chunks, 256) int32, with ``totals`` (n_chunks + 1, 256): the last
    row the digit totals."""
    if x.numel() % chunk:
        raise ValueError(f"{x.numel()} keys are not whole chunks of {chunk}")
    return histograms(x, chunk, shift, bias, n, totals=totals)


def tile_histograms(keys, shift, tile=TILE):
    """counts[t, d] = occurrences of digit d = (key >> shift) & 0xFF in tile
    t of ``tile`` uint32 keys (the last tile ragged).  Returns (ntiles, 256)
    int32."""
    return histograms(keys, tile, shift, name="radix_hist/tile")


def scan_bases(counts):
    """base[t, d] = (# keys with digit < d anywhere) + (# keys with digit
    == d in tiles < t) — the partition step, a plain cumulative sum."""
    counts = counts.to(torch.int32)
    within = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    totals = counts.sum(0, dtype=torch.int32)
    digit_base = torch.cumsum(totals, 0, dtype=torch.int32) - totals
    return digit_base[None, :] + within
