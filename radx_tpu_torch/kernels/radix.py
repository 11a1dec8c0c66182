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
shared-memory atomics), on a CUDA tensor, and its plain PyTorch version, a
``torch.bincount`` of tile * 256 + digit, on a CPU one.  Results are int32
(tiles, 256).  ``LAUNCHES`` / ``PLAIN_CALLS`` count as in kernels/bitonic.py,
the launches of ``tile_histograms`` under ``radix_hist/tile``.
"""

from __future__ import annotations

import torch

from radx_tpu_torch.kernels import _build

KERNELS = ("radix_hist", "radix_hist/tile")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = {"radix_hist_ref": 0}
TILE = 1024  # tile_histograms' tile: the JAX tile_rows = 8 rows of 128


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _log2(x: int) -> int:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"{x} is not a power of two")
    return x.bit_length() - 1


def histograms_ref(x, tile, shift, bias, n):
    """Plain version of ``radix_hist``: (ceil(len / tile), 256) int32 counts
    of the digits of the first n keys of the int32 / uint32 tensor x."""
    PLAIN_CALLS["radix_hist_ref"] += 1
    tiles = -(-x.numel() // tile)
    v = x[:n].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    d = ((v ^ (bias & 0xFFFFFFFF)) >> shift) & 255
    t = torch.arange(n, device=x.device) // tile
    return torch.bincount(t * 256 + d, minlength=tiles * 256).view(
        tiles, 256).to(torch.int32)


def histograms(x, tile, shift, bias=0, n=None, name="radix_hist"):
    """Per-tile 256-bin digit histograms of the first n (default all) keys
    of the contiguous 1-D 32-bit tensor x; tiles of ``tile`` keys (a power
    of two), the last one ragged.  ``name``: the launch count to add to."""
    if x.element_size() != 4 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("expected a contiguous 1-D 32-bit tensor")
    if not 0 <= shift <= 31:
        raise ValueError(f"shift {shift} outside [0, 31]")
    log_tile = _log2(tile)
    n = x.numel() if n is None else int(n)
    if not 0 <= n <= x.numel():
        raise ValueError(f"n {n} outside [0, {x.numel()}]")
    if x.device.type == "cpu":
        return histograms_ref(x, tile, shift, bias, n)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.zeros(-(-x.numel() // tile), 256, dtype=torch.int32,
                      device=x.device)
    if n == 0:
        return out
    _build.launch(LAUNCHES, name, "radx_radix_hist", x.device, x.data_ptr(),
                  n, log_tile, shift, bias & 0xFFFFFFFF, out.data_ptr())
    return out


def chunk_histograms(x, shift, chunk, n=None, bias=0):
    """counts[c, d] = occurrences of digit d = ((x ^ bias) >> shift) & 0xFF
    in chunk c of ``chunk`` keys of the flat int32 plane x (its length a
    multiple of ``chunk``), over the first n keys (default all).  Returns
    (n_chunks, 256) int32."""
    if x.numel() % chunk:
        raise ValueError(f"{x.numel()} keys are not whole chunks of {chunk}")
    return histograms(x, chunk, shift, bias, n)


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
