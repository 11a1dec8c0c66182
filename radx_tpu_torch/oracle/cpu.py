"""NumPy tiled LSD radix sort — the port of radx_tpu/oracle/cpu.py.

It mirrors RadX's three-phase pass, so that the intermediate states (per-tile
histograms, scanned bases, destinations) can be compared, not just the
sorted keys:

  phase 1  per-tile digit histogram   — counting.comp
  phase 2  hierarchical prefix scan   — partition.comp
  phase 3  stable rank-and-scatter    — scattering.comp

A tile is one RadX workgroup's contiguous block.  The digit width
(``bits_per_pass``) and the tile (``tile_elems``) are plain arguments: the
port's ``SortConfig`` carries neither.  ``TILE_ELEMS`` is the JAX default's
tile, its ``SortConfig().tile_rows`` (16) x 128 lanes.
"""

from __future__ import annotations

import numpy as np

BITS_PER_PASS = 8
TILE_ELEMS = 16 * 128
KEY_BITS = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check(bits_per_pass: int, tile_elems: int) -> None:
    if bits_per_pass not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported bits_per_pass={bits_per_pass}")
    if tile_elems < 1:
        raise ValueError("tile_elems must be >= 1")


def extract_digit(keys: np.ndarray, shift: int, mask: int) -> np.ndarray:
    """The digit of each key at ``shift`` (``extractKey``)."""
    return ((keys >> np.uint32(shift)) & np.uint32(mask)).astype(np.int64)


def tile_histograms(digits: np.ndarray, tile: int, radix: int) -> np.ndarray:
    """Phase 1: per-tile digit histogram ``counts[tile][digit]``."""
    n = digits.shape[0]
    ntiles = _cdiv(n, tile)
    counts = np.zeros((ntiles, radix), dtype=np.int64)
    for t in range(ntiles):
        seg = digits[t * tile: (t + 1) * tile]
        counts[t] = np.bincount(seg, minlength=radix)
    return counts


def scan_bases(counts: np.ndarray) -> np.ndarray:
    """Phase 2: base[t, k] = (keys with a digit below k anywhere) + (keys
    with digit k in tiles before t): the cross-workgroup scan, then the
    cross-radix scan."""
    within_digit = np.cumsum(counts, axis=0) - counts  # exclusive over tiles
    totals = counts.sum(axis=0)
    digit_base = np.cumsum(totals) - totals  # exclusive over digits
    return digit_base[None, :] + within_digit


def rank_and_destinations(digits: np.ndarray, bases: np.ndarray,
                          tile: int) -> np.ndarray:
    """Phase 3a: each key's stable destination, base[tile, digit] + its
    rank among the equal digits before it in its tile."""
    n = digits.shape[0]
    dest = np.empty(n, dtype=np.int64)
    radix = bases.shape[1]
    for t in range(_cdiv(n, tile)):
        seg = digits[t * tile: (t + 1) * tile]
        ranks = np.empty_like(seg)
        for k in range(radix):
            sel = seg == k
            cnt = int(sel.sum())
            if cnt:
                ranks[sel] = np.arange(cnt)
        dest[t * tile: t * tile + seg.shape[0]] = bases[t, seg] + ranks
    return dest


def radix_pass(keys: np.ndarray, shift: int, payload: np.ndarray | None = None,
               *, bits_per_pass: int = BITS_PER_PASS,
               tile_elems: int = TILE_ELEMS):
    """One LSD pass: histogram, scan, rank-and-scatter.  Returns (keys,
    payload or None)."""
    _check(bits_per_pass, tile_elems)
    radix = 1 << bits_per_pass
    digits = extract_digit(keys, shift, radix - 1)
    counts = tile_histograms(digits, tile_elems, radix)
    dest = rank_and_destinations(digits, scan_bases(counts), tile_elems)
    out = np.empty_like(keys)
    out[dest] = keys
    if payload is None:
        return out, None
    pout = np.empty_like(payload)
    pout[dest] = payload
    return out, pout


def sort_u32(keys: np.ndarray, *, bits_per_pass: int = BITS_PER_PASS,
             tile_elems: int = TILE_ELEMS) -> np.ndarray:
    """Stable ascending LSD radix sort of uint32 keys."""
    keys = np.asarray(keys, dtype=np.uint32)
    for p in range(_cdiv(KEY_BITS, bits_per_pass)):
        keys, _ = radix_pass(keys, p * bits_per_pass,
                             bits_per_pass=bits_per_pass,
                             tile_elems=tile_elems)
    return keys


def sort_pairs(keys: np.ndarray, payload: np.ndarray, *,
               bits_per_pass: int = BITS_PER_PASS,
               tile_elems: int = TILE_ELEMS):
    """Stable key + payload sort."""
    keys = np.asarray(keys, dtype=np.uint32)
    payload = np.asarray(payload)
    for p in range(_cdiv(KEY_BITS, bits_per_pass)):
        keys, payload = radix_pass(keys, p * bits_per_pass, payload,
                                   bits_per_pass=bits_per_pass,
                                   tile_elems=tile_elems)
    return keys, payload
