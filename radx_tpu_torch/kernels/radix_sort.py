"""Radix distribution sort — port of radx_tpu/kernels/radix_sort.py, the
``strategy="radix"`` engine.

The reference's counting -> partition -> scattering pipeline at chunk
granularity, on the port's kernels:

  1. **phase 1** — every radix chunk of C keys, made of the 1024-key tiles
     {g * n_chunks + c}, sorted ascending (``bitonic.
     sort_chunks_ascending_cyclic``: K4 in shared memory, then cross / finish
     passes with a span of C);
  2. **counting / partition** — the top-byte histograms of the pre-sort
     plane (K10) give the exact digit CDF, which clamps regular samples of
     the sorted chunks into the digit interval each bucket target falls in
     (``choose_splitters``); K11 ranks the nb - 1 splitters in every sorted
     chunk;
  3. **scattering** — K12 copies every (chunk, bucket) run into its slot of
     S = C / n_chunks keys, bucket-major, so every bucket is a region of C
     keys made of n_chunks ascending slots;
  4. **merge and concatenation** — K5 (then cross / finish passes with a span
     of C) merges each bucket's slots into one ascending run; K13 puts every
     bucket's valid prefix at its global offset and the fill past n_valid.

The overflow flag (a run longer than its slot: duplicate-heavy keys) is
known after the ranks.  The JAX package computes it on the device and picks
the bitonic result under ``lax.cond``; here it is read on the host once,
after K11, and the pack, merge and concatenation are skipped when it is set:
``sort_radix`` then returns the planes untouched and the caller sorts them
on the bitonic network (ops/sort._engine).  The JAX flag's second part, the
K-window test of its block-spec concatenation, has no counterpart: K13 takes
any number of buckets per output block.

With one compare plane and a rider (group-by's rider sort, which passes
n_valid = total so that the pads keep their neutral riders), rows whose key
is the pad sentinel 0x7FFFFFFF would tie with the slots' fill rows in the
merge, and the valid prefix of the last bucket could take a fill row's rider
in place of a real one.  So in that mode a splitter equal to the sentinel
ends the last bucket, and the sentinel-key rows of every sorted chunk are
copied by K13 straight from the chunk, after the buckets: they never enter a
slot, and the splitter targets do not count them.

Geometry (``plan``) is the JAX package's, field for field, in keys instead
of (rows, 128) tiles: C grows from the mode's chunk tile until C^2 >= 2048 n
(at most 2^19, or 2^20 where even the slot floor needs it), so every padded
bucket region is exactly C keys and a slot holds >= 1024 keys.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radx_tpu_torch.kernels import bitonic, msd, radix

TILE = bitonic.CYCLIC_TILE  # keys per block-cyclic tile (JAX t_rows = 8)
SAMPLE_STRIDE = 128  # keys between splitter samples at the densest rate
# Bucket capacity over the mean load, by slot size in keys (the JAX table by
# slot rows of 128): narrow slots need more room for the per-(chunk,
# bucket) run fluctuation.
HEADROOM = {1024: 1.40, 2048: 1.32}  # >= 4096 keys: _HEADROOM_WIDE
_HEADROOM_WIDE = 1.25
_NS = 2048  # max splitter samples per chunk
MAX_CHUNK = 4096 * 128  # the JAX max_rows, in keys
_SAMPLE_SORT_MIN = 1 << 17  # samples sorted on the bitonic network from here
_SIGN_U32 = 0x80000000


class Plan(NamedTuple):
    C: int  # keys per radix chunk and per padded bucket region
    n_chunks: int
    slot: int  # keys per (bucket, chunk) slot: C / n_chunks
    nb: int  # buckets holding keys
    nb_pad: int  # buckets allocated (JAX rounding)
    s_pad: int  # the JAX splitter table length
    tile: int  # keys per block-cyclic tile


def pick_chunk(n: int, base: int, max_elems: int = MAX_CHUNK) -> int:
    """Smallest power-of-two chunk >= base whose geometry keeps slots of >=
    2048 keys (C^2 >= 2048 n), falling back to the 1024-key slot floor when
    that is unreachable within max_elems (the JAX ``pick_chunk_rows``)."""
    c = base
    while c < max_elems and c * c < 2048 * n:
        c *= 2
    if c * c < 1024 * n:  # not even the slot floor is reachable
        c *= 2
    return c


def plan(n: int, chunk: int) -> Plan | None:
    """Geometry of a radix sort of n keys (a power of two) in chunks of
    ``chunk`` keys, or None where it does not apply (callers use the
    bitonic network)."""
    if chunk <= 0 or n % chunk or n < 4 * chunk:
        return None
    n_chunks = n // chunk
    if chunk % n_chunks:
        return None
    slot = chunk // n_chunks
    if slot < 1024 or slot & (slot - 1):
        return None
    h = HEADROOM.get(slot, _HEADROOM_WIDE)
    nb = int(h * n_chunks) + 1
    nb_pad = max(2 * msd._K, -(-nb // msd._U) * msd._U)
    s_pad = -(-(nb - 1) // 8) * 8
    return Plan(chunk, n_chunks, slot, nb, nb_pad, s_pad, TILE)


def choose_splitters(keys, flat_input, p: Plan, n_valid: int, sample_tiles,
                     skip_sentinel: bool = False):
    """nb - 1 ascending int32 cut values: sample quantiles of the sorted
    chunks ``keys`` (plane 0), clamped into the top-byte interval that the
    exact digit CDF of ``flat_input`` (the pre-sort plane, valid prefix
    n_valid: pads never count) assigns each bucket's target.
    ``sample_tiles``: (chunk, finish) tiles of the keys-only network that
    sorts >= 2^17 samples.  ``skip_sentinel``: the sentinel-key rows skip
    the buckets, so the targets count only the other rows, as the samples
    do (else the targets run ahead of the samples and the clamp pins every
    cut to a digit boundary)."""
    counts = radix.chunk_histograms(flat_input, 24, p.C, n=n_valid,
                                    bias=_SIGN_U32)
    totals = counts.sum(0, dtype=torch.int64)
    cdf = torch.cumsum(totals, 0) - totals  # keys with a smaller digit

    ns = min(_NS, p.C // SAMPLE_STRIDE)
    stride = p.C // ns
    first = stride // SAMPLE_STRIDE // 2 * SAMPLE_STRIDE
    # a copy (the stride is >= 128 keys): the network sorts it in place
    samples = keys.view(p.n_chunks, p.C)[:, first::stride].contiguous().view(-1)
    if samples.numel() >= _SAMPLE_SORT_MIN:
        bitonic.sort_planes(samples, *sample_tiles)
    else:
        samples = torch.sort(samples).values
    nvs = (samples < msd._PAD).sum()
    dev = keys.device
    j = torch.arange(1, p.nb, dtype=torch.int64, device=dev)
    spos = (j * nvs // p.nb).clamp(0, samples.numel() - 1)
    sval = samples[spos].to(torch.int64)

    n_keys = n_valid
    if skip_sentinel:
        n_keys = n_valid - (flat_input[:n_valid] == msd._PAD).sum()
    t = j * n_keys // p.nb  # exact bucket targets (int64)
    d = (cdf[None, 1:] <= t[:, None]).sum(1)  # target's top byte, [0, 255]
    lo = (d ^ 128) << 24  # first biased key of that byte
    lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo)
    return torch.minimum(torch.maximum(sval, lo), lo + 0x00FFFFFF).to(
        torch.int32)


class Bounds(NamedTuple):
    bounds: torch.Tensor  # (n_chunks, nb_pad + 1) int32 run bounds
    overflow: torch.Tensor  # 0-d bool: a run longer than its slot
    start: torch.Tensor  # int64 segment starts of the concatenation
    src: torch.Tensor  # int64 segment sources (merged, then sorted chunks)


def run_bounds(ranks, p: Plan, n_valid: int, tail: bool) -> Bounds:
    """Run bounds, overflow flag and concatenation segments from the ranks
    (n_chunks, nb - 1; with ``tail``, one more column: the rank of the
    sentinel, whose rows skip the buckets)."""
    dev = ranks.device
    r = ranks.to(torch.int64)
    g = (torch.arange(p.C // p.tile, device=dev)[:, None] * p.n_chunks
         + torch.arange(p.n_chunks, device=dev)[None, :])
    valid = (n_valid - g * p.tile).clamp(0, p.tile).sum(0)  # per chunk
    top = r[:, p.nb - 1] if tail else valid
    bounds = torch.cat((torch.zeros(p.n_chunks, 1, dtype=torch.int64,
                                    device=dev),
                        r[:, : p.nb - 1],
                        top[:, None].expand(p.n_chunks, p.nb_pad + 1 - p.nb)),
                       1)
    counts = bounds[:, 1:] - bounds[:, :-1]
    overflow = counts.max() > p.slot
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    start = torch.cat((zero, torch.cumsum(counts.sum(0), 0)))
    src = torch.arange(p.nb_pad, device=dev) * p.C
    if tail:
        start = torch.cat((start, start[-1] + torch.cumsum(valid - top, 0)))
        src = torch.cat((src, torch.arange(p.n_chunks, device=dev) * p.C
                         + top))
    return Bounds(bounds.to(torch.int32).contiguous(), overflow, start, src)


def sort_radix(planes, chunk, num_cmp, cfg, n_valid=None):
    """Radix-distribution-sort int32 planes in place: ascending by plane 0,
    then plane 1 when num_cmp == 2; further planes ride along.  The length
    is a power of two with ``plan(len, chunk)`` not None; rows past
    ``n_valid`` (default all) hold the sentinel fill (``msd._fill``) and come
    out as the fill.  ``cfg`` gives the network tiles of the mode.

    Returns (planes, overflow): with overflow True a run overflowed its
    slot, nothing was written and the caller sorts the planes otherwise."""
    total = planes[0].numel()
    p = plan(total, chunk)
    if p is None:
        raise ValueError(f"no radix plan for {total} keys in chunks of {chunk}")
    n_valid = total if n_valid is None else int(n_valid)
    tiles = cfg.mode_tiles(len(planes), num_cmp)
    tail = num_cmp == 1 and len(planes) == 2

    sorted_ = bitonic.sort_chunks_ascending_cyclic(planes, num_cmp, p.C,
                                                   *tiles)
    splitters = choose_splitters(sorted_[0], planes[0], p, n_valid,
                                 cfg.mode_tiles(1, 1), tail)
    if tail:
        splitters = torch.cat((splitters, splitters.new_full((1,), msd._PAD)))
    b = run_bounds(msd.splitter_ranks(sorted_[0], splitters, p.C), p, n_valid,
                   tail)
    if bool(b.overflow):  # the one host read
        return planes, True

    packed = msd.pack(sorted_, b.bounds, p.C, p.slot, p.nb_pad, num_cmp)
    merged = bitonic.merge_slots_ascending(packed, num_cmp, p.C, p.slot,
                                           *tiles)
    del packed
    msd.concat(merged, sorted_ if tail else None, planes, b.start, b.src,
               p.nb_pad, num_cmp)
    return planes, False
