"""Bitonic merge sort on Hopper — port of radx_tpu/kernels/bitonic.py.

P flat int32 planes of one power-of-two length, sorted in place (the
counterpart of the JAX pipeline's ``input_output_aliases``) by one of three
compare modes, named by the launch-name suffix:

  * keys only (``num_cmp=1``, one plane);
  * ``/rider`` (``num_cmp=1``, two planes: the JAX ``unique=False`` mode): a
    second plane moves with its key;
  * ``/lex<P>`` (``num_cmp=2``, P = 2..8 planes): planes 0 and 1 compare as
    signed int32, lexicographically; planes 2..P-1 ride along.  With a unique
    (plane 0, plane 1) pair, as the stable sorts give with an index plane,
    the order is total and the result is exactly the JAX one.

One comparison per pair decides the swap of every plane, and a pair swaps
only when strictly out of order, so tied rows keep their own riders; which
of two tied rows comes first is not part of the contract, only that none is
lost or duplicated.  The network is the JAX package's: at merge level kk an
element ascends iff bit kk of its flat index is clear (``invert`` flips every
direction), and its partner at distance d is ``index ^ d``.  The TPU's
(rows, 128) lane tiling, FINISH_WIDTH / QUAD_FUSION and its VMEM width
clamps are gone; the tiles are sized by a block's shared memory (config.py).

Five kernels (CUDA C++ in ``radx_tpu_torch/csrc/bitonic.cu``):

  * ``chunk_sort``  — stages 1..log2(C) inside every chunk of C rows
    (``_chunk_sort_kernel``), on the register tile engine: each thread holds
    2^max_fusion(P) rows of every plane and runs up to that many distances
    per shared-memory round trip, by the phases of ``tile_plan``;
  * ``cross_stage`` — F = 1..cross_fusion(P) consecutive distances >= the
    finish tile in one device-memory pass (``_cross_stage{,2,3,4}_kernel``):
    up to max_fusion(P) with the 2^F rows of a pair group in one thread's
    registers, more on the tile engine below over a strided tile (2^F
    segments of contiguous rows 2^j_low apart);
  * ``finish``      — every distance of a level below the finish tile T,
    inside each tile of T rows (``_finishw_kernel``), on the same engine;
  * ``chunk_sort_cyclic`` — the radix sort's phase 1: stages 1..log2(tile)
    of an ascending sort of every radix chunk, whose 1024-row tiles are
    taken block-cyclically (``_chunk_sort_cyclic_kernel``), on the same
    engine with chunk_sort's plan, the tile loaded from its cyclic places;
  * ``slot_merge`` — the radix sort's phase C: odd slots reversed, then the
    merge levels above the slot up to the tile (``_slot_merge_kernel``), on
    the same engine, the odd slots read backwards by the first load (an
    empty plan, a copy through that load, when the slot is at least the
    tile).

Every tile-engine kernel runs on a plan laid out at compile time
(``top_plan``) where ``compile_time_plan`` says so: ``chunk_sort`` of the
mode's chunk tile, a ``finish`` level at or above the mode's finish tile, a
keys-only strided cross pass over the cross tile, and in the modes the
radix sort runs (keys, rider, lex2) ``chunk_sort_cyclic`` of the mode's
tile and ``slot_merge`` of its tile for slots of 2^10 up to half of it.

A sort's first and last launches have forms of their own
(``csrc/bitonic_io.cu``, keys, rider and lex2: ``SOURCE_MODES``):

  * ``chunk_sort/src`` — ``chunk_sort`` whose first load reads the caller's
    columns (``Source``: ``key_source``, ``column_source``,
    ``index_source``), biases, pads and numbers them, and writes the planes
    out of place (``chunk_sort_sources``);
  * ``finish/unbias`` — ``finish`` whose last store writes plane 0 XORed
    with 0x80000000, in place or into the caller's output of its real rows
    (``key_out``);
  * ``chunk_sort_cyclic/src`` — the radix sort's ``chunk_sort_cyclic``
    whose first load reads the sources through the block-cyclic map
    (``chunk_sort_cyclic_sources``); the radix sort's last launch is
    ``radix_concat``'s unbiasing form (kernels/msd.py).

``sort_planes(..., sources=, key_out=)`` (``sort_sources`` for a plane
list) runs them at a sort's edges, ``sort_chunks_ascending_cyclic(...,
sources=)`` at the radix sort's first: the planes may come from
``torch.empty``, and no PyTorch pass makes or unbiases them.

``_overhang`` is the valley merge's top half-cleaner
(``merge_valley_ascending``): one ``cross_stage<1>`` launch over the rows
present of a virtual power-of-two array.

A radix chunk is larger than a block's shared memory, so its levels above
the tile run as cross / finish passes with a direction ``span``: the
direction bit comes from the index within blocks of ``span`` rows, so every
block ends ascending (``span=None``, the whole array, is the plain network).

``chunk_sort``, ``cross_stage`` and ``finish`` work in place on a contiguous
1-D int32 tensor ``x`` (plane 0) and, with ``rider=`` one more plane or with
``lex=`` the list of planes 1..P-1, all of its shape and device;
``chunk_sort_cyclic`` and ``slot_merge`` read one list of planes and write
another (out of place).  On a CUDA tensor a wrapper launches its kernel on
the current stream, without synchronising, and raises if the launch fails;
on a CPU tensor it runs the kernel's plain PyTorch version, which computes
the same network one compare-exchange substage at a time.  ``LAUNCHES``
counts kernel launches by name (``TOP_LAUNCHES`` those of them on a
compile-time plan) and ``PLAIN_CALLS`` counts calls of the
plain versions (``_cx_directed``, the overhang's on the CPU, and
``source_planes_ref``, the source load's, among them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from radx_tpu_torch.config import MAX_SMEM_BYTES, SortConfig
from radx_tpu_torch.kernels import _build

MAX_PLANES = 8
CYCLIC_TILE = 1024  # rows per block-cyclic tile (the JAX t_rows = 8 rows)
# Shared memory of one cross pass's tile, all planes: 64 KB, the keys-only
# finish tile's footprint (three blocks an SM).
CROSS_TILE_BYTES = 64 * 1024


def max_fusion(planes: int) -> int:
    """log2 of the rows a thread of the register tile engine holds at P
    planes (the r of ``tile_plan``): 2^r * P <= 48 values per thread in
    registers, without spills (ptxas report in PERF.md; csrc/bitonic.cu
    max_fusion)."""
    return 4 if planes <= 3 else 3 if planes <= 6 else 2


def cross_fusion(planes: int) -> int:
    """Most distances one cross pass runs at P planes: the fastest sorts of
    a sweep of caps 4..10 on one H100 (``tools/cross_sweep.py``, PERF.md):
    10 keys only, 9 at two planes; elsewhere (no cell sorts three or more
    planes) two phases of the tile engine, one shared-memory round trip
    (8 at three planes, 6 at four to six, 4 at seven and eight)."""
    return {1: 10, 2: 9}.get(planes, 2 * max_fusion(planes))


def cross_tile(planes: int) -> int:
    """Rows a plane of one cross pass's tile: the largest power of two
    whose P planes fit ``CROSS_TILE_BYTES`` (2^14 keys, 2^13 at two planes,
    2^12 at three and four, 2^11 at five to eight)."""
    return 1 << (CROSS_TILE_BYTES // (4 * planes)).bit_length() - 1


CROSS_FUSION = tuple(range(1, cross_fusion(1) + 1))  # F of a keys-only pass


def _suffix(ncmp: int, planes: int) -> str:
    if ncmp == 2:
        return f"/lex{planes}"
    return "/rider" if planes == 2 else ""


def mode_kernels(ncmp: int, planes: int,
                 distances: int | None = None) -> tuple[str, ...]:
    """Launch names of the three kernels in one mode.  ``distances``: the
    most cross distances a merge level of a path has (m - t for a sort of
    2^m rows on a finish tile of 2^t), so that only the cross passes the
    path can launch are named; by default every F up to the cap."""
    sfx = _suffix(ncmp, planes)
    top = cross_fusion(planes)
    if distances is not None:
        top = min(top, distances)
    return (f"chunk_sort{sfx}",
            *(f"cross_stage<{f}>{sfx}" for f in range(1, top + 1)),
            f"finish{sfx}")


def radix_kernels(ncmp: int, planes: int) -> tuple[str, ...]:
    """Launch names of the two radix-phase kernels in one mode."""
    sfx = _suffix(ncmp, planes)
    return f"chunk_sort_cyclic{sfx}", f"slot_merge{sfx}"


# The modes whose sorts make their planes in the network's own first and
# last launches (csrc/bitonic_io.cu): keys, (key, rider) and lex2.
SOURCE_MODES = ((1, 1), (1, 2), (2, 2))


def source_kernels(ncmp: int, planes: int) -> tuple[str, ...]:
    """Launch names of a mode's first and last launches of a sort made
    from sources (``SOURCE_MODES``): ``chunk_sort`` reading the sources,
    ``finish`` storing the keys unbiased."""
    sfx = _suffix(ncmp, planes)
    return f"chunk_sort/src{sfx}", f"finish/unbias{sfx}"


def radix_source_kernel(ncmp: int, planes: int) -> str:
    """Launch name of the radix sort's first launch made from sources
    (``SOURCE_MODES``): ``chunk_sort_cyclic`` reading the sources."""
    return f"chunk_sort_cyclic/src{_suffix(ncmp, planes)}"


def sort_kernels(ncmp: int, planes: int, distances: int | None = None,
                 unbias: bool = True) -> tuple[str, ...]:
    """Launch names of a sort made from sources, as ``mode_kernels``:
    the source chunk sort in place of the chunk sort, the cross passes,
    ``finish`` and (``unbias``) its unbiasing form."""
    first, last = source_kernels(ncmp, planes)
    return (first, *mode_kernels(ncmp, planes, distances)[1:],
            *((last,) if unbias else ()))


KEY_KERNELS = mode_kernels(1, 1)
RIDER_KERNELS = mode_kernels(1, 2)
LEX_PLANES = tuple(range(2, MAX_PLANES + 1))
LEX_KERNELS = tuple(k for p in LEX_PLANES for k in mode_kernels(2, p))
MODES = ((1, 1), (1, 2), *((2, p) for p in LEX_PLANES))
RADIX_KERNELS = tuple(k for m in MODES for k in radix_kernels(*m))
SOURCE_KERNELS = tuple(k for m in SOURCE_MODES
                       for k in (*source_kernels(*m), radix_source_kernel(*m)))
KERNELS = (KEY_KERNELS + RIDER_KERNELS + LEX_KERNELS + RADIX_KERNELS
           + SOURCE_KERNELS)
LAUNCHES = dict.fromkeys(KERNELS, 0)
# the launches of LAUNCHES that ran a compile-time plan (compile_time_plan)
TOP_LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(("chunk_sort_ref", "cross_stage_ref", "finish_ref",
                             "chunk_sort_cyclic_ref", "slot_merge_ref",
                             "_cx_directed", "source_planes_ref"), 0)


def reset_counts() -> None:
    for counts in (LAUNCHES, TOP_LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _log2(x: int) -> int:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"{x} is not a power of two")
    return x.bit_length() - 1


def _planes(x, rider, lex):
    """(plane list, num_cmp) of a call: keys, keys + rider, or lex planes."""
    if rider is not None and lex is not None:
        raise ValueError("pass a rider or lex planes, not both")
    if lex is not None:
        lex = list(lex)
        if not 1 <= len(lex) <= MAX_PLANES - 1:
            raise ValueError(f"lex takes 1..{MAX_PLANES - 1} planes")
        return [x, *lex], 2
    return ([x] if rider is None else [x, rider]), 1


def _result(planes, rider, lex):
    if lex is not None:
        return tuple(planes)
    return planes[0] if rider is None else tuple(planes)


# --- plain PyTorch versions --------------------------------------------------


def _pairs(x, d):
    v = x.reshape(-1, 2, d)
    return v[:, 0], v[:, 1]


def _after(ncmp, a0, b0, a1=None, b1=None):
    """Row a strictly after row b in the ``ncmp``-plane order."""
    if ncmp == 1:
        return a0 > b0
    return (a0 > b0) | ((a0 == b0) & (a1 > b1))


def _cx_ref(planes, ncmp, dj, kk, invert, local_mask=None):
    """One substage at distance d = 2^dj: view every plane as (..., 2, d);
    where bit kk of the pair's index (``& local_mask`` when given) equals
    ``invert`` the low side takes the smaller row, elsewhere the larger.
    With more than one plane, every plane swaps where the pair is strictly
    out of order.  Returns the new planes."""
    d = 1 << dj
    lo, hi = _pairs(planes[0], d)
    g = torch.arange(lo.shape[0], device=lo.device, dtype=torch.int64) << (dj + 1)
    if local_mask is not None:
        g &= local_mask
    up = (((g >> kk) & 1) == int(invert))[:, None]
    if len(planes) == 1:
        mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
        return [torch.stack(
            (torch.where(up, mn, mx), torch.where(up, mx, mn)), 1
        ).reshape(-1)]
    lo1 = hi1 = None
    if ncmp == 2:
        lo1, hi1 = _pairs(planes[1], d)
    swap = torch.where(up, _after(ncmp, lo, hi, lo1, hi1),
                       _after(ncmp, hi, lo, hi1, lo1))
    out = []
    for plane in planes:
        a, b = _pairs(plane, d)
        out.append(torch.stack(
            (torch.where(swap, b, a), torch.where(swap, a, b)), 1
        ).reshape(-1))
    return out


def _substages_ref(planes, ncmp, djs, kk, invert, local_mask=None):
    for dj in djs:
        planes = _cx_ref(planes, ncmp, dj, kk, invert, local_mask)
    return planes


def _mask(span):
    return None if span is None else span - 1


def chunk_sort_ref(x, chunk, kk_range=None, invert=False, ascending=False,
                   rider=None, lex=None):
    """Plain version of ``chunk_sort`` (stages ``kk_range``, by default all
    of 1..log2(chunk)): returns the result (a tuple of planes with a rider or
    lex planes), the inputs untouched."""
    PLAIN_CALLS["chunk_sort_ref"] += 1
    planes, ncmp = _planes(x, rider, lex)
    log_c = _log2(chunk)
    mask = chunk - 1 if ascending else None
    if kk_range is None:
        kk_range = range(1, log_c + 1)
    for kk in kk_range:
        planes = _substages_ref(planes, ncmp, range(kk - 1, -1, -1), kk,
                                invert, mask)
    return _result(planes, rider, lex)


def cross_stage_ref(x, j_low, f, kk, invert=False, rider=None, lex=None,
                    span=None):
    """Plain version of ``cross_stage``: distances 2^(j_low+f-1) .. 2^j_low."""
    PLAIN_CALLS["cross_stage_ref"] += 1
    planes, ncmp = _planes(x, rider, lex)
    planes = _substages_ref(planes, ncmp, range(j_low + f - 1, j_low - 1, -1),
                            kk, invert, _mask(span))
    return _result(planes, rider, lex)


def finish_ref(x, tile, kk, invert=False, rider=None, lex=None, span=None):
    """Plain version of ``finish``: level kk's distances below ``tile``."""
    PLAIN_CALLS["finish_ref"] += 1
    planes, ncmp = _planes(x, rider, lex)
    planes = _substages_ref(planes, ncmp,
                            range(min(_log2(tile), kk) - 1, -1, -1), kk, invert,
                            _mask(span))
    return _result(planes, rider, lex)


def _cyclic_view(p, chunk):
    """Radix chunk c's rows in order: tiles {g * n_chunks + c} of
    CYCLIC_TILE rows."""
    n_chunks = p.numel() // chunk
    return (p.view(chunk // CYCLIC_TILE, n_chunks, CYCLIC_TILE)
            .transpose(0, 1).reshape(-1))


def chunk_sort_cyclic_ref(planes, ncmp, chunk, tile):
    """Plain version of ``chunk_sort_cyclic``: the new sorted planes."""
    PLAIN_CALLS["chunk_sort_cyclic_ref"] += 1
    planes = [_cyclic_view(p, chunk) for p in planes]
    for kk in range(1, _log2(tile) + 1):
        planes = _substages_ref(planes, ncmp, range(kk - 1, -1, -1), kk,
                                False, chunk - 1)
    return planes


def slot_merge_ref(planes, ncmp, chunk, slot, tile):
    """Plain version of ``slot_merge``: the new planes."""
    PLAIN_CALLS["slot_merge_ref"] += 1
    i = torch.arange(planes[0].numel(), device=planes[0].device)
    src = torch.where(((i >> _log2(slot)) & 1) == 1, i ^ (slot - 1), i)
    planes = [p[src] for p in planes]
    for kk in range(_log2(slot) + 1, _log2(tile) + 1):
        planes = _substages_ref(planes, ncmp, range(kk - 1, -1, -1), kk,
                                False, chunk - 1)
    return planes


# --- a sort's sources (csrc/tile_engine.cuh PlaneSource) -------------------

SIGN = -(1 << 31)  # int32 bit pattern 0x80000000: the keys' sign bias
PAD_KEY = 0x7FFFFFFF  # sign-biased 0xFFFFFFFF: pads sort after every row


class Source(NamedTuple):
    """Where a plane's rows come from in a sort's first load.  Rows [0, n)
    are the 32-bit columns ``cols`` back to back (int32 views), XORed with
    ``xor``, or, with no column, a number made from the row: row + add[0]
    below ``split``, row + add[1] from it.  Rows >= n hold ``pad``, or the
    row itself where ``pad`` is None."""

    cols: tuple
    n: int
    xor: int = 0
    add: tuple = (0, 0)
    split: int = 0
    pad: int | None = 0


def source_device(sources) -> torch.device:
    """The device of the sources' columns (a sort's sources hold one at
    least: its keys)."""
    return next(c.device for s in sources for c in s.cols)


def _column(c):
    if c.dim() != 1 or c.element_size() != 4 or not c.is_contiguous():
        raise ValueError("a source column is a contiguous 1-D 32-bit tensor")
    return c.view(torch.int32)


def key_source(*cols) -> Source:
    """uint32 keys (one column, or the join's two back to back), sign-biased
    at load, padded with the biased 0xFFFFFFFF."""
    cols = tuple(_column(c) for c in cols)
    return Source(cols, sum(c.numel() for c in cols), SIGN,
                  split=cols[0].numel(), pad=PAD_KEY)


def column_source(col, pad: int) -> Source:
    """A 32-bit rider column taken as it is, padded with ``pad``."""
    col = _column(col)
    return Source((col,), col.numel(), split=col.numel(), pad=pad)


def index_source(n: int, split: int | None = None, add=(0, 0),
                 pad: int | None = None) -> Source:
    """A number made from the row: row + add[0] below ``split`` (default
    n), row + add[1] from it, for rows < n; ``pad`` past them (None: the
    row, the stable sorts' index plane)."""
    return Source((), n, add=tuple(add), split=n if split is None else split,
                  pad=pad)


def _source_rows(s: Source, row0: int, rows: int, device) -> torch.Tensor:
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    if s.pad is None:
        out = r.to(torch.int32)
    else:
        out = torch.full((rows,), s.pad, dtype=torch.int32, device=device)
    hi = min(max(s.n - row0, 0), rows)  # rows of the range below n
    if hi == 0:
        return out
    if not s.cols:
        idx = r[:hi]
        out[:hi] = (idx + torch.where(idx < s.split, s.add[0], s.add[1])
                    ).to(torch.int32)
        return out
    off = 0
    for c in s.cols:  # the columns' rows that fall in [row0, row0 + hi)
        a, b = max(off, row0), min(off + c.numel(), row0 + hi)
        if a < b:
            out[a - row0: b - row0] = c[a - off: b - off] ^ s.xor
        off += c.numel()
    return out


def source_planes_ref(sources, row0: int, rows: int, device):
    """Plain version of a sort's first load: the planes' rows [row0, row0 +
    rows) made from their sources, bit for bit as the kernel's load makes
    them (and as PyTorch made the planes before it: ``ops/sort.py``
    ``_key_plane`` / ``_iota`` / ``_rider_planes``, ``ops/join.py``'s
    union)."""
    PLAIN_CALLS["source_planes_ref"] += 1
    return [_source_rows(s, row0, rows, device) for s in sources]


def _store_key(key_out, plane0, xor=SIGN):
    """Plain version of the unbiasing store: ``plane0``'s rows XORed into
    ``key_out`` = (out, row) at out[row:], the rows that fit."""
    out, row = key_out
    m = min(max(out.numel() - row, 0), plane0.numel())
    out[row: row + m] = plane0[:m] ^ xor


# --- kernel wrappers -----------------------------------------------------------


def _on_cuda(planes, block, tile=False):
    """Validate the planes for a pass over blocks of ``block`` rows (a
    power of two dividing their length; None: any length); True for CUDA
    tensors (launch the kernel), False for CPU ones (run the plain
    version).  ``tile``: the block of every plane is held in one block's
    shared memory."""
    x = planes[0]
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("expected a contiguous 1-D int32 tensor")
    for p in planes[1:]:
        if (p.dtype != torch.int32 or p.shape != x.shape
                or not p.is_contiguous() or p.device != x.device):
            raise ValueError("every rider / lex plane must be a contiguous "
                             "int32 tensor of the keys' shape on their device")
    n = x.numel()
    if block is not None and (_log2(block) < 1 or n % block):
        raise ValueError(f"{n} rows are not whole blocks of {block} (>= 2)")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if tile and 4 * len(planes) * block > MAX_SMEM_BYTES:
        raise ValueError(
            f"tile {block} exceeds one block's shared memory at "
            f"{len(planes)} planes"
        )
    return True


def _log_span(x, span):
    """log2 of the direction span: the whole array (a power of two) when
    ``span`` is None, else ``span``, which must divide it."""
    if span is None:
        return _log2(x.numel())
    if x.numel() % span:
        raise ValueError(f"span {span} does not divide {x.numel()} rows")
    return _log2(span)


def _plain(planes, out):
    for p, o in zip(planes, out if isinstance(out, tuple) else (out,)):
        p.copy_(o)
    return planes[0]


def _ptrs(planes):
    return (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])


def _launch(name, fn_name, planes, ncmp, *args, n=None, top=False):
    """Launch over the planes' rows (``n``: the virtual array of the
    overhang pass); ``top``: the compile-time plan's flag, the entry
    point's last argument, counted in TOP_LAUNCHES when set."""
    x = planes[0]
    name += _suffix(ncmp, len(planes))
    _build.launch(LAUNCHES, name, fn_name, x.device, _ptrs(planes),
                  len(planes), ncmp, x.numel() if n is None else n, *args,
                  int(top))
    if top:
        TOP_LAUNCHES[name] += 1


# --- the phase plan of the register tile engine -----------------------------


def tile_plan(log_t, kk_first, kk_last, r, lo_bit=0):
    """The phases of one tile pass (csrc/bitonic.cu ``tile_pass``): merge
    levels ``kk_first`` .. ``kk_last`` over a tile of 2^log_t rows, each
    thread holding 2^r rows of every plane in registers.

    Level kk runs its distances below the tile down to bit ``lo_bit``,
    index bits min(log_t, kk)-1 .. lo_bit, in phases of up to r consecutive
    bits, highest first (a cross pass's strided tile runs its top bits
    only).  A phase is a tuple (kk_a, kk_b, hi, lo, wlo): a thread holds
    the rows whose tile indices differ only in bits wlo .. wlo+r-1
    (``phase_rows``), which cover bits lo..hi, and every level kk in
    kk_a..kk_b runs the substages at bits min(hi, kk-1) down to lo there,
    with no synchronisation.  Consecutive
    levels that run all their bits inside bits 0..r-1 share one phase (the
    first r stages of a chunk sort).  Between two phases the tile makes one
    round trip through shared memory; the first phase reads device memory
    and the last one writes it.  With no level (``kk_first > kk_last``:
    ``slot_merge`` with the slot at least the tile) the plan is empty and
    the pass is a copy."""
    phases = []
    for kk in range(kk_first, kk_last + 1):
        hi = min(log_t, kk) - 1
        while hi >= lo_bit:
            lo = max(hi - r + 1, lo_bit)
            prev = phases[-1] if phases else None
            if (prev is not None and hi == kk - 1 and lo == 0
                    and prev[1:] == (kk - 1, kk - 2, 0, 0)):
                phases[-1] = (prev[0], kk, hi, 0, 0)
            else:
                phases.append((kk, kk, hi, lo, max(0, min(lo, log_t - r))))
            hi = lo - 1
    return tuple(phases)


def phase_rows(phase, log_t, r):
    """(groups, 2^r) int64 tensor: the tile rows a thread group holds in a
    phase, register u in column u.  Rows >= 2^log_t (a tile of fewer than
    2^r rows) do not exist and are never loaded or stored."""
    wlo = phase[4]
    g = torch.arange(max((1 << log_t) >> r, 1))[:, None]
    u = torch.arange(1 << r)[None, :]
    return ((g >> wlo) << (wlo + r)) | (g & ((1 << wlo) - 1)) | (u << wlo)


def round_trips(log_t, kk_first, kk_last, planes):
    """Shared-memory round trips of one tile pass at ``planes`` planes (0
    for an empty plan: a copy)."""
    return max(len(tile_plan(log_t, kk_first, kk_last,
                             max_fusion(planes))) - 1, 0)


def cross_round_trips(planes, j_low, f, kk):
    """Shared-memory round trips of one cross pass at ``planes`` planes (0
    for the register pass, f <= max_fusion(P))."""
    log_l = cross_segment(planes, j_low, f)
    return len(tile_plan(log_l + f, kk, kk, max_fusion(planes), log_l)) - 1


@functools.lru_cache(maxsize=None)
def _plan_arg(log_t, kk_first, kk_last, r, lo_bit=0):
    """The plan as the kernel takes it: (int32 array, phases), each phase
    packed as kk_a | kk_b << 6 | hi << 12 | lo << 16 | wlo << 20."""
    if kk_last > 63:
        raise ValueError(f"merge level {kk_last} above 63")
    codes = [a | b << 6 | hi << 12 | lo << 16 | w << 20
             for a, b, hi, lo, w in tile_plan(log_t, kk_first, kk_last, r,
                                              lo_bit)]
    return (ctypes.c_int32 * len(codes))(*codes), len(codes)


def _launch_chunk(planes, ncmp, chunk, invert, ascending, top):
    """One chunk_sort launch on the compile-time plan (``top``) or the
    run-time one."""
    log_c = _log2(chunk)
    _launch("chunk_sort", "radx_chunk_sort", planes, ncmp, log_c, int(invert),
            int(ascending),
            *_plan_arg(log_c, 1, log_c, max_fusion(len(planes))), top=top)


def chunk_sort(x, chunk, invert=False, ascending=False, rider=None, lex=None):
    """Bitonic stages 1..log2(chunk) inside every chunk of ``chunk`` rows, in
    place.  Directions follow the global index, so chunks alternate;
    ``ascending`` takes the index within the chunk; the plan at compile
    time where ``compile_time_plan`` says so."""
    log_c = _log2(chunk)
    planes, ncmp = _planes(x, rider, lex)
    _log2(x.numel())  # the network's directions span the whole array
    if not _on_cuda(planes, chunk, tile=True):
        return _plain(planes, chunk_sort_ref(
            x, chunk, invert=invert, ascending=ascending, rider=rider, lex=lex))
    _launch_chunk(planes, ncmp, chunk, invert, ascending,
                  compile_time_plan("chunk_sort", len(planes), log_c, log_c))
    return x


def _edge_mode(planes, ncmp):
    if (ncmp, len(planes)) not in SOURCE_MODES:
        raise ValueError(f"no source load / unbiasing store at num_cmp="
                         f"{ncmp}, {len(planes)} planes")


def _key_out_args(key_out, planes, xor):
    """(pointer, rows, xor) of plane 0's store: key_out = (out, row)
    takes rows [row, ...) of ``out`` (an int32 tensor on the planes'
    device), as many as it holds up to the planes' length; None: plane 0
    itself, as it is."""
    x = planes[0]
    if key_out is None:
        return x.data_ptr(), x.numel(), 0
    out, row = key_out
    if (out.dtype != torch.int32 or out.dim() != 1 or not out.is_contiguous()
            or out.device != x.device or row < 0):
        raise ValueError("the keys' output is a contiguous 1-D int32 tensor "
                         "on the planes' device")
    rows = min(max(out.numel() - row, 0), x.numel())
    return (out.data_ptr() + 4 * row if rows else out.data_ptr()), rows, xor


def _store(planes, res, key_out):
    """Write a plain version's result: every plane in place, or plane 0
    through the unbiasing store (``_store_key``) where ``key_out`` is
    given."""
    if key_out is None:
        return _plain(planes, res)
    for p, o in zip(planes[1:], res[1:]):
        p.copy_(o)
    _store_key(key_out, res[0] if isinstance(res, tuple) else res)
    return planes[0]


def _check_sources(sources, planes):
    if len(sources) != len(planes):
        raise ValueError("one source a plane")
    for s in sources:
        if len(s.cols) > 2 or any(c.device != planes[0].device
                                  or c.dtype != torch.int32 for c in s.cols):
            raise ValueError("at most two int32 source columns on the "
                             "planes' device")
        if not 0 <= s.split <= s.n < 2**31 or (
                s.cols and (sum(c.numel() for c in s.cols) != s.n
                            or s.split != s.cols[0].numel())):
            raise ValueError(f"bad source of {s.n} rows split at {s.split}")


def _source_fields(sources, planes):
    """The sources packed as csrc/bitonic_io.cu make_source reads them:
    index, col0, col1, n, split, xor, add0, add1, pad, pad_row a plane."""
    _check_sources(sources, planes)
    fields = []
    for s in sources:
        ptrs = [c.data_ptr() if c.numel() else 0 for c in s.cols]
        fields += [int(not s.cols), *ptrs, *[0] * (2 - len(ptrs)), s.n,
                   s.split, s.xor, *s.add, 0 if s.pad is None else s.pad,
                   int(s.pad is None)]
    return (ctypes.c_int64 * len(fields))(*fields)


def chunk_sort_sources(x, chunk, sources, row0=0, invert=False, rider=None,
                       lex=None, key_out=None):
    """``chunk_sort`` whose first load reads ``sources`` (one ``Source`` a
    plane, from source row ``row0``) and writes the sorted chunks to ``x``
    (with ``rider`` / ``lex``), out of place: their contents are not read.
    ``key_out`` = (out, row): plane 0 goes unbiased to out[row:] (the rows
    that fit) instead of to ``x``, the store of a sort whose array is one
    chunk.  Keys, rider and lex2 (``SOURCE_MODES``); the plan at compile
    time where ``compile_time_plan`` says so."""
    log_c = _log2(chunk)
    planes, ncmp = _planes(x, rider, lex)
    _edge_mode(planes, ncmp)
    _log2(x.numel())
    if not _on_cuda(planes, chunk, tile=True):
        _check_sources(sources, planes)
        made = source_planes_ref(sources, row0, x.numel(), x.device)
        k, rd, lx = _keywords(made, ncmp)
        return _store(planes, chunk_sort_ref(k, chunk, invert=invert,
                                             rider=rd, lex=lx), key_out)
    _launch_chunk_src(planes, ncmp, chunk, invert, sources, row0, key_out,
                      compile_time_plan("chunk_sort", len(planes), log_c,
                                        log_c))
    return x


def _launch_chunk_src(planes, ncmp, chunk, invert, sources, row0, key_out,
                      top):
    """One launch of chunk_sort's source form on the compile-time plan
    (``top``) or the run-time one."""
    log_c = _log2(chunk)
    _launch("chunk_sort/src", "radx_chunk_sort_src", planes, ncmp, log_c,
            int(invert), _source_fields(sources, planes), row0,
            *_key_out_args(key_out, planes, SIGN),
            *_plan_arg(log_c, 1, log_c, max_fusion(len(planes))), top=top)


def cross_segment(planes, j_low, f):
    """log2 of the segment L of a cross pass's strided tile: as long as
    the tile of ``cross_tile`` rows allows with 2^f segments, and at most
    the lowest distance 2^j_low (segments must not overlap)."""
    return min(j_low, _log2(cross_tile(planes)) - f)


def _launch_cross(planes, ncmp, j_low, f, kk, invert, log_span, top):
    """One cross pass launch; a strided pass (f > max_fusion(P)) on the
    compile-time plan (``top``) or the run-time one."""
    p = len(planes)
    r = max_fusion(p)
    log_l = cross_segment(p, j_low, f)
    plan = (None, 0) if f <= r else _plan_arg(log_l + f, kk, kk, r, log_l)
    _launch(f"cross_stage<{f}>", "radx_cross_stage", planes, ncmp,
            planes[0].numel(), j_low, f, kk, log_l, int(invert), log_span,
            *plan, top=top)


def cross_stage(x, j_low, f, kk, invert=False, rider=None, lex=None,
                span=None):
    """Compare-exchange at the f consecutive distances 2^(j_low+f-1) ..
    2^j_low of level kk in one pass, in place; directions from the index
    within blocks of ``span`` rows (default: the whole array); a strided
    pass on its compile-time plan where ``compile_time_plan`` says so."""
    planes, ncmp = _planes(x, rider, lex)
    log_span = _log_span(x, span)
    p = len(planes)
    if (not 1 <= f <= cross_fusion(p) or j_low + f > kk or kk > log_span
            or cross_segment(p, j_low, f) < 0):
        raise ValueError(f"bad cross pass f={f} j_low={j_low} kk={kk} at "
                         f"{p} planes, span 2^{log_span}")
    if not _on_cuda(planes, 1 << (j_low + f)):
        return _plain(planes, cross_stage_ref(x, j_low, f, kk, invert, rider,
                                               lex, span))
    log_l = cross_segment(p, j_low, f)
    _launch_cross(planes, ncmp, j_low, f, kk, invert, log_span,
                  compile_time_plan("cross_stage", p, log_l + f, kk, log_l))
    return x


# --- the compile-time plans (csrc/bitonic.cu top_code, top_pass) -------------

# Plane counts whose kernel takes its compile-time plan where it applies:
# the modes where it measured faster than the run-time plan, in turns on
# one card (tools/finish_bench.py, PERF.md §6).  The strided cross pass at
# two planes and more measured within 2% of its run-time plan either way,
# so those modes have no compile-time kernel (csrc/bitonic.cu cross_top).
# The radix tile passes have one in the modes the radix sort runs: keys,
# rider and lex2 (csrc/bitonic.cu radix_top).
TOP_MODES = {"chunk_sort": frozenset(range(1, MAX_PLANES + 1)),
             "cross_stage": frozenset({1}),
             "finish": frozenset(range(1, MAX_PLANES + 1)),
             "chunk_sort_cyclic": frozenset({1, 2}),
             "slot_merge": frozenset({1, 2})}
# The least slot (log2) of a slot_merge kernel on a compile-time plan: the
# radix plan's least slot (csrc/bitonic.cu kMinSlotLog).
MIN_TOP_SLOT_LOG = 10


def top_tile(planes):
    """The chunk and finish tile whose plans the kernels lay out at compile
    time (csrc/bitonic.cu top_log_t): the default ``SortConfig`` tiles of
    the plane count (keys, then (key, rider) and lex2 alike, then
    lex3..lex8), which are one tile in every mode."""
    return SortConfig().mode_tiles(planes, 1 if planes <= 2 else 2)[1]


def top_plan(log_t, kk, r, lo_bit=0):
    """The phases of a plan as the kernels lay it out at compile time
    (csrc/bitonic.cu top_code), in ``tile_plan``'s form: for kk >= log_t a
    level at or above a tile of 2^log_t rows, bits log_t-1 .. lo_bit in
    phases of r, highest first (``tile_plan(log_t, kk, kk, r, lo_bit)``);
    for kk < log_t the levels max(kk, 1) .. log_t of a chunk sort
    (``tile_plan(log_t, max(kk, 1), log_t, r)``; kk = 0 the whole sort,
    kk = log_s + 1 a slot merge): the levels up to r at bits r-1..0 in one
    phase, then each level k > r at bits k-1 .. 0 in ceil(k / r) phases.
    A phase's window starts at its lowest bit, clamped into the tile."""
    def phase(k, hi, floor):
        lo = max(hi - r + 1, floor)
        return (k, k, hi, lo, min(lo, log_t - r))

    if kk >= log_t:
        return tuple(phase(kk, hi, lo_bit)
                     for hi in range(log_t - 1, lo_bit - 1, -r))
    first = max(kk, 1)
    head = ((first, r, r - 1, 0, 0),) if first <= r else ()
    return (*head, *(phase(k, hi, 0) for k in range(max(first, r + 1),
                                                    log_t + 1)
                     for hi in range(k - 1, -1, -r)))


def compile_time_plan(kernel, planes, log_t, kk, lo_bit=0, log_s=None):
    """The one rule that picks a tile-engine kernel's compile-time plan
    (``kernel``: a key of ``TOP_MODES``) for a tile pass over 2^log_t rows
    at levels up to kk, down to bit ``lo_bit`` (``slot_merge``: from level
    ``log_s`` + 1): where the pass is the one the kernel lays out, in a mode
    of ``TOP_MODES``.  That is a chunk sort of the mode's chunk tile (kk =
    log_t; ``chunk_sort`` and the radix sort's ``chunk_sort_cyclic``), a
    finish pass at a level kk >= log_t of the mode's finish tile (every
    finish pass of a sort's merge levels above the chunk), a strided cross
    pass (more than max_fusion(P) distances, lowest bit ``lo_bit``) over the
    mode's cross tile (every sort path's wide pass), and a slot merge of the
    mode's tile (kk = log_t) whose slot is 2^MIN_TOP_SLOT_LOG or more and
    below the tile (every slot of the radix plan); the run-time plan
    anywhere else (other tiles, a level below the tile, other segments, the
    slot merge's copy)."""
    if planes not in TOP_MODES[kernel] or kk < log_t:
        return False
    if kernel == "cross_stage":
        return (1 << log_t == cross_tile(planes)
                and log_t - lo_bit > max_fusion(planes))
    if kernel == "slot_merge" and not MIN_TOP_SLOT_LOG <= log_s < log_t:
        return False
    return 1 << log_t == top_tile(planes)


def _launch_finish(planes, ncmp, tile, kk, invert, log_span, top):
    """One finish launch on the compile-time plan (``top``) or the run-time
    one."""
    log_t = _log2(tile)
    _launch("finish", "radx_finish", planes, ncmp, log_t, int(invert),
            log_span, *_plan_arg(log_t, kk, kk, max_fusion(len(planes))),
            top=top)


def finish(x, tile, kk, invert=False, rider=None, lex=None, span=None,
           key_out=None):
    """Every distance of level kk below ``tile``, inside each tile, in place;
    directions from the index within blocks of ``span`` rows; the plan at
    compile time where ``compile_time_plan`` says so.  ``key_out`` = (out,
    row): the unbiasing store of a sort's last level (keys, rider, lex2):
    plane 0 goes XORed with 0x80000000 to out[row:] (the rows that fit;
    ``out`` may be plane 0 itself), not to ``x``."""
    log_t = _log2(tile)
    planes, ncmp = _planes(x, rider, lex)
    log_span = _log_span(x, span)
    if log_t > log_span:
        raise ValueError(f"tile {tile} exceeds the span 2^{log_span}")
    if key_out is not None:
        _edge_mode(planes, ncmp)
    if not _on_cuda(planes, tile, tile=True):
        return _store(planes, finish_ref(x, tile, kk, invert, rider, lex,
                                         span), key_out)
    top = compile_time_plan("finish", len(planes), log_t, kk)
    if key_out is None:
        _launch_finish(planes, ncmp, tile, kk, invert, log_span, top)
    else:
        _launch_finish_out(planes, ncmp, tile, kk, invert, log_span, key_out,
                           top)
    return x


def _launch_finish_out(planes, ncmp, tile, kk, invert, log_span, key_out,
                       top):
    """One launch of finish's unbiasing form on the compile-time plan
    (``top``) or the run-time one."""
    log_t = _log2(tile)
    _launch("finish/unbias", "radx_finish_out", planes, ncmp, log_t,
            int(invert), log_span, *_key_out_args(key_out, planes, SIGN),
            *_plan_arg(log_t, kk, kk, max_fusion(len(planes))), top=top)


def _mode(planes, ncmp):
    """Validate a plane list for the compare mode: (1, 1 plane), (1, 2
    planes) or (2, 2..8 planes)."""
    if ncmp == 1 and len(planes) in (1, 2):
        return
    if ncmp == 2 and 2 <= len(planes) <= MAX_PLANES:
        return
    raise ValueError(f"num_cmp={ncmp} does not take {len(planes)} planes")


def _launch_io(name, fn_name, src, dst, ncmp, *args, top):
    """Launch a kernel that reads the planes ``src`` and writes ``dst``;
    ``top``: the compile-time plan's flag, the entry point's last argument,
    counted in TOP_LAUNCHES when set."""
    x = src[0]
    name += _suffix(ncmp, len(src))
    _build.launch(LAUNCHES, name, fn_name, x.device, _ptrs(src), _ptrs(dst),
                  len(src), ncmp, x.numel(), *args, int(top))
    if top:
        TOP_LAUNCHES[name] += 1


def _io_checks(src, dst, ncmp, chunk, tile):
    """Validate an out-of-place radix pass; True for CUDA tensors."""
    _mode(src, ncmp)
    if len(dst) != len(src):
        raise ValueError("one output plane per input plane")
    if chunk % tile or src[0].numel() % chunk:
        raise ValueError(f"tile {tile} / chunk {chunk} do not divide "
                         f"{src[0].numel()} rows")
    on_cuda = _on_cuda(src, tile, tile=True)
    _on_cuda(dst, tile)
    if any(a.data_ptr() == b.data_ptr() for a in src for b in dst):
        raise ValueError("the output planes must not alias the inputs")
    if dst[0].device != src[0].device:
        raise ValueError("inputs and outputs on one device")
    return on_cuda


def _launch_cyclic(src, dst, ncmp, chunk, tile, top):
    """One chunk_sort_cyclic launch on the compile-time plan (``top``) or
    the run-time one."""
    log_t = _log2(tile)
    _launch_io("chunk_sort_cyclic", "radx_chunk_sort_cyclic", src, dst, ncmp,
               log_t, _log2(chunk),
               *_plan_arg(log_t, 1, log_t, max_fusion(len(src))), top=top)


def chunk_sort_cyclic(src, dst, ncmp, chunk, tile):
    """Radix phase 1: stages 1..log2(tile) of an ascending sort of every
    radix chunk of ``chunk`` rows, chunk c made of the CYCLIC_TILE-row tiles
    {g * n_chunks + c} of ``src``, written contiguously to ``dst``."""
    if chunk < CYCLIC_TILE or tile > chunk:
        raise ValueError(f"chunk {chunk} must be >= {CYCLIC_TILE} and >= "
                         f"the tile {tile}")
    if not _io_checks(src, dst, ncmp, chunk, tile):
        for d, o in zip(dst, chunk_sort_cyclic_ref(src, ncmp, chunk, tile)):
            d.copy_(o)
        return dst
    log_t = _log2(tile)
    _launch_cyclic(src, dst, ncmp, chunk, tile, compile_time_plan(
        "chunk_sort_cyclic", len(src), log_t, log_t))
    return dst


def chunk_sort_cyclic_sources(dst, ncmp, chunk, tile, sources, row0=0):
    """``chunk_sort_cyclic`` whose first load reads ``sources`` (one
    ``Source`` a plane; the planes' row e is source row row0 + e) and
    writes ``dst``, which is not read: radix phase 1 of a sort whose planes
    are made in its own first launch.  Keys, rider and lex2
    (``SOURCE_MODES``); the plan at compile time where
    ``compile_time_plan`` says so."""
    if chunk < CYCLIC_TILE or tile > chunk:
        raise ValueError(f"chunk {chunk} must be >= {CYCLIC_TILE} and >= "
                         f"the tile {tile}")
    _edge_mode(dst, ncmp)
    if chunk % tile or dst[0].numel() % chunk:
        raise ValueError(f"tile {tile} / chunk {chunk} do not divide "
                         f"{dst[0].numel()} rows")
    if not _on_cuda(dst, tile, tile=True):
        _check_sources(sources, dst)
        made = source_planes_ref(sources, row0, dst[0].numel(), dst[0].device)
        for d, o in zip(dst, chunk_sort_cyclic_ref(made, ncmp, chunk, tile)):
            d.copy_(o)
        return dst
    log_t = _log2(tile)
    _launch_cyclic_src(dst, ncmp, chunk, tile, sources, row0,
                       compile_time_plan("chunk_sort_cyclic", len(dst), log_t,
                                         log_t))
    return dst


def _launch_cyclic_src(dst, ncmp, chunk, tile, sources, row0, top):
    """One launch of chunk_sort_cyclic's source form on the compile-time
    plan (``top``) or the run-time one."""
    log_t = _log2(tile)
    _launch("chunk_sort_cyclic/src", "radx_chunk_sort_cyclic_src", dst, ncmp,
            log_t, _log2(chunk), _source_fields(sources, dst), row0,
            *_plan_arg(log_t, 1, log_t, max_fusion(len(dst))), top=top)


def _launch_slot(src, dst, ncmp, chunk, slot, tile, top):
    """One slot_merge launch on the compile-time plan (``top``) or the
    run-time one."""
    log_t, log_s = _log2(tile), _log2(slot)
    _launch_io("slot_merge", "radx_slot_merge", src, dst, ncmp, log_t, log_s,
               _log2(chunk),
               *_plan_arg(log_t, log_s + 1, log_t, max_fusion(len(src))),
               top=top)


def slot_merge(src, dst, ncmp, chunk, slot, tile):
    """Radix phase C: in every radix chunk of ``chunk`` rows, reverse the
    odd slots of ``slot`` rows and run merge levels log2(slot)+1 ..
    log2(tile) within each tile, written to ``dst``."""
    if not slot < chunk or tile > chunk or chunk % slot:
        raise ValueError(f"slot {slot} / tile {tile} / chunk {chunk}")
    if not _io_checks(src, dst, ncmp, chunk, tile):
        for d, o in zip(dst, slot_merge_ref(src, ncmp, chunk, slot, tile)):
            d.copy_(o)
        return dst
    log_t = _log2(tile)
    _launch_slot(src, dst, ncmp, chunk, slot, tile, compile_time_plan(
        "slot_merge", len(src), log_t, log_t, log_s=_log2(slot)))
    return dst


# --- orchestration (radx_tpu/kernels/bitonic.py::_sort_pipeline) ------------


def _cross_schedule(kk, log_t, fmax):
    """(j_low, f) passes covering level kk's distances 2^(kk-1) .. 2^log_t,
    greedily fmax, ..., 1 consecutive distances per pass, highest first."""
    djs = list(range(kk - 1, log_t - 1, -1))
    i = 0
    while i < len(djs):
        f = min(fmax, len(djs) - i)
        yield djs[i + f - 1], f
        i += f


def _sort_pipeline(x, chunk_elems, finish_elems, presorted,
                   presorted_log=None, invert=False, rider=None, lex=None,
                   span=None, src=None, key_out=None):
    """Merge levels up to log2(span) (default: the whole array); with a
    span, the input is presorted and every block of ``span`` rows ends
    ascending (``invert`` descending).  ``src`` = (sources, row0): the chunk
    sort reads the planes' rows from their sources (``chunk_sort_sources``);
    ``key_out``: the last launch stores plane 0 unbiased there (``finish``,
    or the chunk sort where the array is one chunk)."""
    n = x.numel() if span is None else span
    log_n = _log_span(x, span)
    if n == 1:
        if src is not None or key_out is not None:
            raise ValueError("a one-row sort makes no launch")
        return x
    if span is not None and not presorted:
        raise ValueError("a span merges presorted runs only")
    c = min(chunk_elems, n)
    t = min(max(finish_elems, c), n)
    log_c, log_t = _log2(c), _log2(t)
    fmax = cross_fusion(len(_planes(x, rider, lex)[0]))
    if presorted_log is None:
        presorted_log = log_c
    start_kk = (presorted_log if presorted else log_c) + 1
    if src is not None and presorted:
        raise ValueError("the sources are read by the chunk sort")
    if key_out is not None and presorted and start_kk > log_n:
        raise ValueError("no launch stores the keys")
    if src is not None:
        chunk_sort_sources(x, c, *src, invert=invert, rider=rider, lex=lex,
                           key_out=key_out if start_kk > log_n else None)
    elif not presorted:
        chunk_sort(x, c, invert=invert, rider=rider, lex=lex)
    for kk in range(start_kk, log_n + 1):
        for j_low, f in _cross_schedule(kk, log_t, fmax):
            cross_stage(x, j_low, f, kk, invert, rider, lex, span)
        finish(x, t, kk, invert, rider, lex, span,
               key_out=key_out if kk == log_n else None)
    return x


def sort_planes(x, chunk_elems, finish_elems, descending=False, rider=None,
                lex=None, sources=None, row0=0, key_out=None):
    """Sort the rows of ``x`` (with ``rider`` or ``lex`` planes) in place,
    ascending (or descending: every direction bit flipped, the same passes).
    ``x.numel()`` is a power of two; the tiles are clamped to it.
    ``sources`` (one ``Source`` a plane, from source row ``row0``): the
    first launch makes the planes from them (``chunk_sort_sources``), so
    they are written, never read first, and may come from ``torch.empty``.
    ``key_out`` = (out, row): the last launch writes plane 0's keys unbiased
    (XORed with 0x80000000) to out[row:], the rows that fit (``out`` may be
    plane 0 itself), and leaves plane 0 unwritten otherwise.  Both in keys,
    rider and lex2 (``SOURCE_MODES``)."""
    return _sort_pipeline(x, chunk_elems, finish_elems, presorted=False,
                          invert=descending, rider=rider, lex=lex,
                          src=None if sources is None else (sources, row0),
                          key_out=key_out)


def sort_sources(sources, planes, ncmp, chunk_elems, finish_elems,
                 descending=False, row0=0, key_out=None):
    """``sort_planes`` of a plane list (``ncmp`` compare planes) made from
    ``sources`` in its first launch."""
    k, rd, lx = _keywords(planes, ncmp)
    return sort_planes(k, chunk_elems, finish_elems, descending, rider=rd,
                       lex=lx, sources=sources, row0=row0, key_out=key_out)


def sort_chunks_ascending(x, chunk_elems, lex=None):
    """Sort every chunk of ``chunk_elems`` rows ascending, independently (top
    k's per-chunk pass)."""
    return chunk_sort(x, min(chunk_elems, x.numel()), ascending=True, lex=lex)


def _keywords(planes, ncmp):
    """(keys, rider, lex) keyword form of a plane list."""
    if ncmp == 2:
        return planes[0], None, planes[1:]
    return planes[0], (planes[1] if len(planes) > 1 else None), None


def sort_chunks_ascending_cyclic(planes, ncmp, chunk, chunk_elems,
                                 finish_elems, sources=None, row0=0):
    """Radix phase 1 (port of ``sort_chunks_ascending_cyclic``): new planes
    in which every radix chunk of ``chunk`` rows holds the CYCLIC_TILE-row
    tiles {g * n_chunks + c} of ``planes``, sorted ascending.  The tiles
    (``chunk_elems`` for the stages in shared memory, ``finish_elems`` for
    the finish passes) are those of the mode's network; the inputs are left
    untouched.  With ``sources`` (one ``Source`` a plane, from source row
    ``row0``), ``planes`` are the new planes themselves, whose rows the
    first launch reads from the sources (``chunk_sort_cyclic_sources``):
    they are written, never read, and may come from ``torch.empty``."""
    c = min(chunk_elems, chunk)
    if sources is None:
        out = [torch.empty_like(p) for p in planes]
        chunk_sort_cyclic(planes, out, ncmp, chunk, c)
    else:
        out = planes
        chunk_sort_cyclic_sources(out, ncmp, chunk, c, sources, row0)
    k, rd, lx = _keywords(out, ncmp)
    _sort_pipeline(k, c, finish_elems, presorted=True, presorted_log=_log2(c),
                   rider=rd, lex=lx, span=chunk)
    return out


def merge_slots_ascending(planes, ncmp, chunk, slot, chunk_elems,
                          finish_elems):
    """Radix phase C (port of ``merge_slots_ascending``): new planes in which
    every radix chunk of ``chunk`` rows, made of ascending slots of ``slot``
    rows, is merged into one ascending run."""
    c = min(chunk_elems, chunk)
    t = min(max(finish_elems, c), chunk)
    out = [torch.empty_like(p) for p in planes]
    slot_merge(planes, out, ncmp, chunk, slot, t)
    k, rd, lx = _keywords(out, ncmp)
    _sort_pipeline(k, c, t, presorted=True,
                   presorted_log=max(_log2(slot), _log2(t)), rider=rd, lex=lx,
                   span=chunk)
    return out


def merge_sorted_chunks(x, chunk_elems, finish_elems, rider=None, lex=None):
    """Merge chunks of ``chunk_elems`` rows, chunk g sorted ascending for
    even g and descending for odd g (the level invariant of the network),
    into one ascending sequence in place: only the merge levels above the
    chunk run."""
    return _sort_pipeline(x, chunk_elems, finish_elems, presorted=True,
                          rider=rider, lex=lex)


def merge_sorted_runs(x, log_run, chunk_elems, finish_elems, descending=False,
                      rider=None, lex=None):
    """Merge runs of 2^log_run rows, run r sorted ascending for even r and
    descending for odd r, into one sorted sequence: only the merge levels
    above ``log_run`` run.  ``descending`` inverts every direction."""
    return _sort_pipeline(
        x, min(chunk_elems, 1 << log_run), finish_elems, presorted=True,
        presorted_log=log_run, invert=descending, rider=rider, lex=lex,
    )


def merge_bitonic_ascending(x, chunk_elems, finish_elems, descending=False,
                            rider=None, lex=None, key_out=None):
    """Sort ONE bitonic sequence of power-of-two length: the top merge level
    with every direction forced ascending (or all inverted)."""
    return _sort_pipeline(
        x, chunk_elems, finish_elems, presorted=True,
        presorted_log=_log2(x.numel()) - 1, invert=descending, rider=rider,
        lex=lex, key_out=key_out,
    )


def _cx_directed(lo, hi, ncmp, descending):
    """Elementwise compare-exchange of two equal-length lists of plane views,
    in place: ascending puts the smaller row on the low side, descending the
    larger.  With more than one plane, every plane swaps where the pair is
    strictly out of order.  The plain version of the valley merge's overhang
    pass (``_overhang``), which it runs on CPU planes."""
    PLAIN_CALLS["_cx_directed"] += 1
    if len(lo) == 1:
        mn, mx = torch.minimum(lo[0], hi[0]), torch.maximum(lo[0], hi[0])
        if descending:
            mn, mx = mx, mn
        lo[0].copy_(mn)
        hi[0].copy_(mx)
        return
    l1, h1 = (lo[1], hi[1]) if ncmp == 2 else (None, None)
    swap = (_after(ncmp, hi[0], lo[0], h1, l1) if descending
            else _after(ncmp, lo[0], hi[0], l1, h1))
    for a, b in zip(lo, hi):
        a_new, b_new = torch.where(swap, b, a), torch.where(swap, a, b)
        a.copy_(a_new)
        b.copy_(b_new)


def _virtual_rows(rows):
    """The virtual size of a valley merge of ``rows`` rows: the least power
    of two that holds them."""
    return 1 << (rows - 1).bit_length()


def _overhang(planes, ncmp, descending):
    """The top half-cleaner of a valley merge of r rows (2 <= r) on its
    virtual network of v = 2^ceil(log2 r) wires: rows i and i + v/2 for
    i < r - v/2, in place.  On the card one ``cross_stage<1>`` launch at
    distance v/2 over the r rows present (level log2 v, where every pair
    ascends; ``invert`` descends): one read and one write of the rows that
    move.  On the CPU its plain version ``_cx_directed``."""
    r = planes[0].numel()
    half = _virtual_rows(r) // 2
    if r < 2:
        raise ValueError(f"no overhang in {r} rows")
    if not _on_cuda(planes, None):
        _cx_directed([p[: r - half] for p in planes],
                     [p[half:] for p in planes], ncmp, descending)
        return
    j = _log2(half)
    _launch("cross_stage<1>", "radx_cross_stage", planes, ncmp, r, j, 1,
            j + 1, 0, int(descending), j + 1, None, 0, n=2 * half)


def merge_valley_ascending(x, chunk_elems, finish_elems, descending=False,
                           rider=None, lex=None, key_out=None):
    """Sort a bitonic sequence of any length in place — the arbitrary-N
    primitive.  The sequence is merged on a virtual 2^ceil(log2 L)-wire
    network whose tail wires hold +inf (ascending; -inf descending), so an
    exchange with a virtual high wire is a no-op and the tail never exists.
    Per halving level: the top half-cleaner touches only the physical
    overhang, the low half is then a full pow2 bitonic merge, and the high
    remainder is bitonic again; iterate on it.  ``key_out`` = (out, row):
    each half's last launch stores its keys unbiased at its own rows of
    out[row:] (``sort_sources``), so the sequence must not end in a lone
    row."""
    planes, ncmp = _planes(x, rider, lex)

    def split(ps):
        return _keywords(ps, ncmp)

    def store_at(off):
        return None if key_out is None else (key_out[0], key_out[1] + off)

    rest = planes[0].numel()
    while key_out is not None and rest != _virtual_rows(rest):
        rest -= _virtual_rows(rest) // 2
    if key_out is not None and rest < 2:
        raise ValueError("a valley merge that stores its keys must not end "
                         "in a lone row")
    cur, off = planes, 0
    while cur[0].numel() > 1:
        r = cur[0].numel()
        v = _virtual_rows(r)
        if r == v:
            k, rd, lx = split(cur)
            merge_bitonic_ascending(k, chunk_elems, finish_elems, descending,
                                    rd, lx, key_out=store_at(off))
            return x
        half = v // 2
        _overhang(cur, ncmp, descending)
        k, rd, lx = split([p[:half] for p in cur])
        merge_bitonic_ascending(k, chunk_elems, finish_elems, descending, rd,
                                lx, key_out=store_at(off))
        cur = [p[half:] for p in cur]
        off += half
    return x
