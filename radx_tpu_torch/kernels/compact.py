"""Stable mask compaction on Hopper — port of radx_tpu/kernels/compact.py.

``compact(mask, planes, tile_elems)`` moves the rows of P int32 planes (P =
0..4) whose mask is nonzero (a bool / uint8 or int32 mask, read in its own
dtype) to the front, in their original order, and returns ``(outs,
count)``: new planes of the input's length whose first ``count`` rows are
the kept rows (the rest is not part of the result), and ``count`` as a 0-d
int32 tensor on the mask's device.  With no planes the pass only counts
(a ``COUNT(*) ... WHERE``).  Nothing reads the count back to the host.

On a CUDA tensor one kernel of ``radx_tpu_torch/csrc/compact.cu`` runs,
``compact``: a single pass over tiles of ``TILE`` rows in which each
block ranks its kept rows, finds its tile's output offset by a decoupled
look-back over its predecessors' status words, and writes the kept rows
there (a warp with many of them through shared memory, one contiguous run
a plane); the last tile writes the count.  With no planes the pass runs on
tiles of ``COUNT_TILE_BYTES`` of mask and writes no row.  Its scratch (the
tile counter and one status word a tile) is zeroed by one ``torch.zeros``.
This replaces the Pallas per-chunk kernel and its serial
``dynamic_update_slice`` stitch.

On a CPU tensor the plain PyTorch version (boolean indexing) runs.
``compact_lookback`` is a pure-torch model of the kernel's pass (tile
claiming, per-tile counts, the look-back of ``lookback.lookback_stop`` under
a chosen visibility of the predecessors' status words), for the CPU tests.
``LAUNCHES`` / ``PLAIN_CALLS`` count the kernel and the plain calls (the
model among them).
"""

from __future__ import annotations

import ctypes

import torch

from radx_tpu_torch.kernels import _build
from radx_tpu_torch.kernels.lookback import lookback_stop

KERNELS = ("compact",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = {"compact_ref": 0, "compact_lookback": 0}
MAX_PLANES = 4
# mask dtypes the kernel reads, by bytes a row
MASK_BYTES = {torch.bool: 1, torch.uint8: 1, torch.int32: 4}
# the kernel's tile: 256 threads x 16 rows, the least worst of 2^10..2^13
# over the paths' shapes (PERF.md)
TILE = 1 << 12
# with no planes (the count alone) a tile is 64 KiB of mask
COUNT_TILE_BYTES = 1 << 16


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _keep(mask, n_valid):
    keep = mask != 0
    if n_valid is not None:
        keep &= torch.arange(keep.numel(), device=keep.device) < n_valid
    return keep


def compact_ref(mask, planes, n_valid=None):
    """Plain version: kept rows first, zeros after them."""
    PLAIN_CALLS["compact_ref"] += 1
    keep = _keep(mask, n_valid)
    outs = []
    for p in planes:
        kept = p[keep]
        out = torch.zeros_like(p)
        out[: kept.numel()] = kept
        outs.append(out)
    return outs, keep.sum(dtype=torch.int32)


def _validate(mask, planes, tile_elems, n_valid):
    def ok(x):
        return x.dim() == 1 and x.is_contiguous()

    if not ok(mask) or mask.dtype not in MASK_BYTES or mask.numel() == 0:
        raise ValueError("the mask must be a non-empty contiguous 1-D bool, "
                         "uint8 or int32 tensor")
    if not 0 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"compact takes 0..{MAX_PLANES} planes")
    for p in planes:
        if (not ok(p) or p.dtype != torch.int32 or p.shape != mask.shape
                or p.device != mask.device):
            raise ValueError("every plane must be a contiguous int32 tensor "
                             "of the mask's shape on its device")
    if tile_elems <= 0 or tile_elems & (tile_elems - 1):
        raise ValueError("tile_elems must be a power of two")
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mask.device}")
    if n_valid is not None and (n_valid.dtype != torch.int32 or n_valid.dim()
                                or n_valid.device != mask.device):
        raise ValueError("n_valid must be a 0-d int32 tensor on the mask's "
                         "device")
    if mask.device.type == "cuda" and mask.numel() >= 1 << 31:
        raise ValueError("compact counts rows in int32: n < 2^31")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def compact(mask, planes, tile_elems, *, n_valid=None):
    """Stable compaction of int32 ``planes`` (none: the count alone) by
    ``mask`` (bool, uint8 or int32; nonzero = keep).  ``n_valid``: a 0-d int32 tensor on the
    device; only the rows below it may be kept (LazyTable's count, read by
    the kernel on the card).  ``tile_elems`` is the JAX chunk's counterpart
    and no result depends on it: the kernel's tiles are ``TILE`` rows."""
    planes = list(planes)
    _validate(mask, planes, tile_elems, n_valid)
    if mask.device.type == "cpu":
        return compact_ref(mask, planes, n_valid)
    n = mask.numel()
    tile = TILE if planes else COUNT_TILE_BYTES // MASK_BYTES[mask.dtype]
    scratch = torch.zeros(-(-n // tile) + 1, dtype=torch.int64,
                          device=mask.device)
    count = torch.empty((), dtype=torch.int32, device=mask.device)
    outs = [torch.empty_like(p) for p in planes]
    _build.launch(LAUNCHES, "compact", "radx_compact", mask.device,
                  mask.data_ptr(), MASK_BYTES[mask.dtype], n,
                  None if n_valid is None else n_valid.data_ptr(),
                  _ptrs(planes), _ptrs(outs),
                  len(planes), scratch.data_ptr(), count.data_ptr())
    return outs, count


# --- CPU model of the single pass ---------------------------------------------


def compact_lookback(mask, planes, tile_elems, gen):
    """Pure-torch model of the ``compact`` kernel (a plain call): blocks
    claim tiles of ``tile_elems`` rows from a counter (so tile t is the
    t-th claim), count their kept rows, rank them, and find their output
    offset by ``lookback_stop`` over the status words (A: the tile's count,
    P: its inclusive prefix), with the visibility drawn from the
    ``torch.Generator`` ``gen``; the last tile gives the count.  Returns
    what ``compact_ref`` returns (zeros after the kept rows)."""
    PLAIN_CALLS["compact_lookback"] += 1
    keep = mask != 0
    n = keep.numel()
    tiles = -(-n // tile_elems)
    padded = torch.zeros(tiles * tile_elems, dtype=torch.bool)
    padded[:n] = keep
    per_tile = padded.view(tiles, tile_elems)
    counts = per_tile.sum(1).tolist()
    prefix = [counts[0]]  # each tile's P, in claim order
    offsets = [0]
    for t in range(1, tiles):
        u, _ = lookback_stop(t, lambda _: False, gen)  # stops at P only
        off = prefix[u] + sum(counts[u + 1: t])
        offsets.append(off)
        prefix.append(off + counts[t])
    rank = per_tile.cumsum(1) - 1
    dst = (torch.tensor(offsets).unsqueeze(1) + rank).view(-1)[:n][keep]
    outs = []
    for p in planes:
        out = torch.zeros_like(p)
        out[dst] = p[keep]
        outs.append(out)
    return outs, torch.tensor(prefix[-1], dtype=torch.int32)
