"""Stable mask compaction on Hopper — port of radx_tpu/kernels/compact.py.

``compact(mask, planes, tile_elems)`` moves the rows of P int32 planes (P =
1..4) whose int32 mask is nonzero to the front, in their original order, and
returns ``(outs, count)``: new planes of the input's length whose first
``count`` rows are the kept rows (the rest is not part of the result), and
``count`` as a 0-d int32 tensor on the planes' device.  Nothing reads the
count back to the host.

On a CUDA tensor two kernels of ``radx_tpu_torch/csrc/compact.cu`` run, with
one ``torch.cumsum`` over the per-tile counts between them (the XLA cumsum
of the reference's stitch):

  * ``compact_count`` — kept rows per tile of ``tile_elems`` rows;
  * ``compact_write`` — each kept row written at its tile's offset plus its
    rank in the tile (ballot / popc per warp, a scan of the warp counts).

This replaces the Pallas per-chunk kernel and its serial
``dynamic_update_slice`` stitch.  On a CPU tensor the plain PyTorch version
(boolean indexing) runs.  ``LAUNCHES`` / ``PLAIN_CALLS`` count both.
"""

from __future__ import annotations

import ctypes

import torch

from radx_tpu_torch.kernels import _build

KERNELS = ("compact_count", "compact_write")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = {"compact_ref": 0}
MAX_PLANES = 4


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def compact_ref(mask, planes):
    """Plain version: kept rows first, zeros after them."""
    PLAIN_CALLS["compact_ref"] += 1
    keep = mask != 0
    outs = []
    for p in planes:
        kept = p[keep]
        out = torch.zeros_like(p)
        out[: kept.numel()] = kept
        outs.append(out)
    return outs, keep.sum(dtype=torch.int32)


def _validate(mask, planes, tile_elems):
    def ok(x):
        return x.dtype == torch.int32 and x.dim() == 1 and x.is_contiguous()

    if not ok(mask) or mask.numel() == 0:
        raise ValueError("the mask must be a non-empty contiguous 1-D int32 "
                         "tensor")
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"compact takes 1..{MAX_PLANES} planes")
    for p in planes:
        if not ok(p) or p.shape != mask.shape or p.device != mask.device:
            raise ValueError("every plane must be a contiguous int32 tensor "
                             "of the mask's shape on its device")
    if tile_elems <= 0 or tile_elems & (tile_elems - 1):
        raise ValueError("tile_elems must be a power of two")
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mask.device}")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def count_tiles(mask, tile_elems):
    """Launch ``compact_count``: int64 kept rows per tile (CUDA only)."""
    n = mask.numel()
    counts = torch.empty(-(-n // tile_elems), dtype=torch.int64,
                         device=mask.device)
    _build.launch(LAUNCHES, "compact_count", "radx_compact_count", mask.device,
                  mask.data_ptr(), n, tile_elems.bit_length() - 1,
                  counts.data_ptr())
    return counts


def write_tiles(mask, planes, inclusive, tile_elems):
    """Launch ``compact_write``: the kept rows of each tile at the tile's
    offset (``inclusive``: the inclusive scan of the tile counts)."""
    outs = [torch.empty_like(p) for p in planes]
    _build.launch(LAUNCHES, "compact_write", "radx_compact_write", mask.device,
                  mask.data_ptr(), mask.numel(), tile_elems.bit_length() - 1,
                  inclusive.data_ptr(), _ptrs(planes), _ptrs(outs),
                  len(planes))
    return outs


def compact(mask, planes, tile_elems):
    """Stable compaction of int32 ``planes`` by the int32 ``mask``."""
    planes = list(planes)
    _validate(mask, planes, tile_elems)
    if mask.device.type == "cpu":
        return compact_ref(mask, planes)
    inclusive = torch.cumsum(count_tiles(mask, tile_elems), 0)
    outs = write_tiles(mask, planes, inclusive, tile_elems)
    return outs, inclusive[-1].to(torch.int32)
