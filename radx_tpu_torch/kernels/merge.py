"""Merge of two ascending runs of int32 planes on Hopper (no Pallas
counterpart).

The JAX package's distributed sort merges the runs a shard receives with
the bitonic network's run merge over sentinel-padded slots of a fixed size
(``radx_tpu/parallel/dist_sort.py:112-126``): XLA needs static shapes.  The
port sends each run at its own length and merges two runs of any lengths
with ``merge_runs(a, b, num_cmp, out=None, key_xor=0)``:

  * ``a`` / ``b``: lists of the same number (1..4) of 1-D int32 planes, the
    planes of one run of equal length, plane 0 the sign-biased key;
  * the order is plane 0's (``num_cmp`` = 1) or (plane 0, plane 1)'s
    (``num_cmp`` = 2), both as signed int32; A's row comes first on a tie;
  * ``out``: the planes to write, |a| + |b| rows each (new ones when None),
    no overlap with a or b; ``key_xor`` is XORed into plane 0 as it is
    stored.  Returns the output planes.

On a CUDA tensor radx_tpu_torch/csrc/merge.cu runs in two launches
(``merge_runs/path``: the split of every tile of ``TILE`` output rows by a
binary search on its merge-path diagonal; ``merge_runs``: one block a tile,
merged in shared memory); a launch that fails raises.  On a CPU tensor the
plain PyTorch version runs: each row's output position by ``searchsorted``
on an int64 composite of its compare planes, then one scatter a plane.
``LAUNCHES`` / ``PLAIN_CALLS`` count the launches and the plain calls.
"""

from __future__ import annotations

import ctypes

import torch

from radx_tpu_torch.kernels import _build

MAX_PLANES = 4
TILE = 2048  # output rows a block of merge_runs (csrc/merge.cu kTile)
KERNELS = ("merge_runs", "merge_runs/path")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(("merge_runs_ref", "merge_path_ref"), 0)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _validate(a, b, num_cmp, out):
    def ok(x, dev):
        return (x.dim() == 1 and x.is_contiguous() and x.dtype == torch.int32
                and x.device == dev)

    if num_cmp not in (1, 2):
        raise ValueError(f"num_cmp must be 1 or 2, got {num_cmp}")
    if not num_cmp <= len(a) == len(b) <= MAX_PLANES:
        raise ValueError(f"merge_runs takes {num_cmp}..{MAX_PLANES} planes a "
                         f"run, the same number for both, got {len(a)} and "
                         f"{len(b)}")
    dev = a[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    na, nb = a[0].numel(), b[0].numel()
    for run, rows in ((a, na), (b, nb)):
        if not all(ok(p, dev) and p.numel() == rows for p in run):
            raise ValueError("every plane must be a contiguous 1-D int32 "
                             "tensor on one device, a run's planes of one "
                             "length")
    if out is not None and (len(out) != len(a) or not all(
            ok(o, dev) and o.numel() == na + nb for o in out)):
        raise ValueError(f"out must be {len(a)} contiguous 1-D int32 planes "
                         f"of {na + nb} rows on {dev}")


def _composite(planes, num_cmp):
    """int64 whose order is the rows' compare order."""
    key = planes[0].long()
    if num_cmp == 1:
        return key
    return (key << 32) + (planes[1].long() + (1 << 31))


def _positions(a, b, num_cmp):
    """Each row's output position: A's before B's on a tie."""
    ca, cb = _composite(a, num_cmp), _composite(b, num_cmp)
    pos_a = torch.arange(ca.numel(), device=ca.device) + torch.searchsorted(
        cb, ca, side="left")
    pos_b = torch.arange(cb.numel(), device=cb.device) + torch.searchsorted(
        ca, cb, side="right")
    return pos_a, pos_b


def _tiles(n):
    return (n + TILE - 1) // TILE


def merge_path_ref(a, b, num_cmp=1):
    """Plain ``merge_runs/path``: for each tile boundary d = t * TILE (and
    the end), the rows of A among the first d output rows (int64, tiles + 1
    of them)."""
    PLAIN_CALLS["merge_path_ref"] += 1
    n = a[0].numel() + b[0].numel()
    pos_a, _ = _positions(a, b, num_cmp)
    d = (torch.arange(_tiles(n) + 1, device=pos_a.device) * TILE).clamp_(
        max=n)
    return torch.searchsorted(pos_a, d)


def merge_runs_ref(a, b, num_cmp=1, out=None, key_xor=0):
    """Plain version of ``merge_runs``."""
    PLAIN_CALLS["merge_runs_ref"] += 1
    a, b = list(a), list(b)
    _validate(a, b, num_cmp, out)
    n = a[0].numel() + b[0].numel()
    if out is None:
        out = [torch.empty(n, dtype=torch.int32, device=a[0].device)
               for _ in a]
    pos_a, pos_b = _positions(a, b, num_cmp)
    for o, pa, pb in zip(out, a, b):
        o[pos_a] = pa
        o[pos_b] = pb
    if key_xor:
        out[0].bitwise_xor_(key_xor)
    return out


def _ptrs(planes):
    return (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))


def merge_path(a, b, num_cmp=1):
    """The splits of ``merge_path_ref``: the path kernel on CUDA tensors,
    the plain version on CPU ones."""
    a, b = list(a), list(b)
    _validate(a, b, num_cmp, None)
    if a[0].device.type == "cpu":
        return merge_path_ref(a, b, num_cmp)
    n = a[0].numel() + b[0].numel()
    split = torch.empty(_tiles(n) + 1, dtype=torch.int64, device=a[0].device)
    if n:
        _build.launch(LAUNCHES, "merge_runs/path", "radx_merge_path",
                      a[0].device, _ptrs(a), a[0].numel(), _ptrs(b),
                      b[0].numel(), len(a), num_cmp, split.data_ptr())
    return split


def merge_runs(a, b, num_cmp=1, out=None, key_xor=0):
    """The sorted union of two ascending runs (module docstring)."""
    a, b = list(a), list(b)
    _validate(a, b, num_cmp, out)
    if a[0].device.type == "cpu":
        return merge_runs_ref(a, b, num_cmp, out, key_xor)
    n = a[0].numel() + b[0].numel()
    if out is None:
        out = [torch.empty(n, dtype=torch.int32, device=a[0].device)
               for _ in a]
    if n:
        split = merge_path(a, b, num_cmp)
        _build.launch(LAUNCHES, "merge_runs", "radx_merge_runs", a[0].device,
                      _ptrs(a), a[0].numel(), _ptrs(b), b[0].numel(),
                      _ptrs(out), len(a), num_cmp, key_xor, split.data_ptr())
    return out
