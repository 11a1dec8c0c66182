"""Segmented inclusive scan over sorted keys on Hopper — port of
radx_tpu/kernels/segscan.py.

``segscan_planes(keys, vals, op, dtype, tile_elems, flags=None)`` combines
each value with every earlier value of its equal-key run (keys sorted, or at
least with equal keys contiguous), inclusive, so the last row of a run holds
the run's aggregate.  Keys and values are int32 bit planes; ``dtype``
(uint32 / int32 / float32) says how the value bits are combined:

  * ``"sum"`` — mod 2^32 for the integers, float32 addition;
  * ``"min"`` / ``"max"`` — unsigned compare for uint32; for float32 NaN
    propagates and -0.0 / +0.0 resolve as in ``jnp.minimum`` /
    ``jnp.maximum`` (min takes -0.0, max +0.0), whatever their order;
  * ``"fill"`` — ``vals`` and ``flags`` are lists of M <= 4 (value, 0/1 flag)
    planes filled in one pass: a flagged row keeps its value, an unflagged
    row takes the last flagged value before it in its run and its flag
    becomes 1; where no flagged row precedes it, the row keeps its own
    value and flag 0 (the reference leaves unspecified values there).

``segscan_flat(skeys, acc, op, tile_elems, has=None)`` is the typed
counterpart of the JAX wrapper of the same name.

On a CUDA tensor three kernels of ``radx_tpu_torch/csrc/segscan.cu`` run
(reduce-then-scan): ``segscan_tile`` scans each tile and writes its tail,
``segscan_carry`` scans the tails across tiles, and ``segscan_apply`` folds
the carry into each tile's leading run.  On a CPU tensor the plain PyTorch
version runs: a Hillis-Steele doubling scan over the whole array, gated on
key equality (the reference's in-chunk algorithm).  Integer results and
float min/max are bit-equal between the two; float32 sums are added in
another order (tolerance 1e-5 of the run's sum of magnitudes).
"""

from __future__ import annotations

import ctypes

import torch

from radx_tpu_torch.config import MAX_SMEM_BYTES
from radx_tpu_torch.kernels import _build

OPS = {"sum": 0, "min": 1, "max": 2, "fill": 3}
DTYPES = {torch.uint32: 0, torch.int32: 1, torch.float32: 2}
KERNELS = ("segscan_tile", "segscan_carry", "segscan_apply")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = {"segscan_ref": 0}
MAX_FILL = 4
_SIGN = -(1 << 31)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


# --- plain PyTorch version ----------------------------------------------------


def _combine_ref(op, dtype, p, c):
    """prev (earlier) combined with cur (later), on int32 bit planes."""
    if op == "sum":
        if dtype == torch.float32:
            return (p.view(torch.float32) + c.view(torch.float32)).view(
                torch.int32)
        s = (p.to(torch.int64) + c.to(torch.int64)) & 0xFFFFFFFF
        return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)
    is_min = op == "min"
    if dtype == torch.float32:
        a, b = p.view(torch.float32), c.view(torch.float32)
        tie = (p | c) if is_min else (p & c)
        res = torch.where(b < a, c if is_min else p, tie)
        res = torch.where(a < b, p if is_min else c, res)
        res = torch.where(torch.isnan(b), c, res)
        return torch.where(torch.isnan(a), p, res)
    pa, pc = (p ^ _SIGN, c ^ _SIGN) if dtype == torch.uint32 else (p, c)
    take_c = pc < pa if is_min else pc > pa
    return torch.where(take_c, c, p)


def segscan_ref(keys, vals, op, dtype, flags=None):
    """Plain version of the scan (int32 planes in, new int32 planes out):
    one plane, or (values, flags) lists for ``"fill"``."""
    PLAIN_CALLS["segscan_ref"] += 1
    fill = op == "fill"
    vs = [v.clone() for v in (vals if fill else [vals])]
    hs = [h.ne(0).to(torch.int32) for h in flags] if fill else []
    n, s = keys.numel(), 1
    while s < n:
        same = keys[s:] == keys[:-s]
        for j in range(len(vs)):
            v = vs[j]
            if fill:
                h = hs[j]
                take = same & (h[s:] == 0) & (h[:-s] != 0)
                new_v = torch.where(take, v[:-s], v[s:])
                new_h = torch.where(same, h[s:] | h[:-s], h[s:])
                hs[j] = torch.cat((h[:s], new_h))
            else:
                new_v = torch.where(same, _combine_ref(op, dtype, v[:-s], v[s:]),
                                    v[s:])
            vs[j] = torch.cat((v[:s], new_v))
        s *= 2
    return (vs, hs) if fill else vs[0]


# --- kernel wrapper -------------------------------------------------------------


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _validate(keys, planes, op, dtype, tile_elems, m):
    if op not in OPS:
        raise ValueError(f"unknown segscan op {op!r}")
    if dtype not in DTYPES:
        raise TypeError(f"unsupported value dtype {dtype}")
    if not 1 <= m <= (MAX_FILL if op == "fill" else 1):
        raise ValueError(f"op {op!r} takes 1..{MAX_FILL if op == 'fill' else 1}"
                         " value planes")
    for x in (keys, *planes):
        if (x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous()
                or x.shape != keys.shape or x.device != keys.device):
            raise ValueError("keys and planes must be contiguous 1-D int32 "
                             "tensors of one shape on one device")
    if keys.numel() == 0:
        raise ValueError("segscan needs at least one row")
    if tile_elems < 256 or tile_elems & (tile_elems - 1):
        raise ValueError("tile_elems must be a power of two >= 256")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    smem = 4 * (1 + m + (op == "fill")) * (tile_elems + tile_elems // 32)
    if keys.device.type == "cuda" and smem > MAX_SMEM_BYTES:
        raise ValueError(f"tile {tile_elems} exceeds one block's shared memory")


def segscan_planes(keys, vals, op, dtype, tile_elems, flags=None):
    """Inclusive segmented ``op`` scan of int32 value planes within the
    equal-key runs of the int32 ``keys``.  Returns a new plane, or for
    ``"fill"`` (lists ``vals`` and ``flags`` of M planes) a pair of lists."""
    fill = op == "fill"
    vs = list(vals) if fill else [vals]
    hs = list(flags) if fill else []
    if fill and len(hs) != len(vs):
        raise ValueError("fill needs one flag plane per value plane")
    if not fill and flags is not None:
        raise ValueError("flags are for op='fill' only")
    _validate(keys, vs + hs, op, dtype, tile_elems, len(vs))
    if keys.device.type == "cpu":
        return segscan_ref(keys, vals, op, dtype, flags)
    launch = Launch(keys, vs, hs, op, dtype, tile_elems)
    for phase in range(1 if launch.tiles == 1 else 3):
        launch.run(phase)
    return (launch.outs, launch.houts) if op == "fill" else launch.outs[0]


class Launch:
    """The buffers of one scan on the card and its three kernel launches
    (``run(0)`` segscan_tile, ``run(1)`` segscan_carry, ``run(2)``
    segscan_apply, in that order; the last two only with more than one
    tile)."""

    def __init__(self, keys, vs, hs, op, dtype, tile_elems):
        n = keys.numel()
        self.tiles = -(-n // tile_elems)
        self.device = keys.device
        self.outs = [torch.empty_like(v) for v in vs]
        self.houts = [torch.empty_like(h) for h in hs]
        scratch = torch.empty((3 + len(vs)) * self.tiles, dtype=torch.int32,
                              device=keys.device)
        # the tensors stay referenced here while the kernels may use them
        self._keep = (keys, vs, hs, scratch)
        self._args = (keys.data_ptr(), n, tile_elems.bit_length() - 1,
                      _ptrs(vs), _ptrs(hs), _ptrs(self.outs),
                      _ptrs(self.houts), scratch.data_ptr(), OPS[op],
                      DTYPES[dtype], len(vs))

    def run(self, phase):
        _build.launch(LAUNCHES, KERNELS[phase], "radx_segscan", self.device,
                      phase, *self._args)


def segscan_flat(skeys, acc, op, tile_elems, has=None):
    """Typed wrapper (counterpart of the JAX ``segscan_flat``): ``skeys`` any
    32-bit tensor of sorted keys, ``acc`` a uint32 / int32 / float32 tensor
    (or, for ``"fill"``, a list of them with a list ``has`` of 0/1 or bool
    flags).  Returns the scanned values in ``acc``'s dtype, or for
    ``"fill"`` (values list, bool flags list)."""
    kp = skeys.contiguous().view(torch.int32)
    if op != "fill":
        out = segscan_planes(kp, acc.contiguous().view(torch.int32), op,
                             acc.dtype, tile_elems)
        return out.view(acc.dtype)
    accs, hass = list(acc), list(has)
    vals = [a.contiguous().view(torch.int32) for a in accs]
    flags = [h.ne(0).to(torch.int32) for h in hass]
    outs, houts = segscan_planes(kp, vals, op, accs[0].dtype, tile_elems,
                                 flags)
    return ([o.view(a.dtype) for o, a in zip(outs, accs)],
            [h != 0 for h in houts])
