"""Sort-based group-by aggregation — port of ``groupby`` in
radx_tpu/ops/groupby.py (the BASELINE's "hash aggregate", second half of
the config-3 query).

Sort (key, value) pairs with the two-plane rider sort (ops/sort._sort_rider
on the bitonic kernels), combine each equal-key run with one segmented scan
(kernels/segscan.py), mark the last row of every run, and compact those rows
(ops/filter._compact on kernels/compact.py).  Aggregation is commutative, so
the sort need not be stable.

Aggregates: sum, count, min, max over uint32 / int32 / float32 values;
keys are uint32 / int32 / float32 through the order-preserving encodings of
``sort_any``.  Outputs are padded to ``_pad_len(n)`` rows with
``num_groups`` (a 0-d int32 tensor on the device) valid rows; nothing is
read back to the host.  ``groupby_dense`` waits for the dense aggregate
kernels (ROADMAP M5).
"""

from __future__ import annotations

import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import segscan
from radx_tpu_torch.ops import sort as sort_ops
from radx_tpu_torch.ops.filter import _compact

AGGS = ("sum", "count", "min", "max")
_VALUE_DTYPES = (torch.uint32, torch.int32, torch.float32)

# int32 bit patterns of each aggregate's neutral element per value dtype
# (radx_tpu/ops/groupby.py:29-39): the riders of the pad rows.
_NEUTRAL = {
    ("sum", torch.uint32): 0, ("sum", torch.int32): 0, ("sum", torch.float32): 0,
    ("count", torch.uint32): 0, ("count", torch.int32): 0,
    ("count", torch.float32): 0,
    ("min", torch.uint32): -1,  # 0xFFFFFFFF
    ("min", torch.int32): 0x7FFFFFFF,
    ("min", torch.float32): 0x7F800000,  # +inf
    ("max", torch.uint32): 0,
    ("max", torch.int32): -0x80000000,
    ("max", torch.float32): -0x00800000,  # 0xFF800000 = -inf
}


def _groupby(enc: torch.Tensor, values: torch.Tensor, cfg: SortConfig,
             agg: str):
    """Sorted keys, per-row scanned aggregates, the run-end mask and the
    group count (counterpart of ``_groupby_jit``)."""
    n = enc.numel()
    if agg == "count":
        payload = torch.ones(n, dtype=torch.int32, device=enc.device)
        op, acc_dtype = "sum", torch.int32
    else:
        payload = values.contiguous().view(torch.int32)
        op, acc_dtype = agg, values.dtype
    neutral = _NEUTRAL[(agg, values.dtype)]
    skeys, acc = sort_ops._sort_rider(enc, payload, cfg, n, neutral)
    kp = skeys.view(torch.int32)  # (no uint32 comparisons on the CPU)
    acc = segscan.segscan_planes(kp, acc, op, acc_dtype, cfg.scan_elems)
    is_last = torch.ones_like(kp)
    is_last[:-1] = (kp[1:] != kp[:-1]).to(torch.int32)
    phantom = None
    if kp.numel() > n:  # padded: the all-pad group is dropped, unless a
        # real key is 0xFFFFFFFF (the pads then joined its group)
        phantom = (enc.view(torch.int32) != -1).all()
    return skeys, acc.view(acc_dtype), is_last, phantom


def groupby(keys, values, agg: str = "sum", cfg: SortConfig | None = None,
            *, device=None):
    """Aggregate ``values`` per unique key (uint32 / int32 / float32 keys).

    Returns ``(unique_keys, aggregates, num_groups)``: tensors of at least
    ``len(keys)`` rows (the engine's power-of-two padding) of which the
    first ``num_groups`` are valid.  Unique keys ascend in the key dtype's
    order (float32 keys use the total order -inf < ... < +inf < nan, with
    -0.0 and +0.0 distinct groups).  uint32 / int32 sums wrap mod 2^32;
    float32 sums are added in an order that depends on the input; counts
    are int32.  numpy inputs need ``device=``."""
    cfg = cfg or DEFAULT
    keys = sort_ops._as_tensor(keys, device)
    values = sort_ops._as_tensor(values, device if device is not None
                                 else keys.device)
    if keys.dtype not in sort_ops._KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError("values must be uint32/int32/float32")
    if keys.dim() != 1 or values.shape != keys.shape:
        raise ValueError("values must match keys shape (1-D)")
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    if keys.numel() == 0:
        return keys, values, torch.zeros((), dtype=torch.int32,
                                         device=keys.device)
    enc = sort_ops._encode_keys(keys)
    skeys, acc, is_last, phantom = _groupby(enc, values, cfg, agg)
    (uk, out), num_groups = _compact(is_last, [skeys, acc], cfg)
    if phantom is not None:
        num_groups = num_groups - phantom.to(torch.int32)
    uk = sort_ops._decode_keys(uk.view(torch.uint32), keys.dtype)
    return uk, out.view(acc.dtype), num_groups
