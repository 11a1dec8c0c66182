"""Group-by aggregation — port of radx_tpu/ops/groupby.py (the BASELINE's
"hash aggregate", second half of the config-3 query).

``groupby`` is sort-based: sort (key, value) pairs with the two-plane rider
sort (ops/sort._sort_rider on the bitonic kernels), combine each equal-key
run with one segmented scan (kernels/segscan.py), mark the last row of every
run, and compact those rows (ops/filter._compact on kernels/compact.py).
Aggregation is commutative, so the sort need not be stable.

``groupby_dense`` is the dense path for key spaces bounded by ``bins``: one
streaming pass of the dense aggregate kernels (kernels/aggregate.py) and a
compaction of the bins that hold rows.

Aggregates: sum, count, min, max over uint32 / int32 / float32 values;
keys are uint32 / int32 / float32 through the order-preserving encodings of
``sort_any`` (bin ids, uint32 / int32, for the dense path).  Outputs are
padded with ``num_groups`` (a 0-d int32 tensor on the device) valid rows:
``bins`` rows on the dense path; on the sort path the rider sort's length,
at least n (``_pad_len(n)``, or ``blocks * chunk`` where the arbitrary-N
rider sort runs).
"""

from __future__ import annotations

import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import aggregate, segscan
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
             agg: str, valid=None, n_valid=None):
    """Sort-based aggregation of encoded uint32 keys (counterpart of
    ``_groupby_jit`` and of the lazy ``groupby_lazy``): the rider sort, one
    segmented scan, the run ends compacted.  With ``valid`` (a row mask, the
    rows below the lazy count ``n_valid``) invalid rows sort as key
    0xFFFFFFFF with the aggregate's neutral rider, like the pads.  The
    all-pad / all-invalid group is dropped unless a valid key is
    0xFFFFFFFF: a padded length above the valid rows (``n_valid``, else n)
    means such rows exist, whatever that length is.  Returns (uint32 keys,
    aggregates, num_groups), padded to the rider sort's length (at least n
    rows: ``_pad_len(n)``, or ``blocks * chunk`` on the arbitrary-N path)."""
    n = enc.numel()
    neutral = _NEUTRAL[(agg, values.dtype)]
    if agg == "count":
        payload = (torch.ones(n, dtype=torch.int32, device=enc.device)
                   if valid is None else valid.to(torch.int32))
        op, acc_dtype = "sum", torch.int32
    else:
        payload = values.contiguous().view(torch.int32)
        if valid is not None:
            payload = torch.where(valid, payload, neutral)
        op, acc_dtype = agg, values.dtype
    is_max = enc.view(torch.int32) == -1  # key 0xFFFFFFFF
    if valid is not None:
        is_max &= valid
        enc = torch.where(valid, enc.view(torch.int32), -1).view(torch.uint32)
    skeys, acc = sort_ops._sort_rider(enc, payload, cfg, n, neutral)
    kp = skeys.view(torch.int32)  # (no uint32 comparisons on the CPU)
    acc = segscan.segscan_planes(kp, acc, op, acc_dtype, cfg.scan_elems)
    is_last = torch.ones_like(kp, dtype=torch.bool)
    torch.ne(kp[1:], kp[:-1], out=is_last[:-1])
    (uk, out), num_groups = _compact(is_last, [skeys, acc], cfg)
    phantom = ~is_max.any() & ((n if n_valid is None else n_valid) < kp.numel())
    return (uk.view(torch.uint32), out.view(acc_dtype),
            num_groups - phantom.to(torch.int32))


def groupby(keys, values, agg: str = "sum", cfg: SortConfig | None = None,
            *, device=None):
    """Aggregate ``values`` per unique key (uint32 / int32 / float32 keys).

    Returns ``(unique_keys, aggregates, num_groups)``: tensors of at least
    ``len(keys)`` rows (the rider sort's padding) of which the first
    ``num_groups`` are valid.  Unique keys ascend in the key dtype's
    order (float32 keys use the total order -inf < ... < +inf < nan, with
    -0.0 and +0.0 distinct groups).  uint32 / int32 sums wrap mod 2^32;
    float32 sums are added in an order that depends on the input; counts
    are int32.  numpy inputs go to ``device`` (default CUDA)."""
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
    uk, out, num_groups = _groupby(sort_ops._encode_keys(keys), values, cfg,
                                   agg)
    return sort_ops._decode_keys(uk, keys.dtype), out, num_groups


def _order_i32(values: torch.Tensor) -> torch.Tensor:
    """uint32 / int32 / float32 values -> order-isomorphic int32 (signed
    order == value order), the dense extrema kernel's input."""
    return sort_ops._encode_keys(values).view(torch.int32) ^ sort_ops._SIGN


def _order_i32_decode(oi32: torch.Tensor, dtype) -> torch.Tensor:
    enc = (oi32 ^ sort_ops._SIGN).view(torch.uint32)
    return sort_ops._decode_keys(enc, dtype)


def _dense(keys: torch.Tensor, values: torch.Tensor, agg: str, bins: int,
           cfg: SortConfig, n_valid=None):
    """Dense aggregate of uint32 bin ids and the compaction of the bins
    that hold rows: (bin ids uint32, aggregate in the output dtype,
    num_groups), ``bins`` rows (the counterpart of ``_groupby_dense_jit``
    and of the lazy ``groupby_lazy_dense``)."""
    if agg in ("min", "max"):
        out, counts = aggregate.dense_extrema(keys, _order_i32(values), bins,
                                              agg == "min", n_valid)
    else:
        sums, counts = aggregate.dense_sums(keys, values.view(torch.int32),
                                            bins, n_valid)
        out = (counts if agg == "count" else sums).view(torch.int32)
    bin_ids = torch.arange(bins, dtype=torch.int32, device=keys.device)
    (uk, out), ng = _compact(counts > 0, [bin_ids, out], cfg)
    if agg in ("min", "max"):
        out = _order_i32_decode(out, values.dtype)
    elif agg == "sum":
        out = out.view(values.dtype)
    return uk.view(torch.uint32), out, ng


def dense_applies(agg: str, value_dtype, bins) -> bool:
    """Whether ``Table.groupby(..., bins=)`` takes the dense path (the rule
    of radx_tpu/ops/table.py:158-162): sum of integers, count, or min / max
    within 8192 bins."""
    return bins is not None and (
        (agg == "sum" and value_dtype != torch.float32)
        or agg == "count"
        or (agg in ("min", "max") and bins <= aggregate.MAX_EXTREMA_BINS))


def groupby_dense(keys, values, agg: str = "sum", bins: int = 65536,
                  cfg: SortConfig | None = None, *, device=None):
    """Hash aggregate for key spaces bounded by ``bins``: one streaming pass
    of the dense aggregate kernels instead of a sort and a segmented scan.
    sum / count take bins <= 2^16, min / max bins <= 2^13 (powers of two >=
    128).  Semantics match ``groupby``: integer sums wrap mod 2^32; min /
    max cover uint32 / int32 / float32; count takes any 32-bit values.
    Keys are uint32 / int32 bin ids; raises ValueError if any key >= bins
    (one host read, as in the JAX package).  Returns (keys, aggregates,
    num_groups), ``bins`` rows of which ``num_groups`` are valid."""
    cfg = cfg or DEFAULT
    keys = sort_ops._as_tensor(keys, device)
    values = sort_ops._as_tensor(values, device if device is not None
                                 else keys.device)
    key_dtype = keys.dtype
    if key_dtype not in (torch.uint32, torch.int32):
        raise TypeError("dense groupby keys must be uint32/int32 bin ids")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError("dense groupby values must be uint32/int32/float32")
    if agg == "sum" and values.dtype == torch.float32:
        raise TypeError(
            "dense float32 sums are inexact on the MXU — use groupby")
    if keys.dim() != 1 or values.shape != keys.shape:
        raise ValueError("values must match keys shape")
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")
    max_bins = (aggregate.MAX_EXTREMA_BINS if agg in ("min", "max")
                else aggregate.MAX_SUM_BINS)
    if not (128 <= bins <= max_bins and bins & (bins - 1) == 0):
        raise ValueError(
            f"bins must be a power of two in [128, {max_bins}] for {agg!r}")
    if keys.numel() == 0:
        return keys, values, torch.zeros((), dtype=torch.int32,
                                         device=keys.device)
    keys, values = keys.contiguous(), values.contiguous()
    uk, out, ng = _dense(keys.view(torch.uint32), values, agg, bins, cfg)
    k = keys.view(torch.int32)  # key < bins <= 2^16 as uint32: 0 <= k < bins
    if not bool(((k >= 0) & (k < bins)).all()):
        raise ValueError(f"groupby_dense requires every key < bins={bins}")
    return uk.view(key_dtype), out, ng
