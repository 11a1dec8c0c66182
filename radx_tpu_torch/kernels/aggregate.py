"""Dense GROUP BY aggregates on Hopper — port of radx_tpu/kernels/aggregate.py.

  * ``dense_sums(keys, values, bins, n_valid=None)`` -> ``(sums, counts)``:
    uint32 sums (wrapping mod 2^32) and int32 counts per bin, ``bins`` a
    power of two in [128, 65536];
  * ``dense_extrema(keys, ovals, bins, is_min, n_valid=None)`` ->
    ``(ext, counts)``: per-bin minimum or maximum of order-isomorphic int32
    values (the identity, INT32_MAX for min and INT32_MIN for max, where a
    bin is empty) and int32 counts, ``bins`` a power of two in [128, 8192].

``keys`` are uint32 (or their int32 view), ``values`` / ``ovals`` 32-bit
patterns.  Rows whose key is >= ``bins`` as uint32 are dropped, as the JAX
one-hots drop them; so are rows at or past ``n_valid``, a 0-d int32 tensor
on the keys' device that the kernel reads itself (no host sync), or all rows
when it is None.

On a CUDA tensor the kernels of ``radx_tpu_torch/csrc/aggregate.cu`` run
(shared-memory bins per block, warp-merged atomics; see the source).  On a
CPU tensor the plain PyTorch version runs: an int64 ``index_add_`` masked to
32 bits for the sums, ``scatter_reduce_`` ("amin" / "amax") from the identity
for the extrema, with dropped rows routed to a spare bin.  Both are exact:
results are bit-equal whatever the order of the adds.
"""

from __future__ import annotations

import torch

from radx_tpu_torch.kernels import _build

KERNELS = ("dense_sums", "dense_extrema")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(("dense_sums_ref", "dense_extrema_ref"), 0)
MAX_SUM_BINS = 1 << 16
MAX_EXTREMA_BINS = 1 << 13
_I32_MAX, _I32_MIN = (1 << 31) - 1, -(1 << 31)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _bin_of(keys, bins, n_valid):
    """int64 bin per row; ``bins`` (the spare bin) for dropped rows.  With
    bins <= 2^16, key < bins as uint32 is 0 <= key < bins as int32."""
    k = keys.view(torch.int32)
    keep = (k >= 0) & (k < bins)
    if n_valid is not None:
        keep &= torch.arange(k.numel(), device=k.device) < n_valid
    return torch.where(keep, k, bins).to(torch.int64)


def dense_sums_ref(keys, values, bins, n_valid=None):
    """Plain version of ``dense_sums``."""
    PLAIN_CALLS["dense_sums_ref"] += 1
    b = _bin_of(keys, bins, n_valid)
    v = values.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sums = torch.zeros(bins + 1, dtype=torch.int64, device=keys.device)
    sums.index_add_(0, b, v)
    counts = torch.zeros(bins + 1, dtype=torch.int64, device=keys.device)
    counts.index_add_(0, b, torch.ones_like(b))
    s = sums[:bins] & 0xFFFFFFFF
    s = torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)
    return s.view(torch.uint32), counts[:bins].to(torch.int32)


def dense_extrema_ref(keys, ovals, bins, is_min, n_valid=None):
    """Plain version of ``dense_extrema``."""
    PLAIN_CALLS["dense_extrema_ref"] += 1
    b = _bin_of(keys, bins, n_valid)
    ident = _I32_MAX if is_min else _I32_MIN
    ext = torch.full((bins + 1,), ident, dtype=torch.int32, device=keys.device)
    ext.scatter_reduce_(0, b, ovals.view(torch.int32),
                        "amin" if is_min else "amax")
    counts = torch.zeros(bins + 1, dtype=torch.int64, device=keys.device)
    counts.index_add_(0, b, torch.ones_like(b))
    return ext[:bins], counts[:bins].to(torch.int32)


def _on_cuda(keys, values, bins, max_bins, n_valid):
    """Validate; True for CUDA tensors (launch), False for CPU ones."""
    if not (128 <= bins <= max_bins and bins & (bins - 1) == 0):
        raise ValueError(f"bins must be a power of two in [128, {max_bins}]")
    for x in (keys, values):
        if (x.element_size() != 4 or x.dim() != 1 or not x.is_contiguous()
                or x.shape != keys.shape or x.device != keys.device):
            raise ValueError("keys and values must be contiguous 1-D 32-bit "
                             "tensors of one shape on one device")
    if n_valid is not None and (
            n_valid.dtype != torch.int32 or n_valid.dim() != 0
            or n_valid.device != keys.device):
        raise ValueError("n_valid must be a 0-d int32 tensor on the keys' "
                         "device")
    if keys.device.type == "cpu":
        return False
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    return True


def _launch(name, fn_name, keys, *args):
    _build.launch(LAUNCHES, name, fn_name, keys.device, *args)


def _ptr(t):
    return None if t is None else t.data_ptr()


def dense_sums(keys, values, bins, n_valid=None):
    """(sums u32[bins], counts i32[bins]) over the dense key space."""
    if not _on_cuda(keys, values, bins, MAX_SUM_BINS, n_valid):
        return dense_sums_ref(keys, values, bins, n_valid)
    sums = torch.zeros(bins, dtype=torch.int32, device=keys.device)
    counts = torch.zeros(bins, dtype=torch.int32, device=keys.device)
    _launch("dense_sums", "radx_dense_sums", keys, keys.data_ptr(),
            values.data_ptr(), keys.numel(), bins, _ptr(n_valid),
            sums.data_ptr(), counts.data_ptr())
    return sums.view(torch.uint32), counts


def dense_extrema(keys, ovals, bins, is_min, n_valid=None):
    """(ext i32[bins], counts i32[bins]) over the dense key space; ``ovals``
    compare as signed int32 (ops/groupby._order_i32)."""
    if not _on_cuda(keys, ovals, bins, MAX_EXTREMA_BINS, n_valid):
        return dense_extrema_ref(keys, ovals, bins, is_min, n_valid)
    ext = torch.full((bins,), _I32_MAX if is_min else _I32_MIN,
                     dtype=torch.int32, device=keys.device)
    counts = torch.zeros(bins, dtype=torch.int32, device=keys.device)
    _launch("dense_extrema", "radx_dense_extrema", keys, keys.data_ptr(),
            ovals.data_ptr(), keys.numel(), bins, int(is_min), _ptr(n_valid),
            ext.data_ptr(), counts.data_ptr())
    return ext, counts
