"""Streaming (out-of-core) operators — port of radx_tpu/ops/chunked.py:
BASELINE config 3 at 2^30 rows, eager.

Columns live in host memory as numpy arrays; slabs of ``slab`` rows go to
``device`` (default CUDA) one at a time, through the single-call operators:

  * ``filter_chunked`` == ``filter_columns``: a stable compaction, slab by
    slab in order, the kept rows concatenated on the host;
  * ``groupby_chunked`` == ``groupby``: one group-by a slab, then the
    partial aggregates grouped again by key (``count`` partials summed),
    recursively while that shrinks them, else on the host
    (``_host_merge``).  Sum, min, max and count are associative, so the
    merge is exact; float32 sums differ from one call only in the order of
    the additions;
  * ``sort_chunked``: every power-of-two slab sorted on the card (even
    slabs ascending, odd ones descending), then a pairwise tree of run
    merges on the card (``kernels/bitonic.merge_sorted_runs``), the runs
    in host memory between levels, the sentinel tail stripped at the end.

All three return host numpy arrays of exact length.  ``SLAB`` is the
largest power of two that runs eager config 3 on one H100 with room to
spare (PERF.md: its peak device memory); ``filter_columns`` caps a call at
2^30 rows, so no slab is larger.
"""

from __future__ import annotations

import numpy as np
import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import bitonic
from radx_tpu_torch.ops import sort as sort_ops
from radx_tpu_torch.ops.filter import MAX_ROWS, filter_columns
from radx_tpu_torch.ops.groupby import groupby

SLAB = MAX_ROWS  # 2^30


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def filter_chunked(mask, cols, cfg: SortConfig | None = None,
                   slab: int = SLAB, *, device=None):
    """Stable compaction of host-resident 32-bit columns by a 0/1 mask.

    Returns ``(cols_out, count)``: host numpy columns of exactly ``count``
    rows, the kept rows in their original order."""
    cfg = cfg or DEFAULT
    mask = np.asarray(mask)
    cols = [np.asarray(c) for c in cols]
    n = mask.shape[0]
    outs = [[] for _ in cols]
    total = 0
    for lo in range(0, n, slab):
        hi = min(lo + slab, n)
        comp, cnt = filter_columns(mask[lo:hi], [c[lo:hi] for c in cols], cfg,
                                   device=device)
        cnt = int(cnt)
        total += cnt
        for o, c in zip(outs, comp):
            o.append(_host(c[:cnt]))
    return [np.concatenate(o) if o else np.empty((0,)) for o in outs], total


def groupby_chunked(keys, values, agg: str = "sum",
                    cfg: SortConfig | None = None, slab: int = SLAB, *,
                    device=None):
    """Aggregate host-resident values per unique key, slab by slab.

    Returns ``(unique_keys, aggregates, num_groups)`` as host numpy arrays
    of exactly ``num_groups`` rows.  The partials are grouped again, in
    slabs while that shrinks them (all-distinct keys would not), else on
    the host."""
    cfg = cfg or DEFAULT
    keys = np.asarray(keys)
    values = np.asarray(values)
    n = keys.shape[0]
    if n <= slab:
        uk, out, ng = groupby(keys, values, agg, cfg, device=device)
        ng = int(ng)
        return _host(uk[:ng]), _host(out[:ng]), ng
    uks, parts = [], []
    for lo in range(0, n, slab):
        hi = min(lo + slab, n)
        uk, out, ng = groupby(keys[lo:hi], values[lo:hi], agg, cfg,
                              device=device)
        ng = int(ng)
        uks.append(_host(uk[:ng]))
        parts.append(_host(out[:ng]))
    merged_k = np.concatenate(uks)
    merged_v = np.concatenate(parts)
    merge_agg = "sum" if agg == "count" else agg
    if merged_k.shape[0] > max(slab, (3 * n) // 4):
        # Near-distinct keys: another slab pass would not shrink the
        # partials, so the (already slab-reduced) merge ends on the host.
        return _host_merge(merged_k, merged_v, merge_agg)
    return groupby_chunked(merged_k, merged_v, merge_agg, cfg, slab,
                           device=device)


def sort_chunked(keys, cfg: SortConfig | None = None, slab: int = SLAB, *,
                 device=None) -> np.ndarray:
    """Ascending sort of host-resident uint32 keys, beyond one call's size.

    Slab i (a power of two, sentinel-padded: key 0xFFFFFFFF) is sorted on
    the device ascending for even i, descending for odd i; each level of
    the merge tree merges runs 2j and 2j + 1 into run j, descending iff
    (j // 2) & 1, until one ascending run is left.  Up to one slab, this
    is ``sort``."""
    cfg = cfg or DEFAULT
    keys = np.asarray(keys)
    if keys.dtype != np.uint32:
        raise TypeError("sort_chunked keys must be uint32")
    n = keys.shape[0]
    if slab < 1 or slab & (slab - 1):
        raise ValueError("slab must be a power of two")
    if n <= slab:
        return _host(sort_ops.sort(keys, cfg, device=device))
    dev = torch.device("cuda" if device is None else device)
    runs = _slab_runs(keys, slab, cfg, dev)
    log_run = slab.bit_length() - 1
    while len(runs) > 1:
        runs = _merge_level(runs, log_run, cfg, dev)
        log_run += 1
    return runs[0][:n].view(np.uint32) ^ np.uint32(0x80000000)


def _slab_runs(keys: np.ndarray, slab: int, cfg: SortConfig, dev):
    """The sorted slabs (sign-biased int32, in host memory): a power of two
    of them, slab i ascending for even i and descending for odd i."""
    n = keys.shape[0]
    n_slabs = 1 << (-(-n // slab) - 1).bit_length()
    runs = []
    for i in range(n_slabs):
        plane = torch.full((slab,), sort_ops._PAD_KEY, dtype=torch.int32,
                           device=dev)
        seg = keys[i * slab: min((i + 1) * slab, n)]
        if seg.shape[0]:
            plane[: seg.shape[0]] = (torch.from_numpy(seg).to(dev)
                                     .view(torch.int32) ^ sort_ops._SIGN)
        bitonic.sort_planes(plane, cfg.chunk_elems, cfg.finish_elems,
                            descending=i % 2 == 1)
        runs.append(_host(plane))
        del plane
    return runs


def _merge_level(runs, log_run: int, cfg: SortConfig, dev):
    """One level of the merge tree: runs 2j (ascending) and 2j + 1
    (descending) of 2^log_run rows each into run j of twice the length,
    descending iff (j // 2) & 1, so that the next level finds its runs in
    alternating directions."""
    out = []
    for j in range(0, len(runs), 2):
        a, b = runs[j], runs[j + 1]
        plane = torch.empty(a.shape[0] + b.shape[0], dtype=torch.int32,
                            device=dev)
        plane[: a.shape[0]].copy_(torch.from_numpy(a))
        plane[a.shape[0]:].copy_(torch.from_numpy(b))
        bitonic.merge_sorted_runs(plane, log_run, cfg.chunk_elems,
                                  cfg.finish_elems,
                                  descending=bool((j // 2) & 1))
        out.append(_host(plane))
        del plane
    return out


def _host_merge(keys, vals, agg):
    order = np.argsort(keys, kind="stable")
    k, v = keys[order], vals[order]
    starts = np.flatnonzero(np.concatenate([[True], k[1:] != k[:-1]]))
    uk = k[starts]
    ufunc = {
        "sum": np.add,
        "min": np.minimum,
        "max": np.maximum,
    }[agg]
    out = ufunc.reduceat(v, starts)
    return uk, out.astype(vals.dtype), uk.shape[0]
