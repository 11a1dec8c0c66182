"""Streaming (out-of-core) operators — port of radx_tpu/ops/chunked.py:
BASELINE config 3 at 2^30 rows, eager.

Columns live in host memory as numpy arrays; slabs of ``slab`` rows go to
``device`` (default CUDA) one at a time, through the single-call operators.
Every copy between the host and the device goes through the pinned ring of
``ops/_staging.py`` on a copy stream, never through pageable memory; the
next slab's copies to the device are issued before this slab's count is
read, and each slab's results come down to their offsets in the output
arrays on a thread of their own while the next slab goes up:

  * ``filter_chunked`` == ``filter_columns``: a stable compaction, slab by
    slab in order, the kept rows written at the running count;
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
from radx_tpu_torch.ops import _staging
from radx_tpu_torch.ops import sort as sort_ops
from radx_tpu_torch.ops.filter import MAX_ROWS, filter_columns
from radx_tpu_torch.ops.groupby import groupby

SLAB = MAX_ROWS  # 2^30


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def filter_chunked(mask, cols, cfg: SortConfig | None = None,
                   slab: int = SLAB, *, device=None):
    """Stable compaction of host-resident 32-bit columns by a 0/1 mask.

    Returns ``(cols_out, count)``: host numpy columns of exactly ``count``
    rows, the kept rows in their original order."""
    cfg = cfg or DEFAULT
    mask = np.ascontiguousarray(mask)
    cols = [np.ascontiguousarray(c) for c in cols]
    if mask.ndim != 1:
        raise ValueError("the mask must be 1-D")
    n = mask.shape[0]
    if n == 0:
        return [np.empty((0,)) for _ in cols], 0
    # Each slab's kept rows go straight to their offset in the output.
    outs = [np.empty(n, c.dtype) for c in cols]
    total = 0
    with _staging.Staging(_device(device)) as st:

        def upload(lo):
            hi = min(lo + slab, n)
            return st.upload(mask[lo:hi]), [st.upload(c[lo:hi]) for c in cols]

        nxt = upload(0)
        for lo in range(0, n, slab):
            comp, cnt = filter_columns(*nxt, cfg)
            # the next slab's copies go out before this slab's count is read
            nxt = upload(lo + slab) if lo + slab < n else None
            cnt = int(cnt)
            for o, c in zip(outs, comp):
                st.get(c[:cnt], o[total: total + cnt])
            total += cnt
            del comp  # the queued downloads keep what they still read
    return [o[:total] for o in outs], total


def groupby_chunked(keys, values, agg: str = "sum",
                    cfg: SortConfig | None = None, slab: int = SLAB, *,
                    device=None):
    """Aggregate host-resident values per unique key, slab by slab.

    Returns ``(unique_keys, aggregates, num_groups)`` as host numpy arrays
    of exactly ``num_groups`` rows.  The partials are grouped again, in
    slabs while that shrinks them (all-distinct keys would not), else on
    the host."""
    with _staging.Staging(_device(device)) as st:
        return _groupby_chunked(st, keys, values, agg, cfg or DEFAULT, slab)


def _groupby_chunked(st, keys, values, agg, cfg, slab):
    keys = np.ascontiguousarray(keys)
    values = np.ascontiguousarray(values)
    n = keys.shape[0]
    if n <= slab:
        uk, out, ng = groupby(st.upload(keys), st.upload(values), agg, cfg)
        ng = int(ng)
        return st.fetch(uk[:ng]), st.fetch(out[:ng]), ng

    def upload(lo):
        hi = min(lo + slab, n)
        return st.upload(keys[lo:hi]), st.upload(values[lo:hi])

    # A slab has at most as many groups as rows: n rows hold every partial.
    merged_k = merged_v = None
    total = 0
    nxt = upload(0)
    for lo in range(0, n, slab):
        uk, out, ng = groupby(*nxt, agg, cfg)
        nxt = upload(lo + slab) if lo + slab < n else None
        ng = int(ng)
        if merged_k is None:
            merged_k = np.empty(n, _staging.numpy_dtype(uk.dtype))
            merged_v = np.empty(n, _staging.numpy_dtype(out.dtype))
        st.get(uk[:ng], merged_k[total: total + ng])
        st.get(out[:ng], merged_v[total: total + ng])
        total += ng
        del uk, out
    st.wait()
    merged_k, merged_v = merged_k[:total], merged_v[:total]
    merge_agg = "sum" if agg == "count" else agg
    if total > max(slab, (3 * n) // 4):
        # Near-distinct keys: another slab pass would not shrink the
        # partials, so the (already slab-reduced) merge ends on the host.
        return _host_merge(merged_k, merged_v, merge_agg)
    return _groupby_chunked(st, merged_k, merged_v, merge_agg, cfg, slab)


def sort_chunked(keys, cfg: SortConfig | None = None, slab: int = SLAB, *,
                 device=None) -> np.ndarray:
    """Ascending sort of host-resident uint32 keys, beyond one call's size.

    Slab i (a power of two, sentinel-padded: key 0xFFFFFFFF) is sorted on
    the device ascending for even i, descending for odd i; each level of
    the merge tree merges runs 2j and 2j + 1 into run j, descending iff
    (j // 2) & 1, until one ascending run is left.  Up to one slab, this
    is ``sort``."""
    cfg = cfg or DEFAULT
    keys = np.ascontiguousarray(keys)
    if keys.dtype != np.uint32:
        raise TypeError("sort_chunked keys must be uint32")
    n = keys.shape[0]
    if slab < 1 or slab & (slab - 1):
        raise ValueError("slab must be a power of two")
    dev = _device(device)
    with _staging.Staging(dev) as st:
        if n <= slab:
            return st.fetch(sort_ops.sort(st.upload(keys), cfg))
        runs = _slab_runs(keys, slab, cfg, dev, st)
        log_run = slab.bit_length() - 1
        while len(runs) > 1:
            runs = _merge_level(runs, log_run, cfg, dev, st)
            log_run += 1
    return runs[0][:n].view(np.uint32) ^ np.uint32(0x80000000)


def _slab_runs(keys: np.ndarray, slab: int, cfg: SortConfig, dev,
               st: _staging.Staging | None = None):
    """The sorted slabs (sign-biased int32, in host memory): a power of two
    of them, slab i ascending for even i and descending for odd i."""
    if st is None:
        with _staging.Staging(dev) as st:
            return _slab_runs(keys, slab, cfg, dev, st)
    n = keys.shape[0]
    n_slabs = 1 << (-(-n // slab) - 1).bit_length()
    runs = []
    for i in range(n_slabs):
        plane = torch.full((slab,), sort_ops._PAD_KEY, dtype=torch.int32,
                           device=dev)
        seg = keys[i * slab: min((i + 1) * slab, n)]
        if seg.shape[0]:
            plane[: seg.shape[0]] = (st.upload(seg).view(torch.int32)
                                     ^ sort_ops._SIGN)
        bitonic.sort_planes(plane, cfg.chunk_elems, cfg.finish_elems,
                            descending=i % 2 == 1)
        runs.append(st.fetch(plane))  # comes down under the next slab
        del plane
    st.wait()
    return runs


def _merge_level(runs, log_run: int, cfg: SortConfig, dev,
                 st: _staging.Staging | None = None):
    """One level of the merge tree: runs 2j (ascending) and 2j + 1
    (descending) of 2^log_run rows each into run j of twice the length,
    descending iff (j // 2) & 1, so that the next level finds its runs in
    alternating directions."""
    if st is None:
        with _staging.Staging(dev) as st:
            return _merge_level(runs, log_run, cfg, dev, st)
    out = []
    for j in range(0, len(runs), 2):
        a, b = runs[j], runs[j + 1]
        plane = st.empty(a.shape[0] + b.shape[0], torch.int32)
        st.put(a, plane[: a.shape[0]])
        st.put(b, plane[a.shape[0]:])
        bitonic.merge_sorted_runs(st.handoff(plane), log_run,
                                  cfg.chunk_elems, cfg.finish_elems,
                                  descending=bool((j // 2) & 1))
        out.append(st.fetch(plane))
        del plane
    st.wait()
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
