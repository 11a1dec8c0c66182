"""Benchmarks of the port on the card, one JSON line per metric.

    python -m radx_tpu_torch.bench                 # every metric below
    python -m radx_tpu_torch.bench sort groupby    # some of them
    python -m radx_tpu_torch.bench sweep profile   # tile sweeps; breakdowns

Metrics (what is timed is the user's entry point on tensors already on the
card; ``utils.timing.time_cuda``: CUDA events, warm-up, least of the
repeats, with their spread; every result is first gated on equality with a
plain torch reference on the card):

  * ``sort_u32_keys_per_s_n2e23`` / ``_n2e26`` — ``sort`` of shuffled uint32
    keys (a permutation of 0..N-1, numpy seed 0: the JAX package's
    ``bench.py`` fixture);
  * ``groupby_sum_rows_per_s_n2e26`` — ``groupby(keys, vals, "sum")``, keys
    uniform ``% 10007``, values uniform uint32 (the shape of
    ``bench_suite.py``'s ``groupby_64m``);
  * ``filter_rows_per_s_n2e26`` — ``filter_columns(vals & 1, [vals])`` (the
    shape of ``filter_64m``);
  * ``query_filter_groupby_rows_per_s_n2e28`` — the config-3 query: three
    uint32 columns (key < 2^20, value < 2^11, predicate), ``filter_columns
    (pred < 2^31, [key, value])`` then ``groupby`` sum of the kept rows (one
    host read of the kept count, to cut the columns);
  * ``sort_pairs_u32_pairs_per_s_n2e28`` — stable ``sort_pairs`` of 2^28
    uint32 keys below 2^24 with uint32 payloads (BASELINE config 2);
  * ``join_rows_per_s_n1e8`` — ``Table.join`` (inner) of two 10^8-row
    tables, input rows of both sides per second: distinct uint32 build
    keys, 90% of the probe keys drawn from them (BASELINE config 4);
  * ``query_filter_groupby_dense_rows_per_s_n2e30`` — BASELINE config 3 at
    its own size through ``LazyTable``: ``filter(pred < 2^31)`` then
    ``groupby(bucket, value, "sum", bins=256)`` over 2^30 rows, one host
    sync;
  * ``query_filter_groupby_chunked_rows_per_s_n2e30`` — the same query
    eager from host memory (``python -m radx_tpu_torch.bench chunked``, at
    slabs of 2^28, 2^29 and 2^30 with the peak device memory of each):
    ``filter_chunked(pred < 2^31, [bucket, value])`` then
    ``groupby_chunked`` sum by bucket, the mask made on the host and the
    transfers included, one run by the host clock;
  * ``sort_radix_u32_keys_per_s_n2e26`` / ``_n2e28`` — ``sort`` under
    ``SortConfig(strategy="radix")`` on the permutation keys (the
    ``sort_radix_64m`` / ``_268m`` rows of the JAX ``bench_suite``), gated on
    ``torch.sort`` and on the overflow flag being False, with the bitonic
    rate at the same n beside it (``python -m radx_tpu_torch.bench radix``,
    which also prints ``profile_radix``, the breakdown by kernel).

``sweep`` runs the tile sweep of the keys-only, rider and lexicographic
sorts, ``sweep_scan`` times the single-pass compaction on three shapes and
sweeps the segmented scan's tile, ``sweep_gather`` the value gather's
window and tile (partitioned route) beside its direct route,
``profile`` the keys-only sort, group-by, join and dense-query breakdowns by
layer (torch.profiler), ``launch`` the cost of one small kernel's launch
path.

Inputs are made from fixed seeds, with numpy or, for the large slice-3
inputs, with a seeded generator on the card (the card has no JAX, so the
reference's ``radx_tpu.runtime`` generators are not used).  With no CUDA
device every measure raises.
"""

from __future__ import annotations

import functools
import json
import re
import sys
import time

import numpy as np
import torch

from radx_tpu_torch.config import SortConfig
from radx_tpu_torch.kernels import bitonic, compact, msd, radix_sort, segscan
from radx_tpu_torch.ops import chunked
from radx_tpu_torch.ops.filter import filter_columns
from radx_tpu_torch.ops.groupby import groupby
from radx_tpu_torch.ops.sort import argsort, sort, sort_pairs
from radx_tpu_torch.utils import timing

N = 1 << 23
ITERS, REPEATS = 10, 9  # back-to-back sorts per repeat; least of the repeats
_SIGN = -(1 << 31)


def torch_sort_u32(keys: torch.Tensor) -> torch.Tensor:
    """uint32 sort by ``torch.sort`` on the sign-biased int32 view (PyTorch
    sorts int32 on every device)."""
    biased = keys.view(torch.int32) ^ _SIGN
    return (torch.sort(biased).values ^ _SIGN).view(torch.uint32)


def torch_groupby_u32(keys: torch.Tensor, vals: torch.Tensor):
    """Plain reference of a uint32 group-by: ``torch.sort`` + ``torch.
    unique_consecutive`` + int64 sums at the run ends.  Returns (unique keys
    as int32 bit patterns, counts, sums mod 2^32, mins, maxes) as int64
    except the keys."""
    order = torch.sort(keys.view(torch.int32) ^ _SIGN, stable=True)
    uk, counts = torch.unique_consecutive(order.values, return_counts=True)
    sv = vals.view(torch.int32).to(torch.int64)[order.indices] & 0xFFFFFFFF
    ends = torch.cumsum(counts, 0) - 1
    csum = torch.cumsum(sv, 0)[ends]
    sums = (csum - torch.cat((csum.new_zeros(1), csum[:-1]))) & 0xFFFFFFFF
    group = torch.repeat_interleave(torch.arange(uk.numel(), device=keys.device),
                                    counts)
    mins = torch.full_like(csum, 1 << 40).scatter_reduce(0, group, sv, "amin")
    maxs = torch.full_like(csum, -1).scatter_reduce(0, group, sv, "amax")
    return uk ^ _SIGN, counts, sums, mins, maxs


@functools.lru_cache(maxsize=2)
def permutation_keys(n: int) -> np.ndarray:
    """The permutation fixture, made once per size in a process: callers
    copy it and never write it."""
    return np.random.default_rng(0).permutation(n).astype(np.uint32)


def _name(n: int) -> str:
    log_n = n.bit_length() - 1
    if n == 1 << log_n:
        return f"n2e{log_n}"
    e = len(str(n)) - 1
    return f"n1e{e}" if n == 10**e else f"n{n}"


def _row(metric, n, t, unit="rows/s", **extra):
    return {"metric": metric, "value": n / t.seconds, "unit": unit,
            "ms": t.seconds * 1e3, "spread_pct": t.spread_pct, **extra,
            "device": timing.device_info()}


def measure(n: int = N, cfg: SortConfig | None = None) -> dict:
    """Time ``sort`` on n permutation keys on the card; one result row."""
    dev = timing.require_cuda()
    keys = torch.from_numpy(permutation_keys(n)).to(dev)
    got = sort(keys, cfg)
    want = torch_sort_u32(keys)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"sort of {n} keys differs from torch.sort")
    t = timing.time_cuda(lambda: sort(keys, cfg), iters=ITERS, repeats=REPEATS)
    return _row(f"sort_u32_keys_per_s_{_name(n)}", n, t, unit="keys/s")


def _check_groups(uk, out, ng, keys, vals, field="sums"):
    want = dict(zip(("keys", "counts", "sums", "mins", "maxs"),
                    torch_groupby_u32(keys, vals)))
    g = want["keys"].numel()
    ok = int(ng) == g and torch.equal(uk[:g].view(torch.int32), want["keys"])
    got = out[:g].view(torch.int32).to(torch.int64)
    if field != "counts":
        got &= 0xFFFFFFFF
    if not (ok and torch.equal(got, want[field])):
        raise AssertionError(f"groupby ({field}) differs from the torch "
                             "reference")
    return g


def groupby_data(n: int, seed: int = 1):
    dev = timing.require_cuda()
    rng = np.random.default_rng(seed)
    keys = (rng.integers(0, 2**32, n, dtype=np.uint32) % 10007).astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    return torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev)


def measure_groupby(n: int = 1 << 26, cfg: SortConfig | None = None) -> dict:
    keys, vals = groupby_data(n)
    g = _check_groups(*groupby(keys, vals, "sum", cfg), keys, vals)
    t = timing.time_cuda(lambda: groupby(keys, vals, "sum", cfg), iters=3,
                         repeats=5)
    return _row(f"groupby_sum_rows_per_s_{_name(n)}", n, t, groups=g)


def measure_filter(n: int = 1 << 26, cfg: SortConfig | None = None) -> dict:
    dev = timing.require_cuda()
    vals = torch.from_numpy(
        np.random.default_rng(2).integers(0, 2**32, n, dtype=np.uint32)).to(dev)
    mask = vals.view(torch.int32) & 1
    (out,), count = filter_columns(mask, [vals], cfg)
    want = vals.view(torch.int32)[mask != 0]
    if int(count) != want.numel() or not torch.equal(
            out[: want.numel()].view(torch.int32), want):
        raise AssertionError("filter differs from boolean indexing")
    t = timing.time_cuda(lambda: filter_columns(mask, [vals], cfg), iters=10,
                         repeats=5)
    return _row(f"filter_rows_per_s_{_name(n)}", n, t, kept=want.numel())


def query_data(n: int, seed: int = 3):
    """The config-3 table: key uniform in [0, 2^20) (about 1M groups),
    value < 2^11, predicate uniform uint32."""
    dev = timing.require_cuda()
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 1 << 20, n, dtype=np.uint32),
            rng.integers(0, 1 << 11, n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint32)]
    return [torch.from_numpy(c).to(dev) for c in cols]


def run_query(key, value, pred, agg="sum", cfg=None):
    """filter_columns(pred < 2^31, [key, value]) then groupby of the kept
    rows; returns (kept key, kept value, groupby result)."""
    mask = pred.view(torch.int32) >= 0  # pred < 2^31
    (fk, fv), count = filter_columns(mask, [key, value], cfg)
    c = int(count)
    return fk[:c], fv[:c], groupby(fk[:c], fv[:c], agg, cfg)


def measure_query(n: int = 1 << 28, cfg: SortConfig | None = None) -> dict:
    key, value, pred = query_data(n)
    fk, fv, res = run_query(key, value, pred, cfg=cfg)
    g = _check_groups(*res, fk, fv)
    del fk, fv, res
    t = timing.time_cuda(lambda: run_query(key, value, pred, cfg=cfg), iters=2,
                         repeats=3, warmup=1)
    return _row(f"query_filter_groupby_rows_per_s_{_name(n)}", n, t, groups=g)


def _layer(name: str) -> str:
    if "chunk_sort" in name or "cross_stage" in name or "finish" in name:
        return "rider_sort"
    for layer in ("segscan", "compact"):
        if layer in name:
            return layer
    return "elementwise"


def profile_groupby(n: int = 1 << 26, calls: int = 5) -> dict:
    """``groupby`` sum by layer: rider sort, segscan, compact, elementwise."""
    keys, vals = groupby_data(n)
    return _profile(lambda: groupby(keys, vals, "sum"), calls, _layer,
                    f"groupby sum n={n}, ms of device time per call")


# --- slice 3: stable pairs (config 2), join (config 4), the dense query
# (config 3 at its own size) -----------------------------------------------


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device=timing.require_cuda()).manual_seed(seed)


def _randint(lo, hi, n, gen):
    """n int32 values in [lo, hi) made on the card (lo >= -2^31, hi <=
    2^31)."""
    return torch.randint(lo, hi, (n,), dtype=torch.int32, generator=gen,
                         device=gen.device)


def pairs_data(n: int, seed: int = 7):
    """Config 2: n uint32 keys below 2^24 (ties everywhere) and uint32
    payloads, made on the card."""
    g = _generator(seed)
    keys = _randint(0, 1 << 24, n, g).view(torch.uint32)
    return keys, _randint(-(2**31), 2**31, n, g).view(torch.uint32)


def torch_sort_pairs(keys, payload):
    """Plain reference: ``torch.sort(stable=True)`` of sign-biased keys, the
    payload gathered through its indices."""
    order = torch.sort(keys.view(torch.int32) ^ _SIGN, stable=True)
    return ((order.values ^ _SIGN).view(torch.uint32),
            payload.view(torch.int32)[order.indices].view(payload.dtype))


def measure_sort_pairs(n: int = 1 << 28, cfg: SortConfig | None = None) -> dict:
    keys, payload = pairs_data(n)
    got, want = sort_pairs(keys, payload, cfg), torch_sort_pairs(keys, payload)
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want)):
        raise AssertionError("sort_pairs differs from torch.sort(stable=True)")
    del got, want
    t = timing.time_cuda(lambda: sort_pairs(keys, payload, cfg), iters=2,
                         repeats=3, warmup=1)
    return _row(f"sort_pairs_u32_pairs_per_s_{_name(n)}", n, t,
                unit="pairs/s")


_MIX = 2654435761  # odd: i -> (i * _MIX + _OFF) mod 2^32 is a bijection
_OFF = 0x9E3779B9


def _distinct_u32(start: int, n: int, device) -> torch.Tensor:
    """The images of start .. start+n-1 under a bijection of Z/2^32:
    distinct uint32 keys in a scrambled order."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    x = (i * _MIX + _OFF) & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32).view(
        torch.uint32)


def join_data(nb: int, np_: int, seed: int = 11, hit: float = 0.9):
    """Config 4: nb distinct uint32 build keys with uint32 values; np_ probe
    keys, a share ``hit`` of them drawn from the build keys (with
    repetition) and the rest absent from the build side, in random order,
    with uint32 values.  Made on the card."""
    g = _generator(seed)
    dev = g.device
    bk = _distinct_u32(0, nb, dev)
    bv = _randint(-(2**31), 2**31, nb, g).view(torch.uint32)
    n_hit = int(np_ * hit)
    drawn = bk.view(torch.int32)[torch.randint(0, nb, (n_hit,), generator=g,
                                               device=dev)]
    absent = _distinct_u32(nb, np_ - n_hit, dev).view(torch.int32)
    pk = torch.cat((drawn, absent))[torch.randperm(np_, generator=g,
                                                   device=dev)]
    pv = _randint(-(2**31), 2**31, np_, g).view(torch.uint32)
    return bk, bv, pk.view(torch.uint32), pv


def torch_join_ref(bk, bv, pk, pv, how="inner", missing_bits=0):
    """Plain reference of ``join_merge`` with distinct build keys: a stable
    sort of the build side, ``torch.searchsorted``, a gather; rows in key
    order (probe order within a key).  Returns int32 (keys, build values,
    probe values)."""
    i32 = torch.int32
    bs = torch.sort(bk.view(i32) ^ _SIGN, stable=True)
    pb = pk.view(i32) ^ _SIGN
    po = torch.sort(pb, stable=True).indices
    pb = pb[po]
    pos = torch.searchsorted(bs.values, pb).clamp(max=bk.numel() - 1)
    hit = bs.values[pos] == pb
    b = bv.view(i32)[bs.indices[pos]]
    k, p = pb ^ _SIGN, pv.view(i32)[po]
    if how == "left":
        return k, torch.where(hit, b, missing_bits), p
    return k[hit], b[hit], p[hit]


def check_join(table, on, value, other_value, want):
    got = [table.column(c).view(torch.int32) for c in (on, other_value, value)]
    if not all(a.shape == b.shape and torch.equal(a, b)
               for a, b in zip(got, want)):
        raise AssertionError("join differs from the torch reference")


def _join_tables(n: int):
    from radx_tpu_torch.ops.table import Table

    bk, bv, pk, pv = join_data(n, n)
    return Table({"k": bk, "w": bv}), Table({"k": pk, "v": pv})


def measure_join(n: int = 10**8, cfg: SortConfig | None = None) -> dict:
    """``Table.join`` of two n-row tables (inner); rows/s counts the input
    rows of both sides."""
    build, probe = _join_tables(n)
    want = torch_join_ref(build.column("k"), build.column("w"),
                          probe.column("k"), probe.column("v"))
    check_join(probe.join(build, "k", "v", "w", cfg=cfg), "k", "v", "w", want)
    del want
    t = timing.time_cuda(lambda: probe.join(build, "k", "v", "w", cfg=cfg),
                         iters=2, repeats=3, warmup=1)
    return _row(f"join_rows_per_s_{_name(n)}", 2 * n, t)


def query_dense_data(n: int, seed: int = 13):
    """Config 3 at its own size: uniform uint32 key, value < 2^11, uniform
    uint32 predicate, bucket = key >> 24; the table holds (bucket, value,
    pred).  Made on the card."""
    from radx_tpu_torch.ops.table import Table

    g = _generator(seed)
    key = _randint(-(2**31), 2**31, n, g)
    bucket = ((key >> 24) & 0xFF).view(torch.uint32)
    del key
    value = _randint(0, 1 << 11, n, g).view(torch.uint32)
    pred = _randint(-(2**31), 2**31, n, g).view(torch.uint32)
    return Table({"bucket": bucket, "value": value, "pred": pred})


def run_query_dense(table, agg="sum", cfg=None, lazy=None):
    """``filter(pred < 2^31)`` then ``groupby(bucket, value, agg, bins=
    256)`` through LazyTable (one host sync, in ``collect``)."""
    lt = lazy if lazy is not None else table.lazy(cfg)
    kept = lt.filter(lt.column("pred").view(torch.int32) >= 0)
    return kept.groupby("bucket", "value", agg, bins=256).collect()


def query_dense_ref(table, slab: int = 1 << 27):
    """Plain reference of the dense query, in slabs: (counts, sums, mins,
    maxs) per bucket as int64."""
    dev = table.device
    counts = torch.zeros(257, dtype=torch.int64, device=dev)
    sums = torch.zeros(257, dtype=torch.int64, device=dev)
    mins = torch.full((257,), 1 << 40, dtype=torch.int64, device=dev)
    maxs = torch.full((257,), -1, dtype=torch.int64, device=dev)
    for s in range(0, table.num_rows, slab):
        keep = table.column("pred")[s: s + slab].view(torch.int32) >= 0
        b = torch.where(keep, table.column("bucket")[s: s + slab].view(
            torch.int32), 256).long()
        v = table.column("value")[s: s + slab].view(torch.int32).long()
        counts.index_add_(0, b, torch.ones_like(b))
        sums.index_add_(0, b, v)
        mins.scatter_reduce_(0, b, v, "amin")
        maxs.scatter_reduce_(0, b, v, "amax")
    return counts[:256], sums[:256] & 0xFFFFFFFF, mins[:256], maxs[:256]


def check_query_dense(result, ref, agg):
    """Hold a collected dense-query Table against ``query_dense_ref``."""
    counts, sums, mins, maxs = ref
    present = (counts > 0).nonzero().flatten()
    want = {"count": counts, "sum": sums, "min": mins, "max": maxs}[agg][present]
    got_k = result.column("bucket").view(torch.int32).long()
    got = result.column(agg).view(torch.int32).long()
    if agg != "count":
        got &= 0xFFFFFFFF
    if not (torch.equal(got_k, present) and torch.equal(got, want)):
        raise AssertionError(f"dense query ({agg}) differs from the torch "
                             "reference")
    return present.numel()


def measure_query_dense(n: int = 1 << 30, cfg: SortConfig | None = None,
                        table=None) -> dict:
    table = table if table is not None else query_dense_data(n)
    g = check_query_dense(run_query_dense(table, "sum", cfg),
                          query_dense_ref(table), "sum")
    t = timing.time_cuda(lambda: run_query_dense(table, "sum", cfg), iters=2,
                         repeats=3, warmup=1)
    return _row(f"query_filter_groupby_dense_rows_per_s_{_name(n)}", n, t,
                groups=g)


def query_chunked_data(n: int, seed: int = 13):
    """The dense query's table (``query_dense_data``) in host memory, as
    the streaming operators take it: (bucket, value, pred) numpy columns,
    and the plain answer built in slabs on the card (``query_dense_ref``).
    Nothing of it stays on the card."""
    table = query_dense_data(n, seed)
    ref = query_dense_ref(table)
    cols = tuple(table.column(c).cpu().numpy()
                 for c in ("bucket", "value", "pred"))
    del table
    torch.cuda.empty_cache()
    return cols, ref


def run_query_chunked(bucket, value, pred, slab: int = chunked.SLAB,
                      cfg=None, phase_ms: dict | None = None):
    """Config 3 eager on host columns: ``filter_chunked(pred < 2^31,
    [bucket, value])`` then ``groupby_chunked`` sum by bucket; returns
    (kept row count, (keys, sums, num_groups)).  ``phase_ms``, where
    given, gets the host-clock ms of the mask, ``filter_chunked`` and
    ``groupby_chunked`` (each ends with its outputs in host memory)."""
    t0 = time.perf_counter()
    mask = pred.view(np.int32) >= 0  # pred < 2^31
    t1 = time.perf_counter()
    (kb, kv), count = chunked.filter_chunked(mask, [bucket, value], cfg, slab)
    t2 = time.perf_counter()
    out = chunked.groupby_chunked(kb, kv, "sum", cfg, slab)
    if phase_ms is not None:
        phase_ms.update(mask=(t1 - t0) * 1e3, filter_chunked=(t2 - t1) * 1e3,
                        groupby_chunked=(time.perf_counter() - t2) * 1e3)
    return count, out


def check_query_chunked(count, result, ref):
    """Hold ``run_query_chunked``'s answer against ``query_dense_ref``;
    returns the group count."""
    counts, sums = ref[0].cpu().numpy(), ref[1].cpu().numpy()
    uk, out, ng = result
    present = np.flatnonzero(counts)
    if not (count == int(counts.sum()) and ng == present.size
            and np.array_equal(uk.astype(np.int64), present)
            and np.array_equal(out.astype(np.int64), sums[present])):
        raise AssertionError("the chunked query differs from the torch "
                             "reference")
    return ng


def measure_query_chunked(n: int = 1 << 30, slab: int = chunked.SLAB,
                          cfg: SortConfig | None = None, data=None) -> dict:
    """``query_filter_groupby_chunked_rows_per_s_n2e30``: config 3 eager
    from host memory (the mask on the host, the slabs to the card and the
    results back included), one run by the host clock after a warm-up run,
    with its peak device memory and the slab."""
    (bucket, value, pred), ref = data or query_chunked_data(n)
    res = run_query_chunked(bucket, value, pred, slab, cfg)
    g = check_query_chunked(*res, ref)
    del res
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_query_chunked(bucket, value, pred, slab, cfg)
    torch.cuda.synchronize()
    t = timing.Timing([time.perf_counter() - t0])
    return _row(f"query_filter_groupby_chunked_rows_per_s_{_name(n)}", n, t,
                groups=g, slab=slab,
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


def _tile_pairs(chunks, finish_max):
    """(chunk, finish) exponents: every chunk with every finish >= it and
    >= 2^13 up to ``finish_max``."""
    return [(c, f) for c in chunks for f in range(max(c, 13), finish_max + 1)]


SWEEP_GROUPS = ("keys", "rider", "lex")  # ``sweep``: the PR 5 sweep


def sweep_tiles(n: int = 1 << 26, groups=SWEEP_GROUPS):
    """The tiles of the network at n rows, one row each, every result first
    gated on a torch reference.  ``groups``:

      * ``keys``: ``sort`` on permutation keys, chunk 2^12..2^15 x finish
        2^13..2^15;
      * ``radix``: the same tiles under ``strategy="radix"`` (its chunk
        grows from ``chunk_elems``; its phases run on the mode's tiles),
        gated on the overflow flag too;
      * ``rider``: ``groupby`` sum (rider tiles, up to 2^14: two planes of
        2^15 exceed a block's shared memory);
      * ``lex``: the lexicographic tiles (``stable_*``, stated at two and
        three planes, up to 2^14): ``argsort`` (lex2), ``sort_pairs``
        (lex2 and the payload's gather) and the join's tagged union (lex2
        and the value planes' gather, n/2 rows a side);
      * ``lex_wide``: the same tiles under ``sort_multi`` with 3..6
        payloads (lex2 and the payloads' gathers);
      * ``topk``: ``top_k`` (k = 1024, largest) over topk_chunk_elems
        2^11..2^14 on uniform keys.

    ``radx_tpu_torch/tools/autotune.py`` runs every group and picks the
    tiles; ``python -m radx_tpu_torch.bench sweep`` the first three."""
    from radx_tpu_torch.ops import join as join_ops
    from radx_tpu_torch.ops.sort import _encode_keys, sort_multi
    from radx_tpu_torch.ops.topk import top_k

    dev = timing.require_cuda()
    rows = []

    def run(metric, fn, check, **tiles):
        check()
        t = timing.time_cuda(fn, iters=3, repeats=3)
        rows.append(_row(f"{metric}_{_name(n)}", n, t, **tiles))

    if "keys" in groups or "radix" in groups:
        keys = torch.from_numpy(permutation_keys(n)).to(dev)
        want = torch_sort_u32(keys).view(torch.int32)

        def check_sort(cfg):
            msd.reset_counts()
            if not torch.equal(sort(keys, cfg).view(torch.int32), want):
                raise AssertionError("sort differs from torch.sort")
            if cfg.strategy == "radix" and not (
                    msd.LAUNCHES["radix_rank"] == msd.LAUNCHES[K13] == 1):
                raise AssertionError("the radix sort overflowed")

        for strategy in [g for g in ("keys", "radix") if g in groups]:
            name = "sort_radix" if strategy == "radix" else "sort"
            for c, f in _tile_pairs((12, 13, 14, 15), 15):
                cfg = SortConfig(chunk_elems=1 << c, finish_elems=1 << f,
                                 strategy="radix" if strategy == "radix"
                                 else "bitonic")
                run(f"{name}_u32_keys_per_s", lambda: sort(keys, cfg),
                    lambda: check_sort(cfg), chunk_elems=1 << c,
                    finish_elems=1 << f)
        del keys, want
    if "rider" in groups:
        gk, gv = groupby_data(n)
        for c, f in _tile_pairs((12, 13, 14), 14):
            cfg = SortConfig(rider_chunk_elems=1 << c,
                             rider_finish_elems=1 << f)
            run("groupby_sum_rows_per_s", lambda: groupby(gk, gv, "sum", cfg),
                lambda: _check_groups(*groupby(gk, gv, "sum", cfg), gk, gv),
                rider_chunk_elems=1 << c, rider_finish_elems=1 << f)
        del gk, gv
    if "lex" in groups or "lex_wide" in groups:
        keys, payload = pairs_data(n)
        order = torch.sort(keys.view(torch.int32), stable=True).indices
        want = torch_sort_pairs(keys, payload)[1].view(torch.int32)
        bk, bv, pk, pv = join_data(n // 2, n // 2)
        pays = ([_randint(-(2**31), 2**31, n, _generator(29))
                 for _ in range(6)] if "lex_wide" in groups else [])
        for c, f in _tile_pairs((12, 13, 14), 14):
            cfg = SortConfig(stable_chunk_elems=1 << c,
                             stable_finish_elems=1 << f)
            tiles = {"stable_chunk_elems": 1 << c,
                     "stable_finish_elems": 1 << f}

            def check_argsort():
                if not torch.equal(argsort(keys, cfg).long(), order):
                    raise AssertionError("argsort differs from torch.sort")

            def check_pairs():
                got = sort_pairs(keys, payload, cfg)[1].view(torch.int32)
                if not torch.equal(got, want):
                    raise AssertionError("sort_pairs differs from torch.sort")

            def check_multi(m):
                _, got = sort_multi(keys, pays[:m], cfg)
                if not all(torch.equal(g, p[order])
                           for g, p in zip(got, pays)):
                    raise AssertionError(f"sort_multi ({m} payloads) differs "
                                         "from torch.sort")

            def union():
                return join_ops.tagged_union(_encode_keys(bk), bv,
                                             _encode_keys(pk), pv, cfg)

            if "lex" in groups:
                run("argsort_rows_per_s", lambda: argsort(keys, cfg),
                    check_argsort, **tiles)
                run("sort_pairs_u32_pairs_per_s",
                    lambda: sort_pairs(keys, payload, cfg), check_pairs,
                    **tiles)
                run("join_union_sort_rows_per_s", union, lambda: None,
                    **tiles)
            for m in range(3, 7) if "lex_wide" in groups else ():
                run(f"sort_multi_{m}_payloads_rows_per_s",
                    lambda m=m: sort_multi(keys, pays[:m], cfg),
                    lambda m=m: check_multi(m), payloads=m, **tiles)
        del keys, payload, order, want, bk, bv, pk, pv, pays
    if "topk" in groups:
        keys = _randint(-(2**31), 2**31, n, _generator(31)).view(torch.uint32)
        order = torch.sort(keys.view(torch.int32) ^ _SIGN, descending=True,
                           stable=True).indices[:1024]
        for c in range(11, 15):
            cfg = SortConfig(topk_chunk_elems=1 << c)

            def check_topk():
                if not torch.equal(top_k(keys, 1024, True, cfg)[1].long(),
                                   order):
                    raise AssertionError("top_k differs from torch.sort")

            run("top_k_k1024_keys_per_s", lambda: top_k(keys, 1024, True, cfg),
                check_topk, topk_chunk_elems=1 << c)
    return rows


def compact_bytes(mask, planes) -> int:
    """Bytes a compaction of ``planes`` by ``mask`` must move: the mask
    read once, in each plane the 32-byte sectors that hold a kept row
    read, and the kept rows written.  Where few rows are kept (the
    group-by's run ends), most of a plane is never read."""
    keep = mask != 0
    n = keep.numel()
    total = mask.element_size() * n + 4 * len(planes) * int(keep.sum())
    for p in planes:
        lead = p.data_ptr() % 32 // 4  # rows of p's first sector before it
        rows = torch.zeros(-(-(lead + n) // 8) * 8, dtype=torch.bool,
                           device=keep.device)
        rows[lead: lead + n] = keep
        total += min(32 * int(rows.view(-1, 8).any(1).sum()), 4 * n)
    return total


def sweep_single_pass(n: int = 1 << 26) -> list[dict]:
    """The single-pass kernels at n rows, one row each, every result first
    held against its plain version: ``compact`` (its one tile) on the
    filter's shape (int32 mask of density 0.5, one plane: the staged
    writes), on the group-by's (the bool run ends of 10007 sorted groups,
    two planes: the direct writes) and on the lazy filter's (bool mask of
    density 0.5, three planes), and ``segscan`` over tiles 2^9..2^13 on the
    group-by's uint32 sum.  ``bound_ms``: the bytes the call must move
    (``compact_bytes``; the scan reads keys and values and writes the
    output once) over 3.35 TB/s."""
    g = _generator(19)
    col = _randint(-(2**31), 2**31, n, g)
    skeys = torch.sort(_randint(0, 10007, n, g)).values
    last = torch.ones(n, dtype=torch.bool, device=col.device)
    torch.ne(skeys[1:], skeys[:-1], out=last[:-1])
    half = _randint(0, 2, n, g)
    shapes = {"filter_int32_mask": (half, [col]),
              "groupby_run_ends": (last, [skeys, col]),
              "lazy_filter_3_planes": (half != 0, [col, skeys, half])}
    rows = []

    def row(kernel, case, fn, bytes_, **tile):
        t = timing.time_cuda(fn, iters=10, repeats=5)
        rows.append({"kernel": kernel, "case": case, "n": n, **tile,
                     "ms": t.seconds * 1e3, "spread_pct": t.spread_pct,
                     "bound_ms": bytes_ / 3.35e9,
                     "device": timing.device_info()})

    for case, (mask, planes) in shapes.items():
        want, wcount = compact.compact_ref(mask, planes)
        kept = int(wcount)
        outs, count = compact.compact(mask, planes, compact.TILE)
        if int(count) != kept or not all(torch.equal(o[:kept], w[:kept])
                                         for o, w in zip(outs, want)):
            raise AssertionError(f"compact differs ({case})")
        row("compact", case, lambda: compact.compact(mask, planes,
                                                     compact.TILE),
            compact_bytes(mask, planes), tile=compact.TILE)
    kp = skeys.view(torch.int32)
    want = segscan.segscan_ref(kp, col, "sum", torch.uint32)
    for log_t in range(9, 14):
        if not torch.equal(segscan.segscan_planes(kp, col, "sum", torch.uint32,
                                                  1 << log_t), want):
            raise AssertionError(f"segscan differs (tile 2^{log_t})")
        row("segscan", "groupby_u32_sum", lambda t=1 << log_t:
            segscan.segscan_planes(kp, col, "sum", torch.uint32, t), 12 * n,
            tile=1 << log_t)
    return rows


def _profile(fn, calls: int, layer_of, what: str, split=None) -> dict:
    """Device time per call by layer (torch.profiler) and the device's idle
    share of the profiled wall time; ``split(device_ops, calls, layer_of,
    wall_ms)``, where given, adds its fields (the idle share by phase)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    layers: dict[str, float] = {}
    kernels: dict[str, float] = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[ev.key] = dev_us / 1e3 / calls
        layer = layer_of(ev.key)
        layers[layer] = layers.get(layer, 0.0) + dev_us / 1e3 / calls
    busy = sum(layers.values())
    extra = {} if split is None else split(_device_ops(prof), calls, layer_of,
                                           wall * 1e3)
    return {"what": what, "layers_ms": layers, "busy_ms": busy,
            "wall_ms_per_call": wall * 1e3 / calls,
            "idle_pct": 100.0 * (1 - busy / (wall * 1e3 / calls)),
            "top_kernels_ms": dict(sorted(kernels.items(),
                                          key=lambda kv: -kv[1])[:12]),
            **extra, "device": timing.device_info()}


def _device_ops(prof) -> list[tuple[float, float, str]]:
    """(start µs, end µs, name) of every operation the device ran in a
    profile (kernels, copies, memsets), in the order they started."""
    return sorted((ev.time_range.start, ev.time_range.end, ev.name)
                  for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)


def radix_idle_split(ops, calls, layer_of, wall_ms) -> dict:
    """Where the device idles in ``calls`` back-to-back radix sorts.  Each
    sort is anchored on its K10 ``radix_hist`` launch (the first operation
    after phase 1), its flag read (the device-to-host copy after it) and
    its K13 ``radix_concat`` launch followed by as many operations as
    follow the last sort's (the unbias); a dropped profiler event moves no
    anchor.  Each gap between two operations is charged by the one after
    it: ``between_calls`` (the first of a sort), ``phase1`` (up to K10),
    ``before_read`` (from K10 to the read: host enqueue slower than the
    tiny kernels), ``at_read`` (the first operation after the read: the
    host's wait and its first enqueue after it) or ``phase_c`` (the rest);
    ``edges`` is the wall time before the first and after the last
    operation.  ms per sort, and % of the wall time.  ``ops_per_sort``:
    device operations (launches, copies, memsets) per sort;
    ``ops_before_read``: those of the first sort from K10 up to the read,
    also by layer."""
    names = [name for _, _, name in ops]
    hist = [i for i, m in enumerate(names) if "radix_hist" in m]
    concat = [i for i, m in enumerate(names) if "radix_concat" in m]
    read = [next((i for i in range(h, len(ops)) if "Memcpy DtoH" in names[i]),
                 None) for h in hist]
    if not (len(hist) == len(concat) == calls) or None in read:
        return {"idle_split": None, "idle_split_reason":
                f"{len(hist)} K10, {len(concat)} K13 launches, {calls} sorts"}
    tail = len(ops) - 1 - concat[-1]
    first = [0] + [c + tail + 1 for c in concat[:-1]]
    phase = [""] * len(ops)
    for k in range(calls):
        end = concat[k] + tail
        for i in range(first[k], end + 1):
            phase[i] = ("between_calls" if i == first[k] else
                        "phase1" if i <= hist[k] else
                        "before_read" if i <= read[k] else
                        "at_read" if i == read[k] + 1 else "phase_c")
    gaps = dict.fromkeys(("phase1", "before_read", "at_read", "phase_c",
                          "between_calls"), 0.0)
    end = ops[0][1]
    for i in range(1, len(ops)):
        gaps[phase[i]] += max(0.0, ops[i][0] - end) / 1e3
        end = max(end, ops[i][1])
    busy = sum(e - s for s, e, _ in ops) / 1e3
    gaps["edges"] = wall_ms - busy - sum(gaps.values())
    before = {}
    for m in names[hist[0]: read[0]]:
        before[layer_of(m)] = before.get(layer_of(m), 0) + 1
    return {"idle_split_ms": {k: v / calls for k, v in gaps.items()},
            "idle_split_pct": {k: 100.0 * v / wall_ms for k, v in gaps.items()},
            "ops_per_sort": len(ops) / calls, "ops_before_read": read[0] - hist[0],
            "ops_before_read_by_layer": before}


def profile_join(n: int = 10**8, calls: int = 2) -> dict:
    """``Table.join`` (inner) of two n-row tables by layer: the (key, tie)
    lexicographic sort, the value planes' gather, segscan, compact,
    elementwise (union assembly, masks, copies)."""
    build, probe = _join_tables(n)

    def layer_of(name):
        if re.search(r"gather_(planes|count|scan|part|place)_kernel", name):
            return "gather"
        return "lex_sort" if _layer(name) == "rider_sort" else _layer(name)

    return _profile(lambda: probe.join(build, "k", "v", "w"), calls, layer_of,
                    f"Table.join inner n={n} x {n}, ms of device time per call")


def _dense_layer(name: str) -> str:
    if "dense_" in name:
        return "dense"
    return "compact" if "compact" in name else "elementwise"


def profile_query_dense(n: int = 1 << 30, calls: int = 2, table=None) -> dict:
    """The config-3 dense query through LazyTable (``run_query_dense``, sum)
    by layer: compact (the filter and the compaction of the bins), dense
    (K8 / K9), elementwise (masks, validity, the lazy count)."""
    table = table if table is not None else query_dense_data(n)
    return _profile(lambda: run_query_dense(table, "sum"), calls, _dense_layer,
                    f"dense query (LazyTable) n={table.num_rows}, ms of "
                    "device time per call")


def _sort_layer(name: str) -> str:
    for layer in ("finish", "chunk_sort", "cross_stage"):
        if layer in name:
            return layer
    return "elementwise"


def profile_sort(n: int = 1 << 26, calls: int = 5) -> dict:
    """Keys-only ``sort`` of n permutation keys by kernel: finish,
    chunk_sort, cross_stage, elementwise (bias, pads, unbias), and the
    device's idle share."""
    keys = torch.from_numpy(permutation_keys(n)).to(timing.require_cuda())
    return _profile(lambda: sort(keys), calls, _sort_layer,
                    f"sort n={n}, ms of device time per call")


def rank_inputs(n: int = 1 << 26):
    """The arguments K11 ``radix_rank`` gets in a radix sort of n
    permutation keys at the default radix geometry
    (``radix_sort.rank_args``)."""
    cfg = RADIX
    p = radix_sort.plan(n, radix_sort.pick_chunk(n, cfg.chunk_elems))
    keys = torch.from_numpy(permutation_keys(n)).to(timing.require_cuda())
    keys = keys.view(torch.int32) ^ _SIGN
    sorted_ = bitonic.sort_chunks_ascending_cyclic([keys], 1, p.C,
                                                   *cfg.mode_tiles(1, 1))[0]
    return radix_sort.rank_args(sorted_, keys, p, n, cfg.mode_tiles(1, 1),
                                False)


def rank_runs_library(keys, heads, samples, totals, p, n_valid, pads, tail):
    """What K11 replaces, with the ranks from ``torch.searchsorted``: the
    splitter clamp, the ranks and ``run_bounds`` (its library call)."""
    n_keys = n_valid if pads is None else n_valid - pads
    spl = radix_sort.clamp_splitters(samples, totals, p, n_keys)
    if tail:
        spl = torch.cat((spl, spl.new_full((1,), msd._PAD)))
    ranks = torch.searchsorted(keys.view(p.n_chunks, p.C),
                               spl.expand(p.n_chunks, spl.numel()).contiguous())
    return radix_sort.run_bounds(ranks, p, n_valid, tail)


def rank_bytes(p, tail: bool = False) -> tuple[int, int]:
    """(bytes, 32-bit operations) that K11 must move and do at plan p: the
    256 totals and the m sampled splitters read, one 32-byte sector a
    (chunk, splitter) (the one that holds its rank's boundary), the
    splitters, bounds rows, flag and segment tables written; a binary
    search's compares a (chunk, splitter)."""
    m = p.nb - 1 + tail
    n_seg = p.nb_pad + (p.n_chunks if tail else 0)
    read = 4 * 256 + 4 * m + 32 * p.n_chunks * m
    written = 4 * m + 4 * p.n_chunks * (p.nb_pad + 1) + 4 + 8 * (2 * n_seg + 1)
    return read + written, p.n_chunks * m * (p.C.bit_length() - 1)


def _device_ops_per_call(fn, calls: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return len(_device_ops(prof)) / calls


def measure_launch(n: int = 1 << 26, launches: int = 200) -> dict:
    """K11 ``radix_rank`` (``radix_sort.rank_runs``: splitters, ranks, run
    bounds, overflow flag and segment tables) on a radix sort's own inputs
    at n keys (2^26: 128 sorted chunks of 2^19 keys, 160 splitters): host
    microseconds per call (the enqueue, no synchronisation), CUDA-events
    time per call and the profiler's device time of the kernel, with the
    device operations per call; beside it the composition it replaces on the
    card (``rank_runs_library``: the clamp, ``torch.searchsorted``,
    ``run_bounds``) and ``torch.searchsorted`` alone."""
    args = rank_inputs(n)
    got, want = radix_sort.rank_runs(*args), radix_sort.rank_runs_ref(*args)
    if not all(torch.equal(getattr(got, f), getattr(want, f))
               for f in radix_sort.Ranked._fields):
        raise AssertionError("radix_rank differs from its plain version")
    lib = rank_runs_library(*args)
    if not all(torch.equal(a, b) for a, b in zip(
            (got.bounds, got.start, got.src),
            (lib.bounds, lib.start, lib.src))):
        raise AssertionError("radix_rank differs from the library composition")

    def call():
        return radix_sort.rank_runs(*args)

    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            call()
        host.append((time.perf_counter() - t0) / launches)
        torch.cuda.synchronize()
    events = timing.time_cuda(call, iters=launches, repeats=5)
    prof = _profile(call, launches, lambda name: "radix_rank"
                    if "radix_rank" in name else "other", "radix_rank")
    keys, p = args[0], args[4]
    view = keys.view(p.n_chunks, p.C)
    spl = got.splitters.expand(p.n_chunks, got.splitters.numel()).contiguous()
    composition = timing.time_cuda(lambda: rank_runs_library(*args),
                                   iters=20, repeats=5)
    search = timing.time_cuda(lambda: torch.searchsorted(view, spl),
                              iters=launches, repeats=5)
    return {"what": f"radix_rank (rank_runs) at the radix geometry of {n} "
                    f"keys ({p.n_chunks} chunks of {p.C}, {p.nb - 1} "
                    "splitters)",
            "host_us_per_launch": min(host) * 1e6,
            "events_ms": events.seconds * 1e3,
            "device_ms": prof["layers_ms"].get("radix_rank", 0.0),
            "other_device_ms": prof["layers_ms"].get("other", 0.0),
            "device_ops_per_call": _device_ops_per_call(call),
            "composition_ms": composition.seconds * 1e3,
            "composition_device_ops_per_call":
                _device_ops_per_call(lambda: rank_runs_library(*args)),
            "searchsorted_ms": search.seconds * 1e3,
            "device": timing.device_info()}


# --- slice 4: strategy="radix" ---------------------------------------------


def hist_inputs(n: int, seed: int = 23) -> dict:
    """The digit-histogram inputs: uniform keys, all-equal keys and two
    distinct keys (every byte of the two differs) in random order."""
    g = _generator(seed)
    two = torch.tensor([0x11223344, -0x11223345], dtype=torch.int32,
                       device=timing.require_cuda())
    return {"uniform": _randint(-(2**31), 2**31, n, g),
            "all_equal": torch.full((n,), 0x12345678, dtype=torch.int32,
                                    device=two.device),
            "two_keys": two[_randint(0, 2, n, g).long()]}


def sweep_hist(n: int = 1 << 26) -> list[dict]:
    """``radix_hist`` on each ``hist_inputs`` case at n keys, as K10 (the
    radix sort's 2^19-key chunks, top byte, sign bias, with the totals row)
    and as K14 (1024-key tiles, shift 8), every result first held against
    ``histograms_ref``.  ``bound_ms``: the keys read and the rows written
    once, over 3.35 TB/s."""
    from radx_tpu_torch.kernels import radix

    rows = []
    for case, x in hist_inputs(n).items():
        for name, tile, shift, bias, totals in (
                ("radix_hist", 1 << 19, 24, _SIGN, True),
                ("radix_hist/tile", radix.TILE, 8, 0, False)):
            def call():
                return radix.histograms(x, tile, shift, bias, name=name,
                                        totals=totals)

            if not torch.equal(call(), radix.histograms_ref(
                    x, tile, shift, bias, n, totals)):
                raise AssertionError(f"{name} differs on {case} keys")
            t = timing.time_cuda(call, iters=10, repeats=5)
            rows.append({"kernel": name, "case": case, "n": n, "tile": tile,
                         "ms": t.seconds * 1e3, "spread_pct": t.spread_pct,
                         "bound_ms": (4 * n + 1024 * (-(-n // tile) + totals))
                         / 3.35e9, "device": timing.device_info()})
    return rows


def gather_inputs(case: str, seed: int = 29):
    """(index, sources, mode) of ``gather_planes`` at the main path's
    shapes: ``"pairs"`` config 2's payload (a permutation of 2^28 rows, one
    source), ``"multi"`` four sources of 2^26 rows (``sort_multi``),
    ``"tagged"`` the join's union (2 x 10^8 shuffled build and probe ties,
    sources of 10^8).  Made on the card."""
    from radx_tpu_torch.kernels import gather

    g = _generator(seed)
    dev = g.device
    if case == "tagged":
        n = 10**8
        ties = torch.cat((torch.arange(n, device=dev),
                          torch.arange(n, device=dev) + gather.PROBE_TIE))
        idx = ties[torch.randperm(2 * n, generator=g, device=dev)]
        srcs = [_randint(-(2**31), 2**31, n, g) for _ in range(2)]
        return idx.to(torch.int32), srcs, "tagged"
    n, count = {"pairs": (1 << 28, 1), "multi": (1 << 26, 4)}[case]
    idx = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    return idx, [_randint(-(2**31), 2**31, n, g) for _ in range(count)], "index"


def gather_bytes(n: int, sources, mode: str) -> dict:
    """The gather's bound (the index read, each source row read once, the
    outputs written) and the partitioned route's own floor in sequential
    passes (one source of n rows: count 4 bytes a row, part 8, window 12,
    place 12; 24 more a row for each further source: place's index read,
    window's P read, source read and V write, place's V read and output
    write; tagged: one window, two outputs), bytes."""
    outs = 2 if mode == "tagged" else len(sources)
    src = sum(s.numel() for s in sources)
    planes = 1 if mode == "tagged" else len(sources)
    return {"bound": 4 * n + 4 * src + 4 * outs * n,
            "floor": 12 * n + 16 * planes * n + 4 * src + 4 * outs * n}


def sweep_gather(windows=(4, 8, 16, 32), tiles=(1 << 11, 1 << 12, 1 << 13),
                 cases=("pairs", "multi", "tagged")) -> list[dict]:
    """``gather_planes``'s partitioned route at windows of ``windows`` MiB
    of source and tiles of ``tiles`` index rows, on each ``gather_inputs``
    case, beside the direct route and ``index_select`` (index mode) at the
    same shapes; every result first held against ``gather_planes_ref``.
    ``bound_ms`` / ``floor_ms``: ``gather_bytes`` over 3.35 TB/s."""
    from radx_tpu_torch.kernels import gather

    rows = []
    for case in cases:
        idx, srcs, mode = gather_inputs(case)
        n = idx.numel()
        want = gather.gather_planes_ref(idx, srcs, mode)
        by = gather_bytes(n, srcs, mode)
        calls = {"direct": lambda: gather.direct(idx, srcs, mode)}
        if mode == "index":
            calls["index_select"] = lambda: [torch.index_select(s, 0, idx)
                                             for s in srcs]
        for w in windows:
            for t in tiles:
                calls[f"partitioned W={w}MiB T={t}"] = (
                    lambda w=w, t=t: gather.partitioned(
                        idx, srcs, mode, (w << 20) // 4, t))
        for route, call in calls.items():
            got = call()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"gather {route} differs on {case}")
            del got
            tm = timing.time_cuda(call, iters=5, repeats=3)
            rows.append({"kernel": "gather_planes", "case": case, "n": n,
                         "sources": len(srcs), "route": route,
                         "ms": tm.seconds * 1e3, "spread_pct": tm.spread_pct,
                         "bound_ms": by["bound"] / 3.35e9,
                         "floor_ms": by["floor"] / 3.35e9,
                         "device": timing.device_info()})
        del idx, srcs, want, calls
        torch.cuda.empty_cache()
    return rows


RADIX = SortConfig(strategy="radix")
# the last launch of a keys-only radix sort: K13 writing the keys unbiased
K13 = msd.unbias_kernel(1, 1)


def measure_radix(n: int, cfg: SortConfig = RADIX) -> dict:
    """``sort`` under strategy="radix" on n permutation keys, gated on
    torch.sort and on the overflow flag; the bitonic ``sort`` of the same
    keys timed in the same call."""
    dev = timing.require_cuda()
    keys = torch.from_numpy(permutation_keys(n)).to(dev)
    msd.reset_counts()
    if not torch.equal(sort(keys, cfg).view(torch.int32),
                       torch_sort_u32(keys).view(torch.int32)):
        raise AssertionError(f"radix sort of {n} keys differs from torch.sort")
    if not msd.LAUNCHES["radix_rank"] == msd.LAUNCHES[K13] == 1:
        raise AssertionError(f"radix overflow on {n} permutation keys")
    msd.reset_counts()
    t = timing.time_cuda(lambda: sort(keys, cfg), iters=3, repeats=5)
    if msd.LAUNCHES[K13] != msd.LAUNCHES["radix_rank"]:
        raise AssertionError("a timed radix sort fell back to the network")
    tb = timing.time_cuda(lambda: sort(keys), iters=3, repeats=5)
    return _row(f"sort_radix_u32_keys_per_s_{_name(n)}", n, t, unit="keys/s",
                overflow=False, bitonic_keys_per_s=n / tb.seconds,
                bitonic_ms=tb.seconds * 1e3,
                radix_over_bitonic=tb.seconds / t.seconds)


def _radix_layer(name: str) -> str:
    for layer in ("chunk_sort_cyclic", "slot_merge", "radix_hist", "radix_rank",
                  "radix_pack", "radix_concat", "cross_stage", "finish",
                  "chunk_sort"):
        if layer in name:
            return layer
    return "elementwise"


def profile_radix(n: int = 1 << 26, calls: int = 3) -> dict:
    """``sort`` under strategy="radix" by kernel: K4 (chunk_sort_cyclic),
    K5 (slot_merge), the span passes of both and the sample sort
    (cross_stage, finish, chunk_sort), K10-K13, elementwise; and where the
    device idles (``radix_idle_split``)."""
    keys = torch.from_numpy(permutation_keys(n)).to(timing.require_cuda())
    return _profile(lambda: sort(keys, RADIX), calls, _radix_layer,
                    f"sort strategy=radix n={n}, ms of device time per call",
                    radix_idle_split)


MIB = 1 << 20


def _best_seconds(fn, repeats: int = 3) -> float:
    """Least host seconds of ``fn()`` over ``repeats`` runs, the card
    synchronised before and after each."""
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _pinned_alloc_ms(sizes=(64 * MIB, 256 * MIB, 1024 * MIB)) -> dict:
    """ms of ``torch.empty(size, pin_memory=True)``: the first allocation
    of each size, then a second one after the first was freed (PyTorch's
    caching host allocator keeps freed pinned blocks)."""
    out = {}
    for size in sizes:
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            times.append((time.perf_counter() - t0) * 1e3)
            if not buf.is_pinned():
                raise RuntimeError("torch.empty(pin_memory=True) is not pinned")
            del buf
        out[f"{size // MIB}MiB"] = {"first_ms": times[0], "second_ms": times[1]}
    return out


def _register_ms_per_gib(host: np.ndarray, dev) -> dict:
    """``cudaHostRegister`` / ``cudaHostUnregister`` of an existing numpy
    array (ms a GiB), and the card's copy rate from it while registered."""
    cudart = torch.cuda.cudart()
    gib = host.nbytes / (1 << 30)
    ptr = host.ctypes.data
    t0 = time.perf_counter()
    torch.cuda.check_error(cudart.cudaHostRegister(ptr, host.nbytes, 0))
    t1 = time.perf_counter()
    try:
        src = torch.from_numpy(host)
        pinned = src.is_pinned()
        to_card = host.nbytes / _best_seconds(
            lambda: src.to(dev, non_blocking=True)) / 1e9
    finally:
        t2 = time.perf_counter()
        torch.cuda.check_error(cudart.cudaHostUnregister(ptr))
        t3 = time.perf_counter()
    return {"register_ms_per_gib": (t1 - t0) * 1e3 / gib,
            "unregister_ms_per_gib": (t3 - t2) * 1e3 / gib,
            "is_pinned_while_registered": pinned,
            "registered_to_card_gb_per_s": to_card}


def _memcpy_rates(host: np.ndarray, pinned: torch.Tensor,
                  threads=(1, 2, 4, 8)) -> dict:
    """GB/s of host copies between numpy memory and a pinned buffer of the
    same size, each way: ``torch.Tensor.copy_`` under
    ``torch.set_num_threads(k)``, and ``np.copyto`` of k ranges from a
    pool of k threads; then pinned into fresh numpy memory (first touch:
    the page faults of a new output array) at the default thread count."""
    from concurrent.futures import ThreadPoolExecutor

    src = torch.from_numpy(host)
    pin_np = pinned.numpy()
    nbytes = host.nbytes

    def pool_copy(pool, k, dst, s):
        step = -(-dst.shape[0] // k)
        list(pool.map(lambda i: np.copyto(dst[i:i + step], s[i:i + step]),
                      range(0, dst.shape[0], step)))

    default = torch.get_num_threads()
    out = {"torch_default_threads": default}
    try:
        for k in threads:
            torch.set_num_threads(k)
            with ThreadPoolExecutor(k) as pool:
                out[f"threads_{k}"] = {
                    "torch_to_pinned": nbytes / _best_seconds(
                        lambda: pinned.copy_(src)) / 1e9,
                    "torch_from_pinned": nbytes / _best_seconds(
                        lambda: src.copy_(pinned)) / 1e9,
                    "numpy_to_pinned": nbytes / _best_seconds(
                        lambda: pool_copy(pool, k, pin_np, host)) / 1e9,
                    "numpy_from_pinned": nbytes / _best_seconds(
                        lambda: pool_copy(pool, k, host, pin_np)) / 1e9,
                    "numpy_from_pinned_into_fresh_numpy": nbytes / _best_seconds(
                        lambda: pool_copy(pool, k, np.empty_like(host),
                                          pin_np)) / 1e9,
                }
    finally:
        torch.set_num_threads(default)
    out["torch_from_pinned_into_fresh_numpy"] = nbytes / _best_seconds(
        lambda: torch.from_numpy(np.empty_like(host)).copy_(pinned)) / 1e9
    return out


def _piece_rates(pinned: torch.Tensor, on_card: torch.Tensor,
                 pieces=(8 * MIB, 32 * MIB, 128 * MIB, 512 * MIB)) -> dict:
    """GB/s of the whole buffer between pinned memory and the card, copied
    in pieces of each size with ``non_blocking=True`` on a side stream."""
    side = torch.cuda.Stream()
    src, card = pinned.view(torch.uint8), on_card.view(torch.uint8)
    nbytes = src.numel()

    def moved(piece, up):
        with torch.cuda.stream(side):
            for lo in range(0, nbytes, piece):
                hi = min(lo + piece, nbytes)
                if up:
                    card[lo:hi].copy_(src[lo:hi], non_blocking=True)
                else:
                    src[lo:hi].copy_(card[lo:hi], non_blocking=True)
        side.synchronize()

    return {f"{p // MIB}MiB": {
        "to_card": nbytes / _best_seconds(lambda: moved(p, True)) / 1e9,
        "to_pinned": nbytes / _best_seconds(lambda: moved(p, False)) / 1e9}
        for p in pieces}


def _staged_rates(host: np.ndarray, dev) -> dict:
    """GB/s of the streaming operators' staging (``ops/_staging.py``, its
    own piece size, ring and threads) each way: numpy to the card, the card
    to numpy memory already written once, and to fresh numpy memory."""
    from radx_tpu_torch.ops import _staging

    out = np.zeros_like(host)
    with _staging.Staging(dev) as st:
        card = st.upload(host)

        def down(dst):
            st.get(card, dst)
            st.wait()

        return {"piece_bytes": st.up.piece_bytes, "ring": _staging.RING,
                "threads": _staging.THREADS,
                "to_card": host.nbytes / _best_seconds(
                    lambda: st.put(host, card)) / 1e9,
                "to_numpy": host.nbytes / _best_seconds(
                    lambda: down(out)) / 1e9,
                "to_fresh_numpy": host.nbytes / _best_seconds(
                    lambda: down(np.empty_like(host))) / 1e9}


def measure_host_copies(nbytes: int = 1 << 30) -> dict:
    """The host <-> card copies that choose the streaming operators'
    staging (``ops/_staging.py``), on ``nbytes``: numpy (pageable) memory
    to the card and back, pinned memory (least of 3 copies each, GB/s);
    the cost of allocating pinned memory (first and second allocation, ms)
    and of registering a numpy array (ms a GiB); host copies between numpy
    and pinned memory at 1-8 threads (and into fresh numpy memory); pinned
    <-> card in pieces of 8-512 MiB on a side stream; and the staging path
    itself, each way."""
    dev = timing.require_cuda()
    alloc = _pinned_alloc_ms()  # before anything else of this size is pinned
    n = nbytes // 4
    host = np.random.default_rng(0).integers(0, 2**31, n, dtype=np.int32)
    pinned = torch.from_numpy(host).pin_memory()
    on_card = torch.from_numpy(host).to(dev)

    def rate(fn):
        return nbytes / _best_seconds(fn) / 1e9

    row = {"what": f"host <-> card copies of {nbytes} bytes, GB/s",
           "pageable_to_card": rate(lambda: torch.from_numpy(host).to(dev)),
           "card_to_pageable": rate(lambda: on_card.cpu().numpy()),
           "pinned_to_card": rate(lambda: pinned.to(dev, non_blocking=True)),
           "card_to_pinned": rate(lambda: pinned.copy_(on_card,
                                                       non_blocking=True)),
           "pinned_alloc_ms": alloc,
           "register": _register_ms_per_gib(host, dev),
           "memcpy_gb_per_s": _memcpy_rates(host, pinned),
           "pieces_gb_per_s": _piece_rates(pinned, on_card),
           "staged_gb_per_s": _staged_rates(host, dev),
           "device": timing.device_info()}
    del pinned, on_card
    return row


def _chunked_slabs() -> list[dict]:
    """The eager config-3 query at 2^30 rows with slabs of 2^28, 2^29 and
    2^30: the time and peak device memory that choose ``chunked.SLAB``."""
    data = query_chunked_data(1 << 30)
    return [measure_query_chunked(1 << 30, 1 << s, data=data)
            for s in (28, 29, 30)]


MEASURES = {
    "sort": lambda: [measure(N), measure(1 << 26)],
    "groupby": lambda: [measure_groupby()],
    "filter": lambda: [measure_filter()],
    "query": lambda: [measure_query()],
    "pairs": lambda: [measure_sort_pairs()],
    "join": lambda: [measure_join()],
    "dense": lambda: [measure_query_dense()],
    "chunked": lambda: [measure_host_copies(), *_chunked_slabs()],
    "host_copies": lambda: [measure_host_copies()],
    "sweep": lambda: sweep_tiles(),
    "sweep_scan": lambda: sweep_single_pass(),
    "profile": lambda: [profile_sort(1 << 23), profile_sort(), profile_groupby(),
                        profile_join(), profile_query_dense()],
    "launch": lambda: [measure_launch(1 << 26), measure_launch(1 << 28)],
    "sweep_hist": lambda: sweep_hist(),
    "sweep_gather": lambda: sweep_gather(),
    "profile_radix": lambda: [profile_radix()],
    "radix": lambda: [measure_radix(1 << 26), measure_radix(1 << 28),
                      profile_radix()],
}


def main(argv=None):
    names = (argv if argv is not None else sys.argv[1:]) or [
        "sort", "groupby", "filter", "query", "pairs", "join", "dense"]
    for name in names:
        if name not in MEASURES:
            raise SystemExit(f"unknown measure {name!r}; one of {list(MEASURES)}")
        for row in MEASURES[name]():
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
