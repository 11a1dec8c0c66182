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
  * ``sort_radix_u32_keys_per_s_n2e26`` / ``_n2e28`` — ``sort`` under
    ``SortConfig(strategy="radix")`` on the permutation keys (the
    ``sort_radix_64m`` / ``_268m`` rows of the JAX ``bench_suite``), gated on
    ``torch.sort`` and on the overflow flag being False, with the bitonic
    rate at the same n beside it (``python -m radx_tpu_torch.bench radix``,
    which also prints ``profile_radix``, the breakdown by kernel).

``sweep`` runs the tile sweep of the keys-only, rider and lexicographic
sorts, ``sweep_scan`` times the single-pass compaction on three shapes and
sweeps the segmented scan's tile,
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
import sys
import time

import numpy as np
import torch

from radx_tpu_torch.config import SortConfig
from radx_tpu_torch.kernels import compact, msd, segscan
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


def _tile_pairs(chunks, finish_max):
    """(chunk, finish) exponents: every chunk with every finish >= it and
    >= 2^13 up to ``finish_max``."""
    return [(c, f) for c in chunks for f in range(max(c, 13), finish_max + 1)]


def sweep_tiles(n: int = 1 << 26):
    """The chunk x finish tiles of the network at n rows, one row each:
    keys only (``sort``, chunk 2^12..2^15 x finish 2^13..2^15), the rider
    sort (``groupby`` sum, up to 2^14: two planes of 2^15 exceed a block's
    shared memory) and the lexicographic tiles (``stable_*``, stated at two
    and three planes, up to 2^14): ``argsort`` (lex2), ``sort_pairs``
    (lex3) and the join's tagged-union sort (lex4, n/2 rows a side)."""
    from radx_tpu_torch.ops import join as join_ops
    from radx_tpu_torch.ops.sort import _encode_keys

    dev = timing.require_cuda()
    rows = []

    def run(metric, fn, check, **tiles):
        check()
        t = timing.time_cuda(fn, iters=3, repeats=3)
        rows.append(_row(f"{metric}_{_name(n)}", n, t, **tiles))

    keys = torch.from_numpy(permutation_keys(n)).to(dev)
    want = torch_sort_u32(keys).view(torch.int32)

    def check_sort(cfg):
        if not torch.equal(sort(keys, cfg).view(torch.int32), want):
            raise AssertionError("sort differs from torch.sort")

    for c, f in _tile_pairs((12, 13, 14, 15), 15):
        cfg = SortConfig(chunk_elems=1 << c, finish_elems=1 << f)
        run("sort_u32_keys_per_s", lambda: sort(keys, cfg),
            lambda: check_sort(cfg), chunk_elems=1 << c, finish_elems=1 << f)
    del keys, want
    gk, gv = groupby_data(n)
    for c, f in _tile_pairs((12, 13, 14), 14):
        cfg = SortConfig(rider_chunk_elems=1 << c, rider_finish_elems=1 << f)
        run("groupby_sum_rows_per_s", lambda: groupby(gk, gv, "sum", cfg),
            lambda: _check_groups(*groupby(gk, gv, "sum", cfg), gk, gv),
            rider_chunk_elems=1 << c, rider_finish_elems=1 << f)
    del gk, gv
    keys, payload = pairs_data(n)
    order = torch.sort(keys.view(torch.int32), stable=True).indices
    want = torch_sort_pairs(keys, payload)[1].view(torch.int32)
    bk, bv, pk, pv = join_data(n // 2, n // 2)
    for c, f in _tile_pairs((12, 13, 14), 14):
        cfg = SortConfig(stable_chunk_elems=1 << c,
                         stable_finish_elems=1 << f)
        tiles = {"stable_chunk_elems": 1 << c, "stable_finish_elems": 1 << f}

        def check_argsort():
            if not torch.equal(argsort(keys, cfg).long(), order):
                raise AssertionError("argsort differs from torch.sort")

        def check_pairs():
            got = sort_pairs(keys, payload, cfg)[1].view(torch.int32)
            if not torch.equal(got, want):
                raise AssertionError("sort_pairs differs from torch.sort")

        def union():
            return join_ops.tagged_union(_encode_keys(bk), bv,
                                         _encode_keys(pk), pv, cfg)

        run("argsort_rows_per_s", lambda: argsort(keys, cfg), check_argsort,
            **tiles)
        run("sort_pairs_u32_pairs_per_s", lambda: sort_pairs(keys, payload,
                                                              cfg),
            check_pairs, **tiles)
        run("join_union_sort_rows_per_s", union, lambda: None, **tiles)
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


def _profile(fn, calls: int, layer_of, what: str) -> dict:
    """Device time per call by layer (torch.profiler) and the device's idle
    share of the profiled wall time."""
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
    return {"what": what, "layers_ms": layers, "busy_ms": busy,
            "wall_ms_per_call": wall * 1e3 / calls,
            "idle_pct": 100.0 * (1 - busy / (wall * 1e3 / calls)),
            "top_kernels_ms": dict(sorted(kernels.items(),
                                          key=lambda kv: -kv[1])[:12]),
            "device": timing.device_info()}


def profile_join(n: int = 10**8, calls: int = 2) -> dict:
    """``Table.join`` (inner) of two n-row tables by layer: the four-plane
    lexicographic sort, segscan, compact, elementwise (union assembly,
    masks, copies)."""
    build, probe = _join_tables(n)

    def layer_of(name):
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


def measure_launch(launches: int = 200) -> dict:
    """The launch path of one small kernel, K11 ``radix_rank`` at the 2^26
    radix geometry (128 sorted chunks of 2^19 keys, 160 splitters): host
    microseconds per wrapper call (the enqueue, no synchronisation), CUDA
    events time per call and the profiler's device time per launch, beside
    ``torch.searchsorted`` on the same inputs."""
    dev = timing.require_cuda()
    g = _generator(17)
    chunk, n_chunks, m = 1 << 19, 128, 160
    keys = torch.sort(_randint(-(2**31), 2**31, chunk * n_chunks, g).view(
        n_chunks, chunk), dim=1).values.reshape(-1)
    spl = torch.sort(_randint(-(2**31), 2**31, m, g)).values
    want = torch.searchsorted(keys.view(n_chunks, chunk),
                              spl.expand(n_chunks, m).contiguous())
    if not torch.equal(msd.splitter_ranks(keys, spl, chunk).long(), want):
        raise AssertionError("radix_rank differs from torch.searchsorted")

    def call():
        return msd.splitter_ranks(keys, spl, chunk)

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
    view, spl2 = keys.view(n_chunks, chunk), spl.expand(n_chunks, m).contiguous()
    lib = timing.time_cuda(lambda: torch.searchsorted(view, spl2),
                           iters=launches, repeats=5)
    return {"what": "radix_rank launch path (128 chunks of 2^19, 160 "
                    "splitters)",
            "host_us_per_launch": min(host) * 1e6,
            "events_ms": events.seconds * 1e3,
            "device_ms": prof["layers_ms"].get("radix_rank", 0.0),
            "searchsorted_ms": lib.seconds * 1e3,
            "device": timing.device_info()}


# --- slice 4: strategy="radix" ---------------------------------------------

RADIX = SortConfig(strategy="radix")


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
    if not msd.LAUNCHES["radix_rank"] == msd.LAUNCHES["radix_concat"] == 1:
        raise AssertionError(f"radix overflow on {n} permutation keys")
    msd.reset_counts()
    t = timing.time_cuda(lambda: sort(keys, cfg), iters=3, repeats=5)
    if msd.LAUNCHES["radix_concat"] != msd.LAUNCHES["radix_rank"]:
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
    (cross_stage, finish, chunk_sort), K10-K13, elementwise."""
    keys = torch.from_numpy(permutation_keys(n)).to(timing.require_cuda())
    return _profile(lambda: sort(keys, RADIX), calls, _radix_layer,
                    f"sort strategy=radix n={n}, ms of device time per call")


MEASURES = {
    "sort": lambda: [measure(N), measure(1 << 26)],
    "groupby": lambda: [measure_groupby()],
    "filter": lambda: [measure_filter()],
    "query": lambda: [measure_query()],
    "pairs": lambda: [measure_sort_pairs()],
    "join": lambda: [measure_join()],
    "dense": lambda: [measure_query_dense()],
    "sweep": lambda: sweep_tiles(),
    "sweep_scan": lambda: sweep_single_pass(),
    "profile": lambda: [profile_sort(1 << 23), profile_sort(), profile_groupby(),
                        profile_join(), profile_query_dense()],
    "launch": lambda: [measure_launch()],
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
