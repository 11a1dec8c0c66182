"""Benchmarks of the port on the card, one JSON line per metric.

    python -m radx_tpu_torch.bench                 # every metric below
    python -m radx_tpu_torch.bench sort groupby    # some of them
    python -m radx_tpu_torch.bench sweep profile   # rider tiles; breakdown

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
    host read of the kept count, to cut the columns).

Inputs are made with numpy from fixed seeds (the card has no JAX, so the
reference's ``radx_tpu.runtime`` generators are not used).  With no CUDA
device every measure raises.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from radx_tpu_torch.config import SortConfig
from radx_tpu_torch.ops.filter import filter_columns
from radx_tpu_torch.ops.groupby import groupby
from radx_tpu_torch.ops.sort import sort
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


def permutation_keys(n: int) -> np.ndarray:
    return np.random.default_rng(0).permutation(n).astype(np.uint32)


def _name(n: int) -> str:
    log_n = n.bit_length() - 1
    return f"n2e{log_n}" if n == 1 << log_n else f"n{n}"


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


def sweep_rider_tiles(n: int = 1 << 26):
    """``groupby`` sum at n rows for rider chunk x finish tiles in
    {2^12, 2^13, 2^14} (finish >= chunk); one row each."""
    keys, vals = groupby_data(n)
    rows = []
    for c in (12, 13, 14):
        for f in range(c, 15):
            cfg = SortConfig(rider_chunk_elems=1 << c, rider_finish_elems=1 << f)
            _check_groups(*groupby(keys, vals, "sum", cfg), keys, vals)
            t = timing.time_cuda(lambda: groupby(keys, vals, "sum", cfg),
                                 iters=3, repeats=5)
            rows.append(_row("groupby_sum_rows_per_s_" + _name(n), n, t,
                             rider_chunk_elems=1 << c,
                             rider_finish_elems=1 << f))
    return rows


def _layer(name: str) -> str:
    if "chunk_sort" in name or "cross_stage" in name or "finish" in name:
        return "rider_sort"
    for layer in ("segscan", "compact"):
        if layer in name:
            return layer
    return "elementwise"


def profile_groupby(n: int = 1 << 26, calls: int = 5) -> dict:
    """Device time per ``groupby`` sum call by layer (torch.profiler) and
    the device's idle share of the profiled wall time."""
    import time

    keys, vals = groupby_data(n)
    groupby(keys, vals, "sum")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            groupby(keys, vals, "sum")
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
        layer = _layer(ev.key)
        layers[layer] = layers.get(layer, 0.0) + dev_us / 1e3 / calls
    busy = sum(layers.values())
    return {"what": f"groupby sum n={n}, ms of device time per call",
            "layers_ms": layers, "busy_ms": busy,
            "wall_ms_per_call": wall * 1e3 / calls,
            "idle_pct": 100.0 * (1 - busy / (wall * 1e3 / calls)),
            "top_kernels_ms": dict(sorted(kernels.items(),
                                          key=lambda kv: -kv[1])[:12]),
            "device": timing.device_info()}


MEASURES = {
    "sort": lambda: [measure(N), measure(1 << 26)],
    "groupby": lambda: [measure_groupby()],
    "filter": lambda: [measure_filter()],
    "query": lambda: [measure_query()],
    "sweep": sweep_rider_tiles,
    "profile": lambda: [profile_groupby()],
}


def main(argv=None):
    names = (argv if argv is not None else sys.argv[1:]) or [
        "sort", "groupby", "filter", "query"]
    for name in names:
        if name not in MEASURES:
            raise SystemExit(f"unknown measure {name!r}; one of {list(MEASURES)}")
        for row in MEASURES[name]():
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
