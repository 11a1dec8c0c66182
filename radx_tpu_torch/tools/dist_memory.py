"""Peak device memory and time of the distributed sort on an in-process mesh
of one card, by capacity and key distribution.

    python -m radx_tpu_torch.tools.dist_memory [--shards 8] [--log-shard 25]
        [--capacities 2,4,8] [--tag NAME]

For each capacity and each of two key distributions (``uniform`` uint32;
``equal90``: 90% of the keys one value, the rest uniform), ``sort_sharded``
of shards x 2^log_shard keys on a mesh of that many shards of the card,
flat exchange (``overlap`` is left at its default: it has no effect, the
arrivals merge after the last wave).  One JSON line each: the peak device
memory of one call (``max_memory_allocated`` after
``reset_peak_memory_stats``, the input's bytes included, as the benchmark
counts it), the least ms a call of 3 repeats by CUDA events after a warm-up, the output row's length, the
overflow flag (an overflowing sort is timed all the same: its rows are the
JAX package's, not the sorted keys) and, where it did not overflow, whether
the rows equal ``torch.sort``.  Then the nvidia-smi line.

It reads only ``parallel.Mesh`` and ``parallel.dist_sort.sort_sharded``,
so it measures any checkout: run this file by its path with
``PYTHONPATH=<checkout>`` to measure that checkout in the same call as
this one.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from radx_tpu_torch.parallel import Mesh
from radx_tpu_torch.parallel import dist_sort


def keys_of(kind: str, n: int, dev, seed: int = 0) -> torch.Tensor:
    """n uint32 keys on ``dev``: ``uniform``, or ``equal90`` (90% of them
    0x9E3779B9)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, device=dev,
                      generator=gen)
    if kind == "equal90":
        hit = torch.rand(n, device=dev, generator=gen) < 0.9
        k = torch.where(hit, torch.tensor(0x9E3779B9 - (1 << 32), device=dev,
                                          dtype=torch.int32), k)
    return k.view(torch.uint32)


def _ms(fn, repeats: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def measure(shards: int, log_shard: int, capacity: int, kind: str) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    n = shards << log_shard
    keys = keys_of(kind, n, dev)
    mesh = Mesh([dev] * shards)

    def call():
        return dist_sort.sort_sharded(keys, mesh, capacity=capacity)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows, valid, overflow = call()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before + 4 * n) / 2**30
    over = bool(overflow.any())
    equal = None
    if not over:
        v = valid.tolist()
        got = torch.cat([rows[d, : v[d]].view(torch.int32) ^ (-(1 << 31))
                         for d in range(shards)])
        want = torch.sort(keys.view(torch.int32) ^ (-(1 << 31))).values
        equal = bool(torch.equal(got, want))
        del got, want
    row = rows.shape[1]
    del rows, valid, overflow
    ms = _ms(call)
    return {"shards": shards, "keys_per_shard": 1 << log_shard,
            "capacity": capacity, "keys": kind, "peak_device_gib": peak,
            "ms": ms, "keys_per_s": n / ms * 1e3, "row_len": row,
            "overflow": over, "equal_torch_sort": equal}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--log-shard", type=int, default=25)
    ap.add_argument("--capacities", default="2,4,8")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = torch.cuda.get_device_name(0)
    for kind in ("uniform", "equal90"):
        for cap in map(int, args.capacities.split(",")):
            r = measure(args.shards, args.log_shard, cap, kind)
            print(json.dumps({"tag": args.tag, **r, "card": card}),
                  flush=True)
            if r["equal_torch_sort"] is False:
                print("FAIL: rows differ from torch.sort", file=sys.stderr)
                return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
