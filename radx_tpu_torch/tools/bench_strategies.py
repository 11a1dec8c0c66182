"""The strategy A/B on the card: ``sort`` under ``strategy="radix"`` and
under ``"bitonic"`` on the same uniform keys — the port of
tools/bench_strategies.py.

    python -m radx_tpu_torch.tools.bench_strategies [log2n ...]   (default 23 24 25 26)

For each size both strategies run on one set of uniform uint32 keys made
on the card from a seeded generator.  Each result is gated before it is
timed: equal to ``bench.torch_sort_u32``, and for radix its overflow flag
clear (an overflowing radix sort falls back to the network, whose time it
would then report) — the gates of ``bench_suite``'s sort configs.  Timing
is ``utils.timing.time_op`` (CUDA events around back-to-back calls), not
the JAX tool's chaining inside one ``jit``.  Prints the JAX tool's line and
one JSON row per (size, strategy).  A failure of either strategy raises:
the JAX tool prints it and goes on, which hides a fault on the card.
"""

from __future__ import annotations

import argparse
import json

import torch

from radx_tpu_torch import bench_suite
from radx_tpu_torch.config import tuned
from radx_tpu_torch.utils import timing

STRATEGIES = ("radix", "bitonic")


def bench(n: int, strategy: str, keys: torch.Tensor, iters: int = 5,
          repeats: int = 3) -> dict:
    """Gate, then time ``sort`` of ``keys`` under ``strategy``; one row."""
    data = {"keys": keys, "cfg": tuned(strategy=strategy)}
    check = (bench_suite._check_radix if strategy == "radix"
             else bench_suite._check_sort)
    check(data, bench_suite._sort(data))
    m = timing.time_op(bench_suite._sort, data, name=f"{strategy} {n}",
                       items=n, bytes_moved=8 * n, iters=iters,
                       repeats=repeats)
    return {"n": n, "strategy": strategy, "ms": m.seconds * 1e3,
            "keys_per_s": m.items_per_s, "spread_pct": m.spread_pct,
            "correct": True}


def run(log_sizes, iters: int = 5, repeats: int = 3) -> list:
    """Both strategies at every 2^lg of ``log_sizes``; prints and returns
    the rows."""
    dev = timing.require_cuda()
    card = timing.nvidia_smi()
    rows = []
    for lg in log_sizes:
        n = 1 << lg
        gen = torch.Generator(device=dev).manual_seed(0)
        keys = bench_suite._uniform(n, gen)
        for strategy in STRATEGIES:
            row = bench(n, strategy, keys, iters, repeats)
            print(f"2^{lg} {strategy:8s}: {row['ms']:8.2f} ms  "
                  f"{row['keys_per_s'] / 1e9:6.3f} G keys/s  correct=True",
                  flush=True)
            row["card"] = card
            print(json.dumps(row), flush=True)
            rows.append(row)
        del keys
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log2n", nargs="*", type=int, default=[23, 24, 25, 26])
    args = ap.parse_args(argv)
    run(args.log2n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
