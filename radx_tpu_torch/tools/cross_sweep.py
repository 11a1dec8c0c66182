"""The cross passes on one card: a pass at each F, and the cap and tile of
the strided tile pass swept over whole sorts.

    python -m radx_tpu_torch.tools.cross_sweep passes [--tag NAME]
    python -m radx_tpu_torch.tools.cross_sweep sweep [--sizes 23,26,28]

``passes``: one cross pass at F = 1 .. the cap, in the keys, rider and
lex2 modes at 2^23, 2^26 and 2^28 rows (j_low the mode's finish tile, the
top merge level), and the whole sort at each size; least ms of 5 repeats
of 10 calls by CUDA events, the pass's bound (one read and one write of
every plane at 3.35 TB/s) beside it.  It reads only ``cross_stage`` and
``sort_planes`` of ``radx_tpu_torch.kernels.bitonic``, so it times any
checkout: run this file by its path with ``PYTHONPATH=<checkout>`` to time
that checkout's passes (its cap: ``cross_fusion`` where it has one, else
``max_fusion``) in the same call as this one's.

``sweep``: the whole sort in the three modes at 2^23, 2^26 and 2^28 rows
for every cap 4..10 and cross tile of 64 KB and 128 KB (2^14 / 2^15 keys,
2^13 / 2^14 rows of two planes), with its cross passes counted.

One JSON line a measurement, then the nvidia-smi line.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from radx_tpu_torch import SortConfig
from radx_tpu_torch.kernels import bitonic as B
from radx_tpu_torch.utils import timing

MODES = {"keys": (1, 1), "rider": (1, 2), "lex2": (2, 2)}
HBM_BYTES_PER_S = 3.35e12
SORTS = dict(iters=3, repeats=5, warmup=1)  # 16 sorts a timing
CAPS = range(4, 11)


def _cap(planes):
    return getattr(B, "cross_fusion", B.max_fusion)(planes)


def _planes(mode, n, gen):
    """Keys in [0, 2^20) (ties), a unique second plane where there is one
    (the stable sorts' index, group-by's row ids)."""
    ncmp, p = MODES[mode]
    x = torch.randint(0, 1 << 20, (n,), dtype=torch.int32, generator=gen,
                      device="cuda")
    rest = [torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
            for _ in range(p - 1)]
    if ncmp == 2:
        return x, {"lex": rest}
    return x, {"rider": rest[0] if rest else None}


def _tiles(mode):
    ncmp, p = MODES[mode]
    return SortConfig().mode_tiles(p, ncmp)


def _sort(x, kw, mode):
    chunk, fin = _tiles(mode)
    return lambda: B.sort_planes(x, chunk, fin, **kw)


def _passes_a_sort():
    """Cross passes of one sort, from the launches of one timing."""
    sorts = SORTS["warmup"] + SORTS["iters"] * SORTS["repeats"]
    return sum(v for k, v in B.LAUNCHES.items()
               if k.startswith("cross_stage")) / sorts


def passes(tag, sizes):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for log_n in sizes:
        for mode, (_, p) in MODES.items():
            x, kw = _planes(mode, 1 << log_n, gen)
            log_t = _tiles(mode)[1].bit_length() - 1
            for f in range(1, _cap(p) + 1):
                t = timing.time_cuda(
                    lambda f=f: B.cross_stage(x, log_t, f, log_n, **kw))
                print(json.dumps({
                    "what": "pass", "tree": tag, "mode": mode, "log_n": log_n,
                    "f": f, "ms": t.seconds * 1e3,
                    "spread_pct": t.spread_pct,
                    "bound_ms": 8 * p * (1 << log_n) / HBM_BYTES_PER_S * 1e3}),
                    flush=True)
            B.reset_counts()
            t = timing.time_cuda(_sort(x, kw, mode), **SORTS)
            print(json.dumps({
                "what": "sort", "tree": tag, "mode": mode, "log_n": log_n,
                "cap": _cap(p), "ms": t.seconds * 1e3,
                "spread_pct": t.spread_pct,
                "cross_passes": _passes_a_sort()}), flush=True)
            del x, kw
            torch.cuda.empty_cache()


def sweep(sizes):
    gen = torch.Generator(device="cuda").manual_seed(1)
    cap0, tile0 = B.cross_fusion, B.CROSS_TILE_BYTES
    for ncmp, p in MODES.values():  # counters for the passes above the cap
        for f in CAPS:
            B.LAUNCHES.setdefault(f"cross_stage<{f}>" + B._suffix(ncmp, p), 0)
    try:
        for log_n in sizes:
            for mode in MODES:
                x, kw = _planes(mode, 1 << log_n, gen)
                for tile_bytes in (64 * 1024, 128 * 1024):
                    for cap in CAPS:
                        B.cross_fusion = lambda planes, cap=cap: cap
                        B.CROSS_TILE_BYTES = tile_bytes
                        B.reset_counts()
                        t = timing.time_cuda(_sort(x, kw, mode), **SORTS)
                        print(json.dumps({
                            "what": "sweep", "mode": mode, "log_n": log_n,
                            "cap": cap, "tile_bytes": tile_bytes,
                            "ms": t.seconds * 1e3,
                            "spread_pct": t.spread_pct,
                            "cross_passes": _passes_a_sort()}),
                            flush=True)
                del x, kw
                torch.cuda.empty_cache()
    finally:
        B.cross_fusion, B.CROSS_TILE_BYTES = cap0, tile0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("passes", "sweep"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--sizes", default=None,
                    help="log2 sizes, comma-separated (default 23,26,28)")
    args = ap.parse_args(argv)
    timing.require_cuda()
    if args.what == "passes":
        passes(args.tag, [int(s) for s in (args.sizes or "23,26,28").split(",")])
    else:
        sweep([int(s) for s in (args.sizes or "23,26,28").split(",")])
    print(timing.nvidia_smi(), flush=True)


if __name__ == "__main__":
    sys.exit(main())
