"""finish (K3) on one card: the pass at the top merge level beside its bound
and the library call, in the modes and sizes of the paths.

    python -m radx_tpu_torch.tools.finish_bench [--tag NAME]
    PYTHONPATH=<checkout> python <this file> --tag parent   # another checkout

Keys at 2^23, 2^26 and 2^28 rows, rider at 2^26, lex2 at 2^28, lex3 at
2^26 and lex4..lex8 at 2^24, each on the mode's finish tile, on tiles
whose keys are bitonic (an ascending half, a descending half), where the
pass sorts every tile:

  * ``finish``: the pass the wrapper's rule picks;
  * where the checkout has both of the kernel's plans (``finish_top``),
    each forced: ``runtime_plan`` (the plan read at run time) and
    ``compile_time_plan``, in turns with ``finish`` (the three, then the
    three again);
  * ``first_last``: the pass cut to its first and last phases (one
    shared-memory round trip instead of ceil(log2 T / R) - 1): what the
    round trips cost;
  * ``copy``: ``copy_`` of every plane, the card's practical rate for the
    same bytes;
  * ``bound_ms``: each plane read once and written once at 3.35 TB/s;
  * ``library_ms``: ``torch.sort`` of the (n / T, T) view, which computes
    the same function on these inputs (keys only; none for the riders).

Least ms of 5 repeats of 10 calls by CUDA events.  It reads only
``finish``, ``tile_plan``, ``max_fusion`` and the launch path of
``radx_tpu_torch.kernels.bitonic``, so it times any checkout: run this
file by its path with ``PYTHONPATH=<checkout>`` to time that checkout in
the same call.  One JSON line a case, then the nvidia-smi line.  Needs a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from radx_tpu_torch import SortConfig
from radx_tpu_torch.kernels import _build
from radx_tpu_torch.kernels import bitonic as B
from radx_tpu_torch.utils import timing

HBM_BYTES_PER_S = 3.35e12
CASES = (("keys", 23), ("keys", 26), ("keys", 28), ("rider", 26),
         ("lex2", 28), ("lex3", 26), *((f"lex{p}", 24) for p in range(4, 9)))
MODES = {"keys": (1, 1), "rider": (1, 2),
         **{f"lex{p}": (2, p) for p in range(2, 9)}}


def _ms(fn):
    return timing.time_cuda(fn, iters=10, repeats=5).seconds * 1e3


def _bitonic_tiles(n, tile, planes, gen):
    """Keys whose tiles are bitonic (the first half ascending, the second
    descending), with ties; a unique second plane in lex mode (the index
    plane of the stable sorts), random riders."""
    x = torch.randint(0, 1 << 20, (n,), dtype=torch.int32, generator=gen,
                      device="cuda")
    halves = torch.sort(x.view(-1, 2, tile // 2), dim=2).values
    halves[:, 1] = halves[:, 1].flip(-1)
    rest = [torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
            for _ in range(planes - 1)]
    return [halves.view(-1), *rest]


def _launch_plan(planes, ncmp, tile, phases):
    """One finish launch of the given phases (a cut plan) on the run-time
    plan's kernel."""
    x = planes[0]
    log_t = tile.bit_length() - 1
    codes = [a | b << 6 | hi << 12 | lo << 16 | w << 20
             for a, b, hi, lo, w in phases]
    arg = (ctypes.c_int32 * len(codes))(*codes)
    extra = (0,) if hasattr(B, "finish_top") else ()
    _build.launch(B.LAUNCHES, "finish" + B._suffix(ncmp, len(planes)),
                  "radx_finish", x.device, B._ptrs(planes), len(planes), ncmp,
                  x.numel(), log_t, 0, x.numel().bit_length() - 1, arg,
                  len(codes), *extra)


def case(mode, log_n, tag, gen):
    ncmp, p = MODES[mode]
    n = 1 << log_n
    tile = SortConfig().mode_tiles(p, ncmp)[1]
    planes = _bitonic_tiles(n, tile, p, gen)
    k, rider, lex = B._keywords(planes, ncmp)
    row = {"tag": tag, "mode": mode, "n": n, "tile": tile,
           "bound_ms": 8 * p * n / HBM_BYTES_PER_S * 1e3}
    designs = ({"runtime_plan": False, "compile_time_plan": True}
               if hasattr(B, "finish_top") else {})
    for _ in range(2):
        row.setdefault("finish", []).append(
            _ms(lambda: B.finish(k, tile, log_n, rider=rider, lex=lex)))
        for name, top in designs.items():
            row.setdefault(name, []).append(_ms(lambda: B._launch_finish(
                planes, ncmp, tile, log_n, False, log_n, top)))
    plan = B.tile_plan(tile.bit_length() - 1, log_n, log_n, B.max_fusion(p))
    row["phases"] = len(plan)
    row["first_last"] = _ms(lambda: _launch_plan(
        planes, ncmp, tile, (plan[0], plan[-1])))
    outs = [torch.empty_like(q) for q in planes]
    row["copy"] = _ms(lambda: [o.copy_(q) for o, q in zip(outs, planes)])
    row["library_ms"] = (_ms(lambda: torch.sort(k.view(-1, tile), dim=1))
                         if p == 1 else None)
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args(argv)
    timing.require_cuda()
    _build.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for mode, log_n in CASES:
        case(mode, log_n, args.tag, gen)
        torch.cuda.empty_cache()
    print(timing.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
