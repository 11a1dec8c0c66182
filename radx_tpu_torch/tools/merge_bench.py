"""Time ``kernels/merge.merge_runs`` at the distributed sort's shapes, and a
shard's pairwise merge tree, on one card.

    python -m radx_tpu_torch.tools.merge_bench [--tag NAME]
        [--shapes keys25,keys28,lex3_25] [--trees 8x22,4x27] [--profile]

Shapes: keys 2^24 + 2^24 (the 8-shard mesh's last merge), keys 2^27 +
2^27 (the four-card cell's first level), (key, index) with one payload, 3
planes, 2^24 + 2^24; trees: ``dist_sort._Merger`` over 8 runs of 2^22 and
4 runs of 2^27 keys into an output row (the key XOR on the last merge).
Each is checked first (a merge against ``merge_runs_ref`` on the card, a
tree against ``torch.sort``), then timed by ``utils.timing.time_cuda``
(CUDA events, the least mean of 5 repeats of 100 calls, 5 for a tree, with
the spread of the repeats).  One JSON line each: ms (a merge into the same
output planes, as ``chip_smoke.py`` phase 5 times it; ``ms_new_out``: into
new ones each call, 10 calls a repeat), the bound (each row of each
plane read once and written once at 3.35 TB/s; a tree beside one pass's
bound) and the share of it.
``--profile`` adds ``utils.timing.profile``: the merge kernels' own device
ms a call (``torch.profiler``) and the host's µs to enqueue one call.
Then the nvidia-smi line.

It reads only ``merge.merge_runs`` / ``merge_runs_ref`` / ``LAUNCHES`` and
``dist_sort._Merger``, so it measures any checkout: run this file by its
path with ``PYTHONPATH=<checkout>`` to measure that checkout in the same
call as this one.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from radx_tpu_torch.kernels import merge
from radx_tpu_torch.parallel import dist_sort
from radx_tpu_torch.utils import timing

HBM_BYTES_PER_S = 3.35e12
SIGN = -(1 << 31)
SHAPES = {"keys25": (24, 1, 1), "keys28": (27, 1, 1), "lex3_25": (24, 2, 3),
          # the mesh tree's first level; a merge of 2^17 rows (its fixed
          # cost); not timed unless named
          "keys23": (22, 1, 1), "keys17": (16, 1, 1)}
DEFAULT_SHAPES = "keys25,keys28,lex3_25"
TREES = {"8x22": (8, 22), "4x27": (4, 27)}


def runs(dev, log_half, ncmp, planes, seed):
    """Two ascending runs of 2^log_half rows: uniform keys; (key, index)
    order with a unique index plane where ncmp = 2; payloads random."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    half = 1 << log_half

    def run(base):
        k = torch.randint(-(2**31), 2**31, (half,), dtype=torch.int32,
                          device=dev, generator=gen)
        rest = [torch.arange(base, base + half, dtype=torch.int32, device=dev)
                if p == 1 else
                torch.randint(-(2**31), 2**31, (half,), dtype=torch.int32,
                              device=dev, generator=gen)
                for p in range(1, planes)]
        order = torch.sort(k, stable=True).indices
        return [k[order], *(r[order] for r in rest)]

    return run(0), run(half)


def time_ms(fn, iters):
    """Least mean ms a call and the spread of the repeats in percent."""
    t = timing.time_cuda(fn, iters=iters, repeats=5, warmup=1)
    return t.seconds * 1e3, t.spread_pct


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def profile(fn, calls):
    return timing.profile(fn, lambda: sum(merge.LAUNCHES.values()), "merge",
                          calls)


def merge_line(dev, name, prof=False):
    log_half, ncmp, planes = SHAPES[name]
    a, b = runs(dev, log_half, ncmp, planes, 90)
    out = [torch.empty(2 << log_half, dtype=torch.int32, device=dev)
           for _ in range(planes)]
    merge.merge_runs(a, b, ncmp, out=out, key_xor=SIGN)
    want = merge.merge_runs_ref(a, b, ncmp, key_xor=SIGN)
    same = all(torch.equal(o, w) for o, w in zip(out, want))
    del want

    def into_out():
        merge.merge_runs(a, b, ncmp, out=out, key_xor=SIGN)

    ms, spread = time_ms(into_out, iters=100)
    ms_new, _ = time_ms(lambda: merge.merge_runs(a, b, ncmp, key_xor=SIGN),
                        iters=10)
    bound = bound_ms(8 * planes * (2 << log_half))
    extra = profile(into_out, 10) if prof else {}
    return {**extra, "merge": name, "rows": 2 << log_half, "planes": planes,
            "num_cmp": ncmp, "equal": same, "ms": ms, "spread_pct": spread,
            "ms_new_out": ms_new, "bound_ms": bound,
            "share_of_bound": bound / ms}


def tree_line(dev, name, prof=False):
    k, log_run = TREES[name]
    gen = torch.Generator(device=dev).manual_seed(95)
    rs = [[torch.sort(torch.randint(-(2**31), 2**31, (1 << log_run,),
                                    dtype=torch.int32, device=dev,
                                    generator=gen)).values]
          for _ in range(k)]
    out = [torch.empty(k << log_run, dtype=torch.int32, device=dev)]

    def tree():
        merger = dist_sort._Merger(k, 1, out, SIGN)
        for r in rs:
            merger.push(r)

    tree()
    want = torch.sort(torch.cat([r[0] for r in rs])).values ^ SIGN
    same = bool(torch.equal(out[0], want))
    del want
    ms, spread = time_ms(tree, iters=5)
    bound = bound_ms(8 * (k << log_run))
    extra = profile(tree, 5) if prof else {}
    return {**extra, "tree": name, "runs": k, "rows": k << log_run,
            "equal": same, "ms": ms, "spread_pct": spread,
            "one_pass_bound_ms": bound, "passes_of_bound": ms / bound}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=DEFAULT_SHAPES)
    ap.add_argument("--trees", default=",".join(TREES))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("merge_bench needs a CUDA device", file=sys.stderr)
        return 2
    dev = timing.require_cuda()
    card = {"tag": args.tag, "card": torch.cuda.get_device_name(dev)}
    for name in filter(None, args.shapes.split(",")):
        print(json.dumps({**merge_line(dev, name, args.profile), **card}),
              flush=True)
        torch.cuda.empty_cache()
    for name in filter(None, args.trees.split(",")):
        print(json.dumps({**tree_line(dev, name, args.profile), **card}),
              flush=True)
        torch.cuda.empty_cache()
    print(timing.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
