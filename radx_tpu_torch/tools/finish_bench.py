"""The tile engine's kernels on one card: ``finish`` (K3), ``chunk_sort``
(K1), K2's strided tile pass, and the radix sort's ``chunk_sort_cyclic``
(K4) and ``slot_merge`` (K5), each on the plan read at run time and on the
plan laid out at compile time, in turns, beside its bound and the library
call, in the modes and sizes of the paths.

    python -m radx_tpu_torch.tools.finish_bench [--tag NAME] [--probe]
        [--sass] [--sass-against LIB]
        [--kernels finish,chunk_sort,cross_stage,chunk_sort_cyclic,slot_merge]
    PYTHONPATH=<checkout> python <this file> --tag parent   # another checkout

Cases (least ms of 5 repeats of 10 calls by CUDA events, in turns: the
rule's pass, the run-time plan, the compile-time plan, then the three
again):

  * ``finish``: keys at 2^23, 2^26 and 2^28 rows, rider at 2^26, lex2 at
    2^28, lex3 at 2^26 and lex4..lex8 at 2^24, each on the mode's finish
    tile at the top level, on tiles whose keys are bitonic (an ascending
    half, a descending half), where the pass sorts every tile; beside it
    ``first_last`` (the pass cut to its first and last phases: what the
    round trips cost) and ``copy`` (``copy_`` of every plane, the card's
    practical rate for the same bytes);
  * ``chunk_sort``: the same modes and sizes on the mode's chunk tile, on
    random keys with ties (a unique index plane in lex mode);
  * ``cross_stage``: every strided pass (f > max_fusion(P)) at the
    paths' geometry (the lowest distance at the finish tile, the level
    just above the pass): keys F = 5..10 and lex2 F = 5..9 at 2^28, rider
    F = 5..9 and lex3 F = 5..8 at 2^26, lex4..lex8 at 2^24;
  * ``chunk_sort_cyclic`` and ``slot_merge``: every mode at the radix
    sort's geometries of 2^26 keys (radix chunks C = 2^19, slots of 4096)
    and 2^28 (C = 2^19, slots of 1024), on the mode's tile; K4 over the n
    rows, K5 over the packed slots (nb_pad x C rows), random keys with
    ties; the two plans' outputs must be equal.

Each row has ``bound_ms``, the larger of each plane read and written once
at 3.35 TB/s and the pass's 32-bit integer operations (a min and a max a
pair with one plane; a compare and two selects a plane with more) at
``int_ops_per_s``, with ``bound_by``; ``library_ms``:
``torch.sort`` of the tile view (keys only; none for the riders); the
tile passes' shared-memory round trips.

``--probe`` first times ``tools/int_rate.cu`` (its min / max
instructions counted in the compiled code) and prints the card's 32-bit integer
min / max rate beside SMs x 64 x the maximum SM clock.  ``--sass`` prints
the opcode counts of every tile-engine kernel instance of the built
library (``cuobjdump -sass``), those on a compile-time plan beside what the
plan predicts: a keys-only substage is 2^R min / max a thread in each body
its level runs, one body where the direction is a lane, register or tile
bit, two where it is a warp's bit (a branch one way for a warp).
``--sass-against LIB`` also compares every instance that LIB (another
checkout's built library) has too, opcode by opcode.

It reads only the wrappers, ``tile_plan``, ``max_fusion`` and the launch
path of ``radx_tpu_torch.kernels.bitonic``, so it times any checkout: run
this file by its path with ``PYTHONPATH=<checkout>`` to time that checkout
in the same call (a checkout without a compile-time plan of a kernel
prints its rule's pass only).  One JSON line a case, then the nvidia-smi
line.  Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import subprocess

import torch

from radx_tpu_torch import SortConfig
from radx_tpu_torch.kernels import _build
from radx_tpu_torch.kernels import bitonic as B
from radx_tpu_torch.utils import timing

HBM_BYTES_PER_S = 3.35e12
# 32-bit integer min / max (and compare, select) a clock an SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instructions);
# --probe measures it on the card
INT_OPS_PER_CLOCK_SM = 64
SIZES = (("keys", 23), ("keys", 26), ("keys", 28), ("rider", 26),
         ("lex2", 28), ("lex3", 26), *((f"lex{p}", 24) for p in range(4, 9)))
CROSS_SIZES = {"keys": 28, "rider": 26, "lex2": 28, "lex3": 26,
               **{f"lex{p}": 24 for p in range(4, 9)}}
MODES = {"keys": (1, 1), "rider": (1, 2),
         **{f"lex{p}": (2, p) for p in range(2, 9)}}
KERNELS = ("finish", "chunk_sort", "cross_stage", "chunk_sort_cyclic",
           "slot_merge")
RADIX_SIZES = (26, 28)  # the radix sort's geometries (K4, K5)


def int_ops_per_s(device=0):
    """32-bit integer operations a second of a card: its SMs x
    INT_OPS_PER_CLOCK_SM x its maximum SM clock (nvidia-smi clocks.max.sm):
    the rate of the compare-exchange kernels' operations bound."""
    proc = subprocess.run(
        ["nvidia-smi", f"--id={device}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * INT_OPS_PER_CLOCK_SM * float(proc.stdout.split()[0]) * 1e6


def _ms(fn):
    return timing.time_cuda(fn, iters=10, repeats=5).seconds * 1e3


def _ops(n, substages, planes):
    """32-bit operations of ``substages`` compare-exchange substages over n
    rows (chip_smoke.py ``_cx_ops``)."""
    return n // 2 * substages * (2 if planes == 1 else 1 + 2 * planes)


def _bound(n, planes, substages, ops_per_s):
    by_bytes = 8 * planes * n / HBM_BYTES_PER_S * 1e3
    by_ops = _ops(n, substages, planes) / ops_per_s * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


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


def _random_planes(n, planes, gen):
    """Keys with ties, then a unique plane (lex: the index plane; rider:
    a rider), then random riders."""
    x = torch.randint(0, 1 << 20, (n,), dtype=torch.int32, generator=gen,
                      device="cuda")
    rest = [torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
            for _ in range(planes - 1)]
    return [x, *rest]


def _designs(kernel, planes, log_t, kk, lo_bit=0, **kw):
    """The plans the checkout can force for this pass of ``kernel`` ({}
    where it has the run-time plan only: a mode without a compile-time
    kernel, ``finish`` before its compile-time plan, the others before
    theirs)."""
    if hasattr(B, "compile_time_plan"):
        both = (kernel in B.TOP_MODES
                and B.compile_time_plan(kernel, planes, log_t, kk, lo_bit,
                                        **kw))
    else:
        both = kernel == "finish" and hasattr(B, "_launch_finish")
    return {"runtime_plan": False, "compile_time_plan": True} if both else {}


def _launch_forced(kernel, planes, ncmp, args, top):
    if kernel == "chunk_sort_cyclic":
        B._launch_cyclic(planes, args[0], ncmp, *args[1:], top)
    elif kernel == "slot_merge":
        B._launch_slot(planes, args[0], ncmp, *args[1:], top)
    elif kernel == "chunk_sort":
        B._launch_chunk(planes, ncmp, *args, False, False, top)
    elif kernel == "cross_stage":
        B._launch_cross(planes, ncmp, *args, False,
                        planes[0].numel().bit_length() - 1, top)
    else:
        B._launch_finish(planes, ncmp, *args, False,
                         planes[0].numel().bit_length() - 1, top)


def _launch_plan(planes, ncmp, tile, phases):
    """One finish launch of the given phases (a cut plan) on the run-time
    plan's kernel."""
    x = planes[0]
    log_t = tile.bit_length() - 1
    codes = [a | b << 6 | hi << 12 | lo << 16 | w << 20
             for a, b, hi, lo, w in phases]
    arg = (ctypes.c_int32 * len(codes))(*codes)
    _build.launch(B.LAUNCHES, "finish" + B._suffix(ncmp, len(planes)),
                  "radx_finish", x.device, B._ptrs(planes), len(planes), ncmp,
                  x.numel(), log_t, 0, x.numel().bit_length() - 1, arg,
                  len(codes), 0)


def case(kernel, mode, log_n, tag, gen, ops_per_s, f=None):
    ncmp, p = MODES[mode]
    n = 1 << log_n
    chunk, fin = SortConfig().mode_tiles(p, ncmp)
    r = B.max_fusion(p)
    lf = fin.bit_length() - 1
    if kernel == "finish":
        planes = _bitonic_tiles(n, fin, p, gen)
        args, subs, lib_view = (fin, log_n), lf, fin
        designs = _designs(kernel, p, lf, log_n)
    elif kernel == "chunk_sort":
        planes = _random_planes(n, p, gen)
        lc = chunk.bit_length() - 1
        args, subs, lib_view = (chunk,), lc * (lc + 1) // 2, chunk
        designs = _designs(kernel, p, lc, lc)
    else:
        planes = _random_planes(n, p, gen)
        args, subs, lib_view = (lf, f, lf + f), f, None
        lct = B.cross_tile(p).bit_length() - 1
        designs = _designs(kernel, p, lct, lf + f, lct - f)
    k, rider, lex = B._keywords(planes, ncmp)
    bound_ms, bound_by = _bound(n, p, subs, ops_per_s)
    row = {"tag": tag, "kernel": kernel, "mode": mode, "n": n,
           **({"f": f, "round_trips": -(-f // r) - 1} if f else
              {"tile": args[0]}),
           "bound_ms": bound_ms, "bound_by": bound_by}
    rule = {"finish": lambda: B.finish(k, *args, rider=rider, lex=lex),
            "chunk_sort": lambda: B.chunk_sort(k, *args, rider=rider,
                                               lex=lex),
            "cross_stage": lambda: B.cross_stage(k, *args, rider=rider,
                                                 lex=lex)}[kernel]
    for _ in range(2):
        row.setdefault("rule", []).append(_ms(rule))
        for name, top in designs.items():
            row.setdefault(name, []).append(_ms(
                lambda: _launch_forced(kernel, planes, ncmp, args, top)))
    if kernel == "finish":
        plan = B.tile_plan(lf, log_n, log_n, r)
        row["phases"] = len(plan)
        row["first_last"] = _ms(lambda: _launch_plan(
            planes, ncmp, fin, (plan[0], plan[-1])))
        outs = [torch.empty_like(q) for q in planes]
        row["copy"] = _ms(lambda: [o.copy_(q) for o, q in zip(outs, planes)])
    if p == 1:
        view = (k.view(-1, lib_view) if lib_view else
                k.view(-1, 1 << f, 1 << args[0]))
        row["library_ms"] = _ms(lambda: torch.sort(view, dim=1))
    else:
        row["library_ms"] = None
    print(json.dumps(row), flush=True)


def radix_case(kernel, mode, log_n, tag, gen, ops_per_s):
    """K4 or K5 of one mode at the radix sort's geometry of 2^log_n keys:
    the rule's pass, then both plans in turns, their outputs held equal."""
    from radx_tpu_torch.kernels import radix_sort as RS

    ncmp, p = MODES[mode]
    cfg = SortConfig(strategy="radix")
    geo = RS.plan(1 << log_n, RS.pick_chunk(1 << log_n, cfg.chunk_elems))
    c, f = cfg.mode_tiles(p, ncmp)
    if kernel == "chunk_sort_cyclic":
        n, tile = 1 << log_n, c
        lt = tile.bit_length() - 1
        first, subs = 1, lt * (lt + 1) // 2
        args = (geo.C, tile)
        designs = _designs(kernel, p, lt, lt)
    else:
        n, tile = geo.nb_pad * geo.C, min(max(f, c), geo.C)
        lt, ls = tile.bit_length() - 1, geo.slot.bit_length() - 1
        first, subs = ls + 1, sum(range(ls + 1, lt + 1))
        args = (geo.C, geo.slot, tile)
        designs = _designs(kernel, p, lt, lt, log_s=ls)
    planes = _random_planes(n, p, gen)
    out = [torch.empty_like(q) for q in planes]
    bound_ms, bound_by = _bound(n, p, subs, ops_per_s)
    row = {"tag": tag, "kernel": kernel, "mode": mode, "n_keys": 1 << log_n,
           "rows": n, "C": geo.C, "tile": tile,
           **({"slot": geo.slot} if kernel == "slot_merge" else {}),
           "round_trips": B.round_trips(lt, first, lt, p),
           "bound_ms": bound_ms, "bound_by": bound_by}
    wrapper = getattr(B, kernel)
    rule = lambda: wrapper(planes, out, ncmp, *args)  # noqa: E731
    outs = {}
    for _ in range(2):
        row.setdefault("rule", []).append(_ms(rule))
        for name, top in designs.items():
            row.setdefault(name, []).append(_ms(
                lambda: _launch_forced(kernel, planes, ncmp, (out, *args),
                                       top)))
            outs[name] = [q.clone() for q in out]
    if designs:
        row["plans_equal"] = all(
            torch.equal(a, b) for a, b in zip(outs["runtime_plan"],
                                              outs["compile_time_plan"]))
    row["library_ms"] = (_ms(lambda: torch.sort(planes[0].view(-1, tile),
                                                dim=1))
                         if p == 1 else None)
    print(json.dumps(row), flush=True)
    if designs and not row["plans_equal"]:
        raise SystemExit(f"{kernel}{B._suffix(ncmp, p)}: the two plans differ")


def _sass(so):
    """{function name: Counter of opcodes} of the library's SASS."""
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True)
    funcs, name = {}, None
    for ln in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = collections.Counter()
        elif name:
            m = re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
            if m:
                op = m.group(2).split(".")[0]
                funcs[name][op] += 1
                if m.group(1) and op == "BRA":
                    funcs[name]["BRA_conditional"] += 1
    return funcs


def _plan_rules(p, log_t, kk=0):
    """Substages of a compile-time plan (``top_plan(log_t, kk, r)``: a
    chunk sort, kk = 0; the levels above a slot, kk = log_s + 1) by the rule
    of their level's direction (top_levels): tile, register, warp (a branch
    one for a warp), lanes (no branch)."""
    r = B.max_fusion(p)
    counts = collections.Counter()
    for ph in B.top_plan(log_t, kk, r):
        kk_a, kk_b, hi, lo, wlo = ph
        for k in range(kk_a, kk_b + 1):
            how = ("tile" if k >= log_t else "register" if k - wlo < r
                   else "warp" if k - r >= 5 else "lanes")
            counts[how] += min(hi, k - 1) - lo + 1
    return dict(counts)


# (launch name, its template arguments) of a tile-engine kernel's mangled
# name: chunk_sort <NCMP, P, LOG_T>, finish <NCMP, P, LOG_T>, cross_stage
# <F, NCMP, P>, chunk_sort_cyclic <NCMP, P, LOG_T>, slot_merge <NCMP, P,
# LOG_T, LOG_S> (LOG_T > 0: a compile-time plan)
_TILE_KERNELS = re.compile(r"(chunk_sort_cyclic|slot_merge|chunk_sort|finish|"
                           r"cross_stage)_kernelI((?:Li\d+E)+)E")


def _instances(so):
    """{(kernel, template arguments): opcode Counter} of a library, the
    arguments without trailing zeros (a run-time plan's LOG_T = 0, which a
    checkout from before the compile-time plans does not have)."""
    out = {}
    for name, ops in _sass(so).items():
        m = _TILE_KERNELS.search(name)
        if m:
            a = [int(x) for x in re.findall(r"Li(\d+)E", m.group(2))]
            while a and a[-1] == 0:
                a.pop()
            # csrc/bitonic_io.cu's overloads of chunk_sort and finish (a
            # sort's first launch reads Sources, its last stores a KeyOut)
            edge = ("/src" if "Sources" in name else
                    "/unbias" if "KeyOut" in name else "")
            out[(m.group(1) + edge, tuple(a))] = ops
    return out


def _predicted(kernel, a):
    """The compile-time plan's substages by rule and, keys only, the
    VIMNMX the layout predicts: 2^R a substage in each body its level
    runs (two for a warp's bit, one otherwise)."""
    if kernel == "cross_stage" or len(a) < 3:
        return {}
    p, log_t = a[1], a[2]
    kk = {"chunk_sort": 0, "chunk_sort_cyclic": 0, "finish": log_t,
          "slot_merge": a[3] + 1 if len(a) > 3 else 0}[kernel.split("/")[0]]
    rules = _plan_rules(p, log_t, kk)
    w = 1 << B.max_fusion(p)
    vimnmx = w * (sum(rules.values()) + rules.get("warp", 0))
    return {"plan_substages_by_rule": rules,
            **({"predicted_VIMNMX": vimnmx} if p == 1 else {})}


def sass_report(against=None):
    """The opcode counts of every tile-engine kernel instance, those on a
    compile-time plan beside the plan's prediction; with ``against``
    (another library) whether each instance both have has the same counts."""
    mine = _instances(_build.build())
    other = _instances(against) if against else {}
    keep = ("IMNMX", "VIMNMX", "ISETP", "SEL", "LOP3", "BRA",
            "BRA_conditional", "BSSY", "BSYNC", "WARPSYNC", "LDS", "STS",
            "LDG", "STG", "BAR")
    for (kernel, a), ops in sorted(mine.items()):
        row = {"sass": kernel, "template": list(a),
               "instructions": sum(v for k, v in ops.items()
                                   if k != "BRA_conditional"),
               **{k: ops.get(k, 0) for k in keep}, **_predicted(kernel, a)}
        if (kernel, a) in other:
            theirs = other[(kernel, a)]
            row["same_as_against"] = theirs == ops
            if theirs != ops:
                row["differs"] = {k: [theirs.get(k, 0), ops.get(k, 0)]
                                  for k in set(theirs) | set(ops)
                                  if theirs.get(k, 0) != ops.get(k, 0)}
        print(json.dumps(row), flush=True)
    if other:
        common = [k for k in mine if k in other]
        print(json.dumps({"sass_against": str(against),
                          "instances_compared": len(common),
                          "identical": sum(mine[k] == other[k]
                                           for k in common)}), flush=True)


def run_probe(ops_per_s):
    """The card's 32-bit integer min / max rate: tools/int_rate.cu built
    here, its IMNMX instructions counted in the compiled code, times the
    loop's iterations and the threads, over the time of a launch."""
    src = pathlib.Path(__file__).with_name("int_rate.cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "int_rate_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], capture_output=True, text=True,
                   check=True)
    (ops,) = _sass(so).values()
    per_iter = ops.get("IMNMX", 0) + ops.get("VIMNMX", 0)  # all in the loop
    lib = ctypes.CDLL(str(so))
    lib.int_minmax_launch.argtypes = (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p)
    lib.int_minmax_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * 8, 256, 1 << 14
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")

    def launch():
        code = lib.int_minmax_launch(
            out.data_ptr(), 12345, iters, blocks,
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"int_minmax launch failed: {code}")

    seconds = timing.time_cuda(launch, iters=3, repeats=5).seconds
    clocks = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    measured = per_iter * iters * blocks * threads / seconds
    return {"probe": "int32 min/max", "imnmx_per_iteration": per_iter,
            "sass_opcodes": dict(ops), "ms": seconds * 1e3,
            "measured_ops_per_s": measured, "assumed_ops_per_s": ops_per_s,
            "measured_over_assumed": measured / ops_per_s,
            "per_clock_sm_at_max_clock":
                measured / ops_per_s * INT_OPS_PER_CLOCK_SM,
            "sms": sms, "clocks_sm_after": clocks.strip()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sass-against", default=None)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args(argv)
    timing.require_cuda()
    _build.load()
    ops_per_s = int_ops_per_s()
    if args.probe:
        print(json.dumps(run_probe(ops_per_s)), flush=True)
    if args.sass or args.sass_against:
        sass_report(args.sass_against)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel in filter(None, args.kernels.split(",")):  # "": none timed
        if kernel in ("chunk_sort_cyclic", "slot_merge"):
            for log_n in RADIX_SIZES:
                for mode in MODES:
                    radix_case(kernel, mode, log_n, args.tag, gen, ops_per_s)
                    torch.cuda.empty_cache()
            continue
        if kernel == "cross_stage":
            todo = [(mode, CROSS_SIZES[mode], f) for mode, (_, p) in
                    MODES.items()
                    for f in range(B.max_fusion(p) + 1,
                                   B.cross_fusion(p) + 1)]
        else:
            todo = [(mode, log_n, None) for mode, log_n in SIZES]
        for mode, log_n, f in todo:
            case(kernel, mode, log_n, args.tag, gen, ops_per_s, f)
            torch.cuda.empty_cache()
    print(timing.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
