"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits nonzero):

  1. the card: name, count, torch and CUDA versions, nvidia-smi name and
     power limit;
  2. build the kernels from radx_tpu_torch/csrc/ with nvcc (sm_90a, one
     process per source) and print ptxas's register / shared-memory / spill
     report for every instantiated kernel (a spill fails the run);
  3. every kernel against its plain PyTorch version on the card: the bitonic
     kernels on 2^23 rows (keys only; a rider on keys in [0, 16); and the
     lexicographic mode for 2..8 planes on keys in [0, 16) with a unique
     tie plane, every plane bit-equal; the cross / finish passes with a
     direction span; every cross pass up to the cap, ``cross_fusion(P)``:
     the register pass up to ``max_fusion(P)`` distances, the strided tile
     pass above, ascending and descending, under a span in the keys, rider
     and lex2 modes, and at 2^28 keys), ``finish`` on both of its kernels
     (the run-time plan and, at levels at or above the mode's finish tile,
     the compile-time plan: ``forced``), also at 2^28 keys and 2^28
     lex2, ``chunk_sort`` / the strided cross pass / ``finish`` on the
     register tile engine in every mode at 2^20 rows, each on both of its
     plans wherever the compile-time plan applies
     (``tile_engine_checks``: the paths' tiles and the tiny tiles 2..32,
     invert, ascending, finish below, at and above the tile's level and as
     a span pass, every strided pass of the mode's cap over its cross tile,
     tied lex planes), and
     on the same engine ``chunk_sort_cyclic`` / ``slot_merge`` in every
     mode, each on both of its plans wherever the compile-time plan
     applies (radix chunks of one and of several tiles and the radix
     geometries' C = 2^19, slots below, at and above the tile and of 1024
     and 4096, planes not 16-byte aligned), the single-pass
     ``compact`` and ``segscan`` (``single_pass_checks``: bool and int32
     masks, 0-4 planes (0: the count), densities 0, 0.5 and 1, offset
     planes, every op x value dtype and fill with 1-4 planes on 5000 / 7 /
     1 groups and all-equal keys, the many-tile cases three times with the
     same bits,
     the float32 sum bit-equal to the CPU model), the dense aggregates
     (sums for 128 / 256 / 8192 / 65536 bins, extrema for 128 / 256 / 8192)
     at 2^26 rows with a ragged n_valid on uniform, one-key, Zipf and
     out-of-range keys; the radix kernels (``radix_checks``): radix_hist at
     2^26 (K10's chunks with the totals row and K14's tiles, ragged n, bias
     0 and 0x80000000, shifts 0 / 8 / 16 / 24, all-equal and two-valued
     keys), and K4, K11 (splitters, ranks, run bounds, overflow flag and
     segment tables in one launch), K12, K5, K13 at the radix geometries of
     2^26 keys (keys, rider, lex2, lex3) and 2^28 keys (keys, lex3), K11
     also on a rider sort's tail of pads (n_valid = 3 * 2^24) and on
     overflowing keys, and the radix sort's first and last launches
     (``_radix_source_check``: K4's source form on both plans from the
     caller's columns, a ragged column at an odd offset and a piece's
     row0, the counts read from the key source, K13's unbiasing form in
     place and into n - 3 rows) at 2^26 (keys, rider, lex2) and 2^28
     (keys, lex2); ``gather_planes`` (``gather_checks``: both routes,
     the partitioned one step by step too: index mode with one source at
     2^28 and 1..4 sources at 2^26 + 4099 on an unaligned index plane with
     out-of-range indices, tagged mode on the join's union of 2 x 10^8 rows
     and on ties with pads, the skew cases at 2^26, the direct route up to
     one window); ``merge_runs`` (``merge_checks``: 1 to 4 planes, runs
     of 0 to 2^27 rows, shorter than a tile and a tile and a row either
     side, runs and outputs that start 1-3 rows past a 16-byte boundary,
     all-equal and 0xFFFFFFFF keys, both rows-a-thread variants); a sort's
     first and last launches (``edge_checks``: chunk_sort's source form and
     finish's unbiasing form, keys, rider, lex2 and the join's lex2 of two
     key columns and a tie made from the row, each on both plans: columns
     0..3 rows past a 16-byte boundary, n at and one either side of a
     16-row run and equal to the planes' rows, join splits at 0, 1, a run
     boundary and one either side, and n, stores in place and into n rows,
     a descending arbitrary-N piece whose sources start past row 0);
  4. the paths through the public entry points, each in a window of its
     own (``window``): the launch counts are set to 0 just before the path
     and read just after it, and every kernel the path runs must show >= 1
     launch, with 0 plain-version calls (the sort windows of slices 1-3
     also >= 1 launch of chunk_sort, finish and each strided pass on its
     compile-time plan: ``compile_time_plan_launches``; the radix windows
     of ``chunk_sort_cyclic`` and, where no bucket overflows,
     ``slot_merge`` on theirs: ``radix_top``; the windows of the sorts
     whose planes the sort's own first and last launches make (slice 1's
     ``sort``, config 2, ``assume_unique``, ``argsort``, ``sort_multi``,
     the joins, the q3 group-by, the shards' local sorts, the radix
     windows, the suite's sort, unique-pairs, group-by, argsort and
     arbitrary-N configs, the oracle's and the scaling model's sorts) also
     fail on any call of PyTorch's preparation on the card,
     ``ops/sort.PREP_CALLS`` (``prep="none"``), and the suite's radix
     windows, whose gate replays the radix stage on a plane it prepares,
     unless it runs (``prep="runs"``)):
       a. ``sort`` / ``sort_any`` (slice 1), bit-equal to ``torch.sort``;
       b. the sort-based config-3 query at 2^28 rows and the other group-by
          / unique inputs (slice 2), against plain torch references;
       c. slice 3 (the arbitrary-N windows ``groupby_rider_arbn_1e8`` and
          ``config4_join_inner_1e8`` also print their valley merges'
          overhangs, each required to be one row-limited ``cross_stage<1>``
          launch): BASELINE config 3 at 2^30 rows through LazyTable and the
          dense group-by under ``torch.cuda.set_sync_debug_mode("error")``
          until ``collect()`` (peak device memory printed), then K8 / K9
          against their plain versions on that path's own inputs; config 4,
          ``Table.join`` of two 10^8-row tables, inner and left (float32
          build values), the union sorted at its own length (pieces of
          2^27 and 2^26 rows, their lengths printed); ``LazyTable.join``
          under ``"radix"`` and the sync guard with a union in pieces (no
          radix kernel, no host read); the multi-match join at 2^24 with
          ``truncated``;
          config 2, stable ``sort_pairs`` of 2^28 pairs and
          ``assume_unique`` on a permutation; ``argsort`` (also at a
          non-power-of-two n on the arbitrary-N path), ``sort_multi``,
          ``sort_u64``, 64-bit ``sort_any``, ``top_k``, ``LazyTable.sort_by``
          on 2..6 columns (lex4..lex8; the joins, ``sort_pairs`` and
          ``sort_multi`` sort two planes and gather the rest); the
          query_pipeline
          example at 2^26 rows, eager and lazy — all exactly equal to plain
          torch (or numpy) references;
       d. slice 4 (``radix_path``), under ``SortConfig(strategy="radix")``:
          ``sort`` at 2^26 and 2^28, ``sort`` at 2^26 on presorted, reverse,
          clustered and low-cardinality keys, stable ``sort_pairs`` at 2^28
          (lex2 and the gather), ``argsort`` at 2^26 (lex2), ``groupby`` sum
          at 3 * 2^24
          (the rider mode, n_valid = total: a quarter of the rows are pads),
          all-equal keys at 2^23 (the overflow
          fallback to the network) and ``tile_histograms`` (K14) at 2^26,
          each window printing its overflow count, every result exact;
          every radix sort makes its planes in its own first and last
          launches (K4's and K13's forms required, the fallback network's
          from the same sources: 0 ``PREP_CALLS``);
       e. slice 9: the host copies that chose the streaming operators'
          staging (pageable and pinned rates, pinned allocation,
          ``cudaHostRegister``, host copies at 1-8 threads, pieces of 8-512
          MiB, the staging ring each way), BASELINE config 3 eager at 2^30
          rows from host memory (``filter_chunked`` + ``groupby_chunked``;
          rows/s, its phases, peak device memory and slab beside the
          LazyTable query's rate) and ``sort_chunked`` (8 runs of 2^26, and
          one slab), each checked to have moved every piece through pinned
          memory on a copy stream (the staged GB/s each way); the distributed
          sort on an in-process mesh of 8 shards on the one card, 2^28
          keys (flat with and without overlap, hier, stable and unstable
          pairs, argsort, ``_auto`` on presorted keys, ragged n on 6
          shards, all-0xFFFFFFFF keys with payloads), one NCCL rank through
          ``init_multihost`` / ``sort_sharded_guarded`` at 2^26 and
          ``dryrun_multichip(8)``: every result exact against torch (or
          numpy), every window launching ``merge_runs`` (the runs merged
          at their own length), every rate beside the
          one-device ``sort`` and the call's peak device memory;
       f. slice 10: every config of ``radx_tpu_torch.bench_suite`` but
          ``sort_chunked_1g``, each gated and then timed in a window that
          requires its op's kernels (one row each with its peak device
          memory; ``arbn_600m`` with the power-of-two rate beside it), the
          radix / bitonic A/B of radx_tpu_torch/tools/bench_strategies.py
          at 2^23 and 2^26, ``tuned()`` (the H100 row of ``TUNING``) and
          ``utils.timing.trace`` (a Chrome trace that ``json.load`` reads);
       g. slice 11 (``last_modules_path``): the count-only filter,
          ``filter_columns(mask, [])`` at 2^26 and 2^30 (bool and int32
          masks; ``compact`` with no planes against its plain version, the
          one-plane count and ``torch.count_nonzero``) and
          ``filter_chunked(mask, [])`` over three slabs; the scaling model
          (radx_tpu_torch/tools/scaling_model.py): its rates measured on the
          card, the exchange audit on 8 shards (flat and 4 x 2 hier: the
          model's waves and output row, every run and phase within the
          model's bytes), the calibration line, the model's table and its
          trace
          of the 8-shard sort; BASELINE config 1 against the host C++
          oracle (``radx_tpu_torch.oracle`` / ``.runtime``: 2^26 keys of
          the three host generators, bit-equal, ``validate_sort`` 0; stable
          pairs at 2^22); ``utils.debug.interpret_parity`` of ``sort`` at
          2^20 (card against CPU) and ``checked(sort)`` at 2^26;
  5. timings (CUDA events): every kernel beside its plain version, its bound
     (bytes over 3.35 TB/s or 32-bit integer operations over the card's
     rate, SMs x 64 a clock x its maximum SM clock: 16.7 T/s on an H100
     SXM; the larger) and, where
     one PyTorch call computes the same function, that call (the tile
     engine's kernels with their shared-memory round trips per tile;
     ``gather_planes`` at config 2's, ``sort_multi``'s and the join's
     shapes through both routes (the direct kernel and the partitioned
     route, whole and step by step) beside ``index_select`` and the
     partitioned route's floor;
     ``merge_runs`` at 2^24 + 2^24 and 2^27 + 2^27 rows (keys)
     and 2^24 + 2^24 in lex2 with a payload, beside a stable ``torch.sort``
     of the concatenation; the pairwise tree of a shard's arrivals
     (``dist_sort._Merger``) at 8 x 2^22 and 4 x 2^27 keys beside the
     bound of one pass;
     ``cross_stage<1>`` at the last merge level and ``finish`` on bitonic
     tiles, each first held equal to ``torch.sort`` of its view; ``finish``
     at 2^28 keys and 2^28 lex2, and its two plans in turns at 2^26 and
     2^28 keys and 2^28 lex2; ``chunk_sort``'s two plans in turns at 2^23,
     2^26 and 2^28 keys, rider 2^26, lex2 2^28 and lex3 2^26, the
     strided cross pass's at F = 5..10 for 2^28 keys and F = 5..9 for 2^28
     lex2, and ``chunk_sort_cyclic``'s and ``slot_merge``'s at the radix
     cells' shapes, keys and lex2 at 2^28 (slots of 1024) and rider at
     2^26 (slots of 4096) (``in_turns``: ``... in turns`` context lines);
     the valley
     merge's overhang (the
     row-limited ``cross_stage<1>``) at q3's and the join's shapes held
     bit-equal to its plain version ``_cx_directed``, ascending and
     descending, and timed beside it;
     chunk_sort's source form and finish's unbiasing form at 2^28 keys,
     2^26 (key, rider) and 2^28 (key, index), each held bit-equal to its
     plain version, timed beside it and its bound, then in turns with the
     in-place kernel of the same plan (``edge_timings``); K4's source form
     and K13's unbiasing form likewise at 2^26 (keys, rider, lex2) and
     2^28 (keys, lex2), in turns with the in-place K4 and with K13's plain
     form (``radix_edge_timings``), with ptxas's registers;
     ``cross_stage<2..10>`` likewise on columns bitonic along the 2^F
     axis, at 2^23 and 2^26 keys, and at 2^28 beside its plain version;
     the cross passes with their shared-memory round trips); then the
     metrics of radx_tpu_torch/bench.py, the radix ones with the
     bitonic rate beside them, both countings of radix_hist on uniform,
     all-equal and two-valued keys (``bench.sweep_hist``), the breakdowns
     by kernel of the keys-only sort (2^23, 2^26), group-by, join, the dense
     query and radix sort (with its idle share by phase), and K11's launch
     beside the composition it replaces (``bench.measure_launch``).

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import re
import sys
import time

import numpy as np
import torch

SIGN = -(1 << 31)
PAD = 0x7FFFFFFF
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 bandwidth
# 32-bit integer operations a second (tools/finish_bench.py int_ops_per_s:
# SMs x 64 a clock x the maximum SM clock), set in main before any timing
OPS_PER_S = None


def _line(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def _fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def _suffix(ncmp, planes):
    return f"/lex{planes}" if ncmp == 2 else ("/rider" if planes == 2 else "")


def _ptxas_name(kernel, args):
    """Readable name of a compiled kernel from its template arguments."""
    a = [int(x) for x in re.findall(r"L[ib](\d+)E", args or "")]
    from radx_tpu_torch.kernels import bitonic as B

    if kernel == "cross_stage":  # F = 0: the strided tile pass
        top = "/top" if a[0] > B.max_fusion(a[2]) else ""  # compile-time
        return (f"cross_stage<{a[0] or 'strided'}>"
                + _suffix(a[1], a[2]) + top)
    if kernel in ("chunk_sort", "finish", "chunk_sort_cyclic") and a[2:3] \
            and a[2]:  # compile-time plan
        return f"{kernel}{_suffix(a[0], a[1])}/top"
    if kernel == "slot_merge" and a[2]:  # compile-time plan of one slot
        return f"slot_merge{_suffix(a[0], a[1])}/top<slot {1 << a[3]}>"
    if kernel in ("chunk_sort", "finish", "chunk_sort_cyclic", "slot_merge",
                  "radix_pack", "radix_concat"):
        return kernel + _suffix(a[0], a[1])
    if kernel == "dense_extrema":
        return f"dense_extrema<{'min' if a[0] else 'max'}>"
    if kernel == "segscan":
        op = ("sum", "min", "max", "fill")[a[0]]
        dt = ("u32", "i32", "f32")[a[1]]
        return f"{kernel}<{op}{a[2] if op == 'fill' else ','+dt}>"
    if kernel == "compact":
        return f"compact<P{a[0]},mask{a[1]}B>"
    if kernel == "gather_planes":
        return ({1: "gather_planes/tagged", 2: "gather_planes/side"}.get(a[1])
                or f"gather_planes<{a[0]}>")
    if kernel == "merge_runs":  # compare planes, planes, rows a thread
        return f"merge_runs<{a[0]},{a[1]},{a[2]}>"
    if kernel.startswith("gather_"):
        tag = "tagged/" if a and a[0] else ""
        return f"gather_planes/{tag}{kernel[len('gather_'):]}"
    return kernel + (f"<{a[0]}>" if a else "")


def ptxas_report(log):
    """ptxas's registers / shared memory / spills of every instantiated
    kernel, from the build log, by readable kernel name."""
    ptxas, kernel = {}, None
    for ln in log.read_text().splitlines():
        found = re.search(
            r"Compiling entry function .*?(chunk_sort_cyclic|slot_merge|"
            r"chunk_sort|finish|cross_stage|radix_hist|radix_rank|radix_pack|"
            r"radix_concat|compact|segscan|dense_sums_smem|dense_sums_global|"
            r"dense_extrema|gather_planes|gather_count|gather_scan|"
            r"gather_part|gather_place|merge_runs)_kernel"
            r"(I(?:L[ib]\d+E)+E)?", ln)
        if found:
            kernel = _ptxas_name(found.group(1), found.group(2))
            # csrc/bitonic_io.cu's overloads: a sort's first and last launch
            edge = ("/src" if "Sources" in ln else
                    "/unbias" if "KeyOut" in ln else "")
            kernel = kernel.replace(found.group(1), found.group(1) + edge, 1)
        elif kernel and ("Used" in ln or "spill" in ln):
            info = ln.split(":", 1)[-1] if "ptxas info" in ln else ln
            ptxas[kernel] = f"{ptxas.get(kernel, '')} {info.strip()}".strip()
    return ptxas


def _segscan_tol(tsg, k, v, got, want):
    """max |got - want| and whether it is within 1e-5 x the run's running
    sum of |v| (float32 sums)."""
    absv = tsg.segscan_ref(k, v.view(torch.float32).abs().view(torch.int32),
                           "sum", torch.float32).view(torch.float32)
    err = (got.view(torch.float32) - want.view(torch.float32)).abs()
    return float(err.max()), bool((err <= 1e-5 * absv).all())


def _float_group_ref(enc_keys, vals):
    """Per-group float64 sum, sum of |v|, min and max of float32 values,
    grouped by the int32 ``enc_keys`` (ascending)."""
    order = torch.sort(enc_keys, stable=True)
    uk, counts = torch.unique_consecutive(order.values, return_counts=True)
    v = vals[order.indices]
    group = torch.repeat_interleave(
        torch.arange(uk.numel(), device=v.device), counts)
    z = torch.zeros(uk.numel(), dtype=torch.float64, device=v.device)
    sums = z.scatter_add(0, group, v.double())
    abss = z.scatter_add(0, group, v.double().abs())
    mins = torch.full_like(z, float("inf")).scatter_reduce(0, group, v.double(),
                                                           "amin")
    maxs = torch.full_like(z, -float("inf")).scatter_reduce(
        0, group, v.double(), "amax")
    return uk, counts, sums, abss, mins, maxs


def _i32(x):
    return x.view(torch.int32)


def _biased_order(bits):
    """Stable order of int32 sign-biased keys (torch.sort)."""
    return torch.sort(bits, stable=True).indices


AGGS = ("sum", "count", "min", "max")
TOTAL_LAUNCHES: dict[str, int] = {}  # launches of every path, summed
ERR: dict[str, float] = {}  # max |kernel - plain version| per kernel


def record(names, e, ok, **case):
    """One kernel-vs-plain comparison: keep its error, fail if it differs."""
    for name in names:
        ERR[name] = max(ERR.get(name, 0.0), e)
    _line("kernel", name="+".join(names), equal=ok, max_abs_err=e, **case)
    if not ok:
        _fail(f"{names} differ from the plain version ({case})")


def _kernel_modules():
    from radx_tpu_torch.kernels import (aggregate, bitonic, compact, gather,
                                        merge, msd, radix, segscan)

    return bitonic, compact, segscan, aggregate, radix, msd, gather, merge


def bound(bytes_, ops=0):
    """(ms, "bytes" | "operations"): the least time the card could take for
    this many bytes moved and 32-bit integer operations done."""
    tb, to = bytes_ / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def _cx_ops(n, substages, planes):
    """32-bit operations of ``substages`` compare-exchange substages over n
    rows: a min and a max per pair with one plane; one compare and two
    selects per plane with more."""
    per_pair = 2 if planes == 1 else 1 + 2 * planes
    return n // 2 * substages * per_pair


MODES = {"keys": (1, 1), "rider": (1, 2), "lex2": (2, 2), "lex3": (2, 3)}
# sizes of the radix phases: the checks and most windows, the large
# windows, the all-equal window
RADIX_N, RADIX_N_BIG, RADIX_N_EQUAL = 1 << 26, 1 << 28, 1 << 23


def radix_required(ncmp, planes, unbias=True):
    """Every kernel a radix sort of one mode launches when no bucket
    overflows: the mode's cross / finish passes (spans), K4 reading the
    caller's columns (its source form), K5, K10-K12, K13 (its unbiasing
    form where the keys come back: ``unbias``), and the keys-only chunk
    sort of the >= 2^17 splitter samples (K4 takes the place of the mode's
    own chunk sort)."""
    from radx_tpu_torch import SortConfig
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import msd as M
    from radx_tpu_torch.kernels import radix_sort as RS

    # the levels above the tile run inside radix chunks of RS.MAX_CHUNK rows
    fin = SortConfig().mode_tiles(planes, ncmp)[1]
    distances = RS.MAX_CHUNK.bit_length() - fin.bit_length()
    pack, concat = M.mode_kernels(ncmp, planes)
    return (*B.mode_kernels(ncmp, planes, distances)[1:],
            B.radix_source_kernel(ncmp, planes),
            B.radix_kernels(ncmp, planes)[1], pack,
            M.unbias_kernel(ncmp, planes) if unbias else concat,
            "radix_hist", "radix_rank", "chunk_sort")


def radix_top(ncmp, planes, merge=True):
    """The radix tile passes that a radix sort of one mode runs on their
    compile-time plans (``bitonic.TOP_MODES``): K4 (its source form), and
    K5 where no bucket overflows (``merge``); every slot of the paths'
    geometries has a K5 instance."""
    from radx_tpu_torch.kernels import bitonic as B

    names = zip((B.radix_source_kernel(ncmp, planes),
                 B.radix_kernels(ncmp, planes)[1]),
                ("chunk_sort_cyclic", "slot_merge"))
    return tuple(k for k, kernel in names if planes in B.TOP_MODES[kernel]
                 and (merge or kernel == "chunk_sort_cyclic"))


def radix_overflows(ncmp, planes):
    """(radix sorts, overflowed ones) of the last window: every sort ranks
    its splitters once and packs only when no slot overflowed."""
    from radx_tpu_torch.kernels import msd as M

    ranks = M.LAUNCHES["radix_rank"]
    return ranks, ranks - M.LAUNCHES[M.mode_kernels(ncmp, planes)[0]]


def _mode_planes(dev, mode, n, gen):
    """Planes of a mode at n rows: keys with ties (a quarter drawn from n /
    2^14 values spread over the key range, 4096 copies each, so no digit
    holds a cluster that overflows a slot), 1% 0xFFFFFFFF keys in the rider
    mode (they skip the buckets); the index plane of the stable sorts in the
    lex modes; random riders."""
    ncmp, p = MODES[mode]
    keys = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                         generator=gen, device=dev)
    values = n >> 14
    keys[: n // 4] = (torch.randint(0, values, (n // 4,), generator=gen,
                                    device=dev) * ((1 << 32) // values)
                      - 2**31).to(torch.int32)
    if mode == "rider":
        keys[n // 4: n // 4 + n // 100] = PAD
    keys = keys[torch.randperm(n, generator=gen, device=dev)]
    planes = [keys]
    if ncmp == 2:
        planes.append(torch.arange(n, dtype=torch.int32, device=dev))
    while len(planes) < p:
        planes.append(torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                                    generator=gen, device=dev))
    return planes


def forced(kernel, top):
    """``bitonic.<kernel>`` ("chunk_sort", "cross_stage" or "finish", with
    that wrapper's positional arguments after the keys; "chunk_sort_cyclic"
    or "slot_merge", with that wrapper's arguments) with its plan forced:
    the compile-time plan (``top``) or the run-time plan, whatever the rule
    (``compile_time_plan``) would pick."""
    from radx_tpu_torch.kernels import bitonic as B

    if kernel in ("chunk_sort_cyclic", "slot_merge"):
        launch = (B._launch_cyclic if kernel == "chunk_sort_cyclic"
                  else B._launch_slot)

        def run_io(src, dst, ncmp, *args):
            launch(src, dst, ncmp, *args, top)
            return dst

        return run_io

    def run(x, *args, invert=False, ascending=False, rider=None, lex=None,
            span=None):
        planes, ncmp = B._planes(x, rider, lex)
        if kernel == "chunk_sort":
            B._launch_chunk(planes, ncmp, *args, invert, ascending, top)
        elif kernel == "cross_stage":
            B._launch_cross(planes, ncmp, *args, invert, B._log_span(x, span),
                            top)
        else:
            B._launch_finish(planes, ncmp, *args, invert,
                             B._log_span(x, span), top)
        return x

    return run


def plans(kernel, planes, log_t, kk, lo_bit=0, **kw):
    """The plans a tile pass of ``kernel`` can take: the run-time plan, and
    the compile-time plan where it applies (``compile_time_plan``; a slot
    merge's ``log_s`` in ``kw``)."""
    from radx_tpu_torch.kernels import bitonic as B

    return ((False, True) if B.compile_time_plan(kernel, planes, log_t, kk,
                                                 lo_bit, **kw) else (False,))



def _max_err(got, want):
    return max(int((a.long() - b.long()).abs().max()) for a, b in
               zip(got, want))


def tile_engine_checks(dev, cfg):
    """Phase 3 for the kernels on the register tile engine, ``chunk_sort``
    (K1), the strided cross pass (K2, f > R), ``finish`` (K3),
    ``chunk_sort_cyclic`` (K4) and ``slot_merge`` (K5), in every mode (keys,
    rider, lex2..lex8), at 2^20 rows: the tiles the paths use
    (``cfg.mode_tiles``) and the tiny tiles 2..32 (below and around one
    thread's 2^R rows); chunk_sort with ``invert`` and ``ascending``;
    finish at kk below, at and above log2(tile) and as a span pass (2^19);
    every strided pass of the mode's cap over its cross tile (the lowest
    distance just above the segment) at the level just above the pass and
    at the top level, inverted, and as a span pass; each of the five on
    both of its plans wherever the compile-time plan applies (``forced``);
    K4 with radix chunks of one tile (or 1024 rows), of 2^17 rows (several
    tiles) and of 2^19 (the radix geometries' C); K5 in chunks of 2^17 rows
    with slots a quarter and half of the tile (one level), the tile and
    twice it (the empty plan: a copy), and the radix geometries' slots of
    1024 and 4096 at the paths' tiles, in chunks of 2^17 and of 2^19; K4
    and K5 again on planes offset by one row (not 16-byte aligned: no int4
    rows).  Keys in [0,
    16); in the lex modes plane 1 in [0, 4), so (plane 0, plane 1) ties
    too; random riders.  Every plane of every case bit-equal to the plain
    version; one line per kernel instance and plan."""
    from radx_tpu_torch.kernels import bitonic as B

    n, span = 1 << 20, 1 << 19
    gen = torch.Generator(device=dev).manual_seed(71)

    def rand(lo, hi):
        return torch.randint(lo, hi, (n,), dtype=torch.int32, generator=gen,
                             device=dev)

    for ncmp, p in B.MODES:
        planes = [rand(0, 16)] + ([rand(0, 4)] if ncmp == 2 else [])
        while len(planes) < p:
            planes.append(rand(-(2**31), 2**31))
        k, rider, lex = B._keywords(planes, ncmp)
        r = B.max_fusion(p)
        tiles = sorted({2, 4, 8, 16, 32, *cfg.mode_tiles(p, ncmp)})
        # (op, args after the keys, keywords, the plans)
        cases = []
        for tile in tiles:
            lt = tile.bit_length() - 1
            for inv, asc in ((False, False), (True, False), (False, True)):
                cases.append(("chunk_sort", (tile,),
                              dict(invert=inv, ascending=asc),
                              plans("chunk_sort", p, lt, lt)))
            for kk, inv, sp in ((max(1, lt - 2), False, None),
                                (lt, True, None), (lt + 3, False, None),
                                (19, True, span)):
                cases.append(("finish", (tile, kk),
                              dict(invert=inv, span=sp),
                              plans("finish", p, lt, kk)))
        ct = B.cross_tile(p).bit_length() - 1
        for f in range(r + 1, B.cross_fusion(p) + 1):
            j = ct - f + 1
            for kk, inv, sp in ((j + f, False, None), (20, True, None),
                                (19, False, span)):
                cases.append(("cross_stage", (j, f, kk),
                              dict(invert=inv, span=sp),
                              plans("cross_stage", p, ct, kk, ct - f)))
        for op in ("chunk_sort", "cross_stage", "finish"):
            ref = getattr(B, op + "_ref")
            worst, count = {}, {}
            for name, args, kw, tops in cases:
                if name != op:
                    continue
                want = ref(k, *args, rider=rider, lex=lex, **kw)
                want = want if isinstance(want, tuple) else (want,)
                for top in tops:
                    got = [q.clone() for q in planes]
                    gk, grd, glx = B._keywords(got, ncmp)
                    forced(op, top)(gk, *args, rider=grd, lex=glx, **kw)
                    torch.cuda.synchronize()
                    e = _max_err(got, want)
                    if e:
                        record([op + _suffix(ncmp, p)], e, False, n=n,
                               args=args, compile_time_plan=top, **kw)
                    worst[top] = max(worst.get(top, 0), e)
                    count[top] = count.get(top, 0) + 1
            for top, e in worst.items():
                trips = {t: B.round_trips(t.bit_length() - 1, 1,
                                          t.bit_length() - 1, p)
                         if op == "chunk_sort" else B.round_trips(
                             t.bit_length() - 1, 30, 30, p) for t in tiles}
                record([op + _suffix(ncmp, p)], e, e == 0, n=n,
                       compile_time_plan=top, cases=count[top],
                       **({} if op == "cross_stage" else
                          {"tiles": tiles, "round_trips": trips}))
        _radix_tile_checks(planes, ncmp, cfg)


def _offset(planes):
    """Copies of the planes one row into a fresh buffer: contiguous views
    whose data is 4 bytes past a 16-byte boundary."""
    out = []
    for q in planes:
        view = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)[1:]
        out.append(view.copy_(q))
    return out


def _launch_edge(kernel, top):
    """``bitonic``'s launch of chunk_sort's source form ("chunk_sort/src")
    or finish's unbiasing form ("finish/unbias") with its plan forced (the
    compile-time one where ``top``), whatever the rule would pick."""
    from radx_tpu_torch.kernels import bitonic as B

    if kernel == "chunk_sort/src":
        return lambda planes, ncmp, chunk, invert, sources, row0, key_out: (
            B._launch_chunk_src(planes, ncmp, chunk, invert, sources, row0,
                                key_out, top))
    return lambda planes, ncmp, tile, kk, invert, key_out: (
        B._launch_finish_out(planes, ncmp, tile, kk, invert,
                             B._log_span(planes[0], None), key_out, top))


def _edge_case(name, sources, ncmp, total, chunk, key_rows, row0=0,
               invert=False, **case):
    """One set of sources through chunk_sort's source form and then
    finish's unbiasing form at the top level, each on both of its plans
    where the compile-time plan applies, bit for bit against the plain
    versions on the same inputs: the planes from ``source_planes_ref``
    sorted by ``chunk_sort_ref``; ``finish_ref`` on those.  Plane 0 is
    stored three ways by the chunk sort (as a plane, unbiased in place,
    unbiased into ``key_rows`` rows of a new output, the rows past it
    untouched) and two by finish; the other planes stay in place."""
    from radx_tpu_torch.kernels import bitonic as B

    dev = sources[0].cols[0].device if sources[0].cols else "cuda"
    p = len(sources)
    first, last = B.source_kernels(ncmp, p)
    made = B.source_planes_ref(sources, row0, total, dev)
    k, rd, lx = B._keywords(made, ncmp)
    want = B.chunk_sort_ref(k, chunk, invert=invert, rider=rd, lex=lx)
    want = want if isinstance(want, tuple) else (want,)
    log_c = chunk.bit_length() - 1
    tile = min(B.top_tile(p), total)
    log_n = total.bit_length() - 1
    k, rd, lx = B._keywords(list(want), ncmp)
    fin = B.finish_ref(k, tile, log_n, invert, rider=rd, lex=lx)
    fin = fin if isinstance(fin, tuple) else (fin,)

    def stored(planes, out, ref):
        """max |difference| of the planes and plane 0's store."""
        e = _max_err(planes[1:], ref[1:]) if p > 1 else 0
        if out is None:
            return max(e, _max_err(planes[:1], ref[:1]))
        m = out.numel() - 4  # 4 guard rows past the output
        e = max(e, _max_err([out[:m]], [ref[0][:m] ^ SIGN]))
        return e if bool((out[m:] == 7).all()) else max(e, 1)

    for kernel, ref, plans_ in (
            (first, want, plans("chunk_sort", p, log_c, log_c)),
            (last, fin, plans("finish", p, tile.bit_length() - 1, log_n))):
        for top in plans_:
            stores = ("plane", "in_place", "rows") if kernel == first else (
                "in_place", "rows")
            for how in stores:
                if kernel == first:
                    planes = [torch.full((total,), 7, dtype=torch.int32,
                                         device=dev) for _ in range(p)]
                else:
                    planes = [w.clone() for w in want]
                out = (None if how == "plane" else planes[0]
                       if how == "in_place" else torch.full(
                           (key_rows + 4,), 7, dtype=torch.int32, device=dev))
                key_out = None if out is None else (
                    out if how == "in_place" else out[:key_rows], 0)
                if kernel == first:
                    _launch_edge("chunk_sort/src", top)(
                        planes, ncmp, chunk, invert, sources, row0, key_out)
                else:
                    _launch_edge("finish/unbias", top)(
                        planes, ncmp, tile, log_n, invert, key_out)
                torch.cuda.synchronize()
                if how == "in_place":
                    e = max(_max_err(planes[1:], ref[1:]) if p > 1 else 0,
                            _max_err(planes[:1], [ref[0] ^ SIGN]))
                else:
                    e = stored(planes, out, ref)
                record([kernel], e, e == 0, case=name,
                    rows=total, chunk=chunk, tile=tile, store=how,
                    compile_time_plan=top, row0=row0, invert=invert, **case)
                del planes, out


def edge_checks(dev):
    """Phase 3 for a sort's first and last launches (csrc/bitonic_io.cu,
    ``_edge_case``): chunk_sort's source form and finish's unbiasing form in
    the keys, rider and lex2 modes and the join's lex2 of two key columns
    and a tie made from the row, on both plans: columns 0..3 rows past a
    16-byte boundary, n at, one below and one above a run of 16 rows (the
    int4 loads), n equal to the planes' rows, join splits at 0, 1, a run
    boundary and one either side, and n, 0xFFFFFFFF keys among the real
    ones; a piece of the arbitrary-N path (row0 past 0, descending)."""
    from radx_tpu_torch.kernels import bitonic as B

    gen = torch.Generator(device=dev).manual_seed(41)

    def col(n, off):
        """n random int32 rows 4 * off bytes past a 16-byte boundary, every
        seventh 0xFFFFFFFF (-1)."""
        buf = torch.empty(n + 4, dtype=torch.int32, device=dev)
        v = buf[off: off + n]
        v.copy_(torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                              generator=gen, device=dev))
        v[::7] = -1
        return v

    total = 1 << 16
    for n in (16 * 777, 16 * 777 - 1, 16 * 777 + 1, total):
        for off in (0, 1, 2, 3):
            keys = col(n, off)
            for chunk in (B.top_tile(1), 1 << 10):
                _edge_case("keys", [B.key_source(keys)], 1, total, chunk, n,
                           n=n, offset=off)
            rider = col(n, 3 - off)
            _edge_case("rider", [B.key_source(keys),
                                 B.column_source(rider, -7)], 1, total,
                       B.top_tile(2), n, n=n, offset=off)
            _edge_case("lex2", [B.key_source(keys), B.index_source(total)],
                       2, total, B.top_tile(2), n, n=n, offset=off)
    n = 16 * 1500 + 5
    keys = col(n, 0)
    for nb in (0, 1, 16 * 300 - 1, 16 * 300, 16 * 300 + 1, n):
        b, pr = col(nb, 1), col(n - nb, 2)
        b.copy_(keys[:nb])
        pr.copy_(keys[nb:])
        _edge_case("union", [B.key_source(b, pr),
                             B.index_source(n, nb, (0, (1 << 30) - nb),
                                            0x7FFFFFFF)],
                   2, total, B.top_tile(2), n, n=n, nb=nb)
    # a piece of the arbitrary-N path: rows [2^16, 2^17) of sources of 2^16
    # + 12345 rows, descending
    keys = col(total + 12345, 3)
    for ncmp, sources in ((1, [B.key_source(keys)]),
                          (2, [B.key_source(keys),
                               B.index_source(2 * total)])):
        _edge_case("piece", sources, ncmp, total, B.top_tile(len(sources)),
                   12345, row0=total, invert=True, n=total + 12345)
    torch.cuda.empty_cache()


def edge_timings(dev, gen, time_pair, card):
    """Phase 5 for a sort's first and last launches at the cells' shapes
    (2^28 keys: the keys cell; 2^26 (key, rider): q3's pieces; 2^28 (key,
    index): the pairs cell): chunk_sort's source form reading the caller's
    column(s) and finish's unbiasing form at the top level, each first held
    bit-equal to its plain version on the same inputs, then timed beside it
    and its bound (each source column read once, each plane and the keys
    written once; the network's operations and one XOR a key), then in
    turns with the in-place kernel of the same network on the same plan
    (in place, in place, new, new... : old, new, new, old), and finish's
    unbiasing store in place against the store into a new output of n - 3
    rows (the keys cell writes in place: n is the planes' rows)."""
    from radx_tpu_torch import SortConfig
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.utils import timing

    i32 = torch.int32
    cfg = SortConfig()

    def made_planes(sources, n):
        return B.source_planes_ref(sources, 0, n, dev)

    for name, ncmp, log_n in (("keys", 1, 28), ("rider", 1, 26),
                              ("lex2", 2, 28)):
        n = 1 << log_n
        keys = torch.randint(-(2**31), 2**31, (n,), dtype=i32,
                             generator=gen, device=dev)
        sources = [B.key_source(keys)]
        if name == "rider":
            sources.append(B.column_source(torch.randint(
                -(2**31), 2**31, (n,), dtype=i32, generator=gen,
                device=dev), -7))
        elif name == "lex2":
            keys.bitwise_and_(0xFFFFF)  # ties decided by the index
            keys[::7] = -1
            sources.append(B.index_source(n))
        p = len(sources)
        chunk, tile = cfg.mode_tiles(p, ncmp)
        first, last = B.source_kernels(ncmp, p)
        planes = [torch.empty(n, dtype=i32, device=dev) for _ in range(p)]
        k, rd, lx = B._keywords(planes, ncmp)
        B.chunk_sort_sources(k, chunk, sources, rider=rd, lex=lx)
        kr, rr, lr = B._keywords(made_planes(sources, n), ncmp)
        want = B.chunk_sort_ref(kr, chunk, rider=rr, lex=lr)
        want = want if isinstance(want, tuple) else (want,)
        e = _max_err(planes, want)
        record([first], e, e == 0, n=n, chunk=chunk, shape="cell")
        read = sum(4 * n for s in sources if s.cols)
        lc = chunk.bit_length() - 1
        ops = _cx_ops(n, lc * (lc + 1) // 2, p) + n
        def plain_first():
            kp, rp, lp = B._keywords(made_planes(sources, n), ncmp)
            return B.chunk_sort_ref(kp, chunk, rider=rp, lex=lp)

        time_pair(first, log_n,
                  lambda: B.chunk_sort_sources(k, chunk, sources, rider=rd,
                                               lex=lx),
                  plain_first, read + 4 * p * n, ops, iters=5,
                  round_trips=B.round_trips(lc, 1, lc, p))
        # in turns with the in-place chunk sort (same network, same plan)
        same = [q.clone() for q in planes]
        ks, rs, ls = B._keywords(same, ncmp)
        ms = {}
        for which in ("in_place", "sources", "sources", "in_place"):
            run = ((lambda: B.chunk_sort(ks, chunk, rider=rs, lex=ls))
                   if which == "in_place" else
                   (lambda: B.chunk_sort_sources(k, chunk, sources, rider=rd,
                                                 lex=lx)))
            ms.setdefault(which, []).append(
                timing.time_cuda(run, iters=10, repeats=5).seconds * 1e3)
        _line("context", what=f"{first} in turns with the in-place "
              f"chunk_sort, n=2^{log_n}", **ms, **card)
        del same, ks, rs, ls
        # finish's unbiasing form at the top level on the chunk-sorted
        # planes (the tiles hold every row of each merge group)
        lt = tile.bit_length() - 1
        base = [w.clone() for w in want]
        del want
        got = [w.clone() for w in base]
        kg, rg, lg = B._keywords(got, ncmp)
        B.finish(kg, tile, log_n, rider=rg, lex=lg, key_out=(got[0], 0))
        kb, rb, lb = B._keywords(base, ncmp)
        ref = B.finish_ref(kb, tile, log_n, rider=rb, lex=lb)
        ref = ref if isinstance(ref, tuple) else (ref,)
        e = max(_max_err(got[:1], [ref[0] ^ SIGN]),
                _max_err(got[1:], ref[1:]) if p > 1 else 0)
        out = torch.empty(n - 3, dtype=i32, device=dev)
        got = [w.clone() for w in base]
        kg, rg, lg = B._keywords(got, ncmp)
        B.finish(kg, tile, log_n, rider=rg, lex=lg, key_out=(out, 0))
        e = max(e, _max_err([out], [ref[0][: n - 3] ^ SIGN]))
        record([last], e, e == 0, n=n, tile=tile, shape="cell",
               stores=["in_place", "rows n - 3"])
        del got, ref
        def plain_last():
            res = B.finish_ref(kb, tile, log_n, rider=rb, lex=lb)
            return (res if isinstance(res, tuple) else (res,))[0] ^ SIGN

        time_pair(last, log_n,
                  lambda: B.finish(kb, tile, log_n, rider=rb, lex=lb,
                                   key_out=(kb, 0)),
                  plain_last, 8 * p * n, _cx_ops(n, lt, p) + n, iters=5,
                  round_trips=B.round_trips(lt, log_n, log_n, p))
        ms = {}
        for which in ("in_place", "unbias_in_place", "unbias_rows",
                      "unbias_rows", "unbias_in_place", "in_place"):
            run = {"in_place": lambda: B.finish(kb, tile, log_n, rider=rb,
                                                lex=lb),
                   "unbias_in_place": lambda: B.finish(
                       kb, tile, log_n, rider=rb, lex=lb, key_out=(kb, 0)),
                   "unbias_rows": lambda: B.finish(
                       kb, tile, log_n, rider=rb, lex=lb,
                       key_out=(out, 0))}[which]
            ms.setdefault(which, []).append(
                timing.time_cuda(run, iters=10, repeats=5).seconds * 1e3)
        _line("context", what=f"{last} in turns with the in-place finish, "
              f"n=2^{log_n}", **ms, **card)
        del planes, k, rd, lx, base, kb, rb, lb, out, keys, sources
        torch.cuda.empty_cache()


def _radix_tile_checks(planes, ncmp, cfg):
    """K4 and K5 of one mode on ``planes`` (``tile_engine_checks``), each
    case on both plans wherever the compile-time plan applies (``forced``),
    at the radix geometries' C = 2^19 too (slots of 1024: 2^28 keys; 4096:
    2^26): every case's output bit-equal to the plain version, one line per
    kernel and plan."""
    from radx_tpu_torch.kernels import bitonic as B

    n, p, big, geo = planes[0].numel(), len(planes), 1 << 17, 1 << 19
    c, f = cfg.mode_tiles(p, ncmp)
    cyc, merge = B.radix_kernels(ncmp, p)
    # (tile, chunk, offset) and (tile, slot, chunk, offset)
    k4 = [(tile, chunk, False) for tile in (2, 4, 8, 16, 32, c)
          for chunk in sorted({max(B.CYCLIC_TILE, tile), big})]
    k4 += [(c, big, True), (c, geo, False)]
    k5 = []
    for tile in sorted({2, 4, 8, 16, 32, c, max(c, f)}):
        slots = {tile // 4, tile // 2, tile, 2 * tile}
        if tile >= c:  # the radix geometries' slots (2^28 and 2^26)
            slots |= {1024, 4096}
        k5 += [(tile, slot, big, False) for slot in sorted(slots)
               if 1 <= slot < big]
    t = max(c, f)
    k5 += [(t, t // 4, big, True), (t, 2 * t, big, True),
           (t, 1024, geo, False), (t, 4096, geo, False)]

    def kernel_args(case):
        """The wrapper's arguments after (src, dst, ncmp) of a K4 case
        (tile, chunk) or a K5 case (tile, slot, chunk), offset dropped."""
        return ((case[1], case[0]) if len(case) == 3
                else (case[2], case[1], case[0]))

    def run(name, todo, kernel, ref, trips, tops):
        worst, count = {}, {}
        for case in todo:
            offset = case[-1]
            src = _offset(planes) if offset else planes
            want = ref(src, *case[:-1])
            for top in tops(*case[:-1]):
                out = _offset(planes) if offset else [
                    torch.empty_like(q) for q in planes]
                forced(kernel, top)(src, out, ncmp, *kernel_args(case))
                torch.cuda.synchronize()
                e = _max_err(out, want)
                if e:
                    record([name], e, False, n=n, case=case[:-1],
                           offset=offset, compile_time_plan=top)
                worst[top] = max(worst.get(top, 0), e)
                count[top] = count.get(top, 0) + 1
                del out
        for top, e in worst.items():
            record([name], e, e == 0, n=n, compile_time_plan=top,
                   cases=count[top],
                   round_trips={"/".join(map(str, case[:-1])):
                                trips(*case[:-1]) for case in todo})

    lg = lambda x: x.bit_length() - 1  # noqa: E731
    run(cyc, k4, "chunk_sort_cyclic",
        lambda s, tile, chunk: B.chunk_sort_cyclic_ref(s, ncmp, chunk, tile),
        lambda tile, chunk: B.round_trips(lg(tile), 1, lg(tile), p),
        lambda tile, chunk: plans("chunk_sort_cyclic", p, lg(tile), lg(tile)))
    run(merge, k5, "slot_merge",
        lambda s, tile, slot, chunk: B.slot_merge_ref(s, ncmp, chunk, slot,
                                                      tile),
        lambda tile, slot, chunk: B.round_trips(lg(tile), lg(slot) + 1,
                                                lg(tile), p),
        lambda tile, slot, chunk: plans("slot_merge", p, lg(tile), lg(tile),
                                        log_s=lg(slot)))
    # a launch on the compile-time plan of a pass that is not its layout
    # (another tile, a slot below 2^10, a mode without the kernel) is
    # refused, and the wrapper raises
    out = [torch.empty_like(q) for q in planes]
    bad = {"tile/2": lambda: forced("chunk_sort_cyclic", True)(
               planes, out, ncmp, big, c // 2),
           "slot 512": lambda: forced("slot_merge", True)(
               planes, out, ncmp, big, 512, t)}
    if p not in B.TOP_MODES["chunk_sort_cyclic"]:
        bad["mode"] = lambda: forced("chunk_sort_cyclic", True)(
            planes, out, ncmp, big, c)
    refused = {}
    for what, launch in bad.items():
        try:
            launch()
            refused[what] = False
        except RuntimeError:
            refused[what] = True
    _line("refused", kernels=[cyc, merge], **refused)
    if not all(refused.values()):
        _fail(f"{cyc} / {merge}: a compile-time launch of another plan ran")


def radix_checks(dev):
    """Phase 3 for the radix kernels, every output bit-equal to its plain
    version: radix_hist at 2^26 (K10's 2^19-key chunks with the totals row
    and K14's 1024-key tiles, a ragged n, bias 0 and 0x80000000, shifts 0 /
    8 / 16 / 24 on uniform keys, and all-equal and two-valued keys), then
    K4, K11 (``rank_runs``: splitters, ranks, run bounds, overflow flag and
    segment tables), K12, K5 and K13 at the two radix geometries of the main
    path: 2^26 keys (C = 2^19, 128 chunks, slots of 4096, nb_pad 168) in the
    keys, rider, lex2 and lex3 modes, and 2^28 keys (C = 2^19, 512 chunks,
    slots of 1024) in the keys and lex3 modes; and K11 alone on a rider
    sort's tail of pads (n_valid = 3 * 2^24: the last quarter pads, sentinel
    keys among the valid ones) and on inputs that overflow (all-equal keys, 97
    distinct keys) at both geometries."""
    from radx_tpu_torch.kernels import radix as RX

    n = RADIX_N
    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, generator=gen,
                      device=dev)
    ragged = n - 12345

    def hist(keys, tile, shift, bias, dist):
        totals = tile > RX.TILE  # as the radix sort counts
        got = RX.histograms(keys, tile, shift, bias, ragged, totals=totals)
        want = RX.histograms_ref(keys, tile, shift, bias, ragged, totals)
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        record(["radix_hist" if tile > RX.TILE else "radix_hist/tile"],
               e, e == 0, n=n, n_valid=ragged, tile=tile, shift=shift,
               bias=bias, keys=dist, totals=totals)

    for bias in (0, 0x80000000):
        for shift in (0, 8, 16, 24):
            for tile in (RX.TILE, 1 << 19):
                hist(x, tile, shift, bias, "uniform")
    two = torch.where(x < 0, 0x11223344, -0x11223345).to(torch.int32)
    for dist, keys in (("all_equal", torch.full_like(x, 0x12345678)),
                       ("two_keys", two)):
        for tile, shift, bias in ((RX.TILE, 8, 0), (1 << 19, 24, 0x80000000)):
            hist(keys, tile, shift, bias, dist)
    del x, two, keys
    geometries = [(RADIX_N, m) for m in MODES] + [
        (RADIX_N_BIG, m) for m in ("keys", "lex3")]
    for n, mode in geometries:
        _radix_geometry_check(dev, n, mode, gen)
        torch.cuda.empty_cache()
    # K4's source form and K13's unbiasing form: 2^26 (slots of 4096) in
    # every mode they have, 2^28 (slots of 1024) in the cells' keys and lex2
    for n, mode in [(RADIX_N, m) for m in ("keys", "rider", "lex2")] + [
            (RADIX_N_BIG, m) for m in ("keys", "lex2")]:
        _radix_source_check(dev, n, mode, gen)
    for n in (RADIX_N, RADIX_N_BIG):
        for dist in ("rider_path", "all_equal", "lowcard"):
            if dist != "rider_path" or n == RADIX_N:
                _rank_check(dev, n, dist, gen)
        torch.cuda.empty_cache()


def _rank_check(dev, n, dist, gen):
    """K11 alone on one input at the radix geometry of n keys: a rider
    sort's tail of pads (n_valid = 3 n / 4, 1% sentinel keys among the valid
    ones),
    all-equal keys or 97 distinct keys (both overflow); every output
    bit-equal to ``rank_runs_ref``."""
    from radx_tpu_torch import SortConfig
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import radix_sort as RS

    cfg = SortConfig(strategy="radix")
    p = RS.plan(n, RS.pick_chunk(n, cfg.chunk_elems))
    keys = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                         generator=gen, device=dev)
    nv, tail = n, dist == "rider_path"
    if tail:
        nv = n - n // 4
        keys[: n // 100] = PAD
        keys = keys[torch.randperm(n, generator=gen, device=dev)]
        keys[nv:] = PAD
    elif dist == "all_equal":
        keys.fill_(0x12345678)
    else:
        keys = keys.remainder(97)
    sorted_ = B.sort_chunks_ascending_cyclic([keys], 1, p.C,
                                             *cfg.mode_tiles(1, 1))[0]
    args = RS.rank_args(sorted_, keys, p, nv, cfg.mode_tiles(1, 1), tail)
    got, want = RS.rank_runs(*args), RS.rank_runs_ref(*args)
    e = _max_err([*got, got.ranks], [*want, want.ranks])
    ok = e == 0 and int(got.overflow) == (dist != "rider_path")
    record(["radix_rank"], e, ok, n=n, keys=dist, n_valid=nv, tail=tail,
           overflow=int(got.overflow), C=p.C, nb_pad=p.nb_pad)


def _radix_geometry_check(dev, n, mode, gen):
    """K4, K11, K12, K5 and K13 of one mode at the radix geometry of n keys,
    each on the input the sort's own stages give it, bit-equal to its plain
    version; the concatenated output is the stable order of the keys."""
    from radx_tpu_torch import SortConfig
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import msd as M
    from radx_tpu_torch.kernels import radix_sort as RS

    cfg = SortConfig(strategy="radix")
    p = RS.plan(n, RS.pick_chunk(n, cfg.chunk_elems))
    ncmp, np_ = MODES[mode]
    planes = _mode_planes(dev, mode, n, gen)
    c, f = cfg.mode_tiles(np_, ncmp)
    t = min(max(f, c), p.C)
    cyc, merge = B.radix_kernels(ncmp, np_)
    pack, concat = M.mode_kernels(ncmp, np_)
    case = dict(n=n, mode=mode, C=p.C, slot=p.slot, nb_pad=p.nb_pad)
    out = [torch.empty_like(q) for q in planes]
    B.chunk_sort_cyclic(planes, out, ncmp, p.C, c)
    e = _max_err(out, B.chunk_sort_cyclic_ref(planes, ncmp, p.C, c))
    record([cyc], e, e == 0, tile=c, **case)
    del out
    sorted_ = B.sort_chunks_ascending_cyclic(planes, ncmp, p.C, c, f)
    tail = mode == "rider"
    args = RS.rank_args(sorted_[0], planes[0], p, n, cfg.mode_tiles(1, 1),
                        tail)
    b, want = RS.rank_runs(*args), RS.rank_runs_ref(*args)
    e = _max_err([*b, b.ranks], [*want, want.ranks])
    record(["radix_rank"], e, e == 0, splitters=b.splitters.numel(), **case)
    if bool(b.overflow):
        _fail(f"the radix geometry overflowed on the {mode} inputs")
    packed = M.pack(sorted_, b.bounds, p.C, p.slot, p.nb_pad, ncmp)
    e = _max_err(packed, M.pack_ref(sorted_, b.bounds, p.C, p.slot,
                                    p.nb_pad, ncmp))
    record([pack], e, e == 0, **case)
    out = [torch.empty_like(q) for q in packed]
    B.slot_merge(packed, out, ncmp, p.C, p.slot, t)
    e = _max_err(out, B.slot_merge_ref(packed, ncmp, p.C, p.slot, t))
    record([merge], e, e == 0, tile=t, **case)
    del out
    merged = B.merge_slots_ascending(packed, ncmp, p.C, p.slot, c, f)
    del packed
    out = [torch.empty_like(q) for q in planes]
    src = sorted_ if tail else None
    M.concat(merged, src, out, b.start, b.src, p.nb_pad, ncmp)
    e = _max_err(out, M.concat_ref(merged, src, b.start, b.src, p.nb_pad,
                                   n, ncmp))
    order = _biased_order(planes[0])
    ok = e == 0 and torch.equal(out[0], planes[0][order])
    if ncmp == 2:  # (key, index): the stable order of the keys
        ok = ok and torch.equal(out[1].long(), order)
    record([concat], e, ok, tail_segments=b.src.numel() - p.nb_pad,
           **case)


def _sources_of(planes, ncmp):
    """The sources whose planes are ``planes`` (``_mode_planes``): the
    caller's uint32 keys (plane 0 unbiased), a rider column (its pad never
    read: no pad rows), or the index made from the row."""
    from radx_tpu_torch.kernels import bitonic as B

    sources = [B.key_source(planes[0] ^ SIGN)]
    if ncmp == 2:
        sources.append(B.index_source(planes[1].numel()))
    elif len(planes) == 2:
        sources.append(B.column_source(planes[1], -7))
    return sources


def _radix_stages(planes, ncmp, p, cfg, sources=None):
    """(sorted chunks, ``rank_runs``' outputs, merged buckets) of a radix
    sort of ``planes`` (from ``sources`` where given: K4's source form and
    the counting of the key source) at the plan ``p``, no overflow."""
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import msd as M
    from radx_tpu_torch.kernels import radix_sort as RS

    np_ = len(planes)
    c, f = cfg.mode_tiles(np_, ncmp)
    n = planes[0].numel()
    tail = ncmp == 1 and np_ == 2
    if sources is None:
        sorted_ = B.sort_chunks_ascending_cyclic(planes, ncmp, p.C, c, f)
        counted = planes[0]
    else:
        sorted_ = B.sort_chunks_ascending_cyclic(
            [torch.empty_like(q) for q in planes], ncmp, p.C, c, f,
            sources=sources)
        counted = sources[0]
    b = RS.rank_runs(*RS.rank_args(sorted_[0], counted, p, n,
                                   cfg.mode_tiles(1, 1), tail))
    if bool(b.overflow):
        _fail(f"the radix geometry of {n} rows overflowed")
    packed = M.pack(sorted_, b.bounds, p.C, p.slot, p.nb_pad, ncmp)
    merged = B.merge_slots_ascending(packed, ncmp, p.C, p.slot, c, f)
    return sorted_, b, merged


def _radix_source_check(dev, n, mode, gen):
    """K4's source form and K13's unbiasing form of one mode at the radix
    geometry of n keys, bit-equal to their plain versions on the same
    inputs: K4 (both plans) against ``chunk_sort_cyclic_ref`` of
    ``source_planes_ref``'s planes, from the caller's columns as they are,
    from a column 12345 rows short 3 rows past a 16-byte boundary (the pads
    made at load) and from a piece whose sources start 2^20 rows in
    (``row0``, 777 pad rows); the digit totals and sentinel count read from
    the key source against those of the plane it makes; K13 against
    ``concat_ref`` with plane 0 XORed, in place and into the first n - 3
    rows of a new output (the rows past it untouched)."""
    from radx_tpu_torch import SortConfig
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import msd as M
    from radx_tpu_torch.kernels import radix_sort as RS

    cfg = SortConfig(strategy="radix")
    p = RS.plan(n, RS.pick_chunk(n, cfg.chunk_elems))
    ncmp, np_ = MODES[mode]
    c = cfg.mode_tiles(np_, ncmp)[0]
    lc = c.bit_length() - 1
    k4, k13 = B.radix_source_kernel(ncmp, np_), M.unbias_kernel(ncmp, np_)
    planes = _mode_planes(dev, mode, n, gen)
    case = dict(n=n, mode=mode, C=p.C, slot=p.slot, nb_pad=p.nb_pad)

    def column(rows, off):
        buf = torch.empty(rows + 4, dtype=torch.int32, device=dev)
        v = buf[off: off + rows]
        v.copy_(torch.randint(-(2**31), 2**31, (rows,), dtype=torch.int32,
                              generator=gen, device=dev))
        v[::101] = -1  # 0xFFFFFFFF: the pads' key
        return v

    short = n - 12345
    piece = (1 << 20) + n - 777
    for name, rows, off, row0 in (("columns", n, 0, 0),
                                  ("ragged", short, 3, 0),
                                  ("piece", piece, 1, 1 << 20)):
        if name == "columns":
            sources = _sources_of(planes, ncmp)
        else:
            sources = [B.key_source(column(rows, off))]
            if ncmp == 2:
                sources.append(B.index_source(rows))
            elif np_ == 2:
                sources.append(B.column_source(column(rows, 3 - off), -7))
        made = B.source_planes_ref(sources, row0, n, dev)
        want = B.chunk_sort_cyclic_ref(made, ncmp, p.C, c)
        for top in plans("chunk_sort_cyclic", np_, lc, lc):
            out = [torch.empty_like(q) for q in planes]
            B._launch_cyclic_src(out, ncmp, p.C, c, sources, row0, top)
            torch.cuda.synchronize()
            e = _max_err(out, want)
            record([k4], e, e == 0, sources=name, rows=rows, row0=row0,
                   offset=off, compile_time_plan=top, **case)
            del out
        tail = ncmp == 1 and np_ == 2
        got = RS.rank_args(want[0], sources[0], p, n, cfg.mode_tiles(1, 1),
                           tail, row0)
        ref = RS.rank_args(want[0], made[0], p, n, cfg.mode_tiles(1, 1),
                           tail)
        e = max(_max_err([got[3]], [ref[3]]),
                _max_err([got[6]], [ref[6]]) if tail else 0)
        record(["radix_hist"], e, e == 0, counted="key source",
               sources=name, rows=rows, row0=row0, **case)
        del made, want, got, ref
    sorted_, b, merged = _radix_stages(planes, ncmp, p, cfg,
                                       _sources_of(planes, ncmp))
    tail = ncmp == 1 and np_ == 2
    src = sorted_ if tail else None
    want = M.concat_ref(merged, src, b.start, b.src, p.nb_pad, n, ncmp)
    ok = torch.equal(want[0], planes[0][_biased_order(planes[0])])
    for store in ("in_place", "rows"):
        out = [torch.full((n,), 7, dtype=torch.int32, device=dev)
               for _ in range(np_)]
        if store == "in_place":
            key = out[0]
        else:
            guard = torch.full((n + 1,), 7, dtype=torch.int32, device=dev)
            key = guard[: n - 3]
            out[0] = key if np_ == 1 else None
        M.concat(merged, src, out, b.start, b.src, p.nb_pad, ncmp,
                 (key, 0))
        torch.cuda.synchronize()
        rows = key.numel()
        e = max(_max_err([key], [want[0][:rows] ^ SIGN]),
                _max_err(out[1:], want[1:]) if np_ > 1 else 0)
        if store == "rows" and not bool((guard[rows:] == 7).all()):
            e = max(e, 1)
        record([k13], e, ok and e == 0, store=store, key_rows=rows, **case)
        del out, key
    del planes, sorted_, b, merged, want
    torch.cuda.empty_cache()


def radix_path(dev):
    """Slice 4: the radix distribution sort through the entry points under
    ``SortConfig(strategy="radix")``, one window per path, each printing
    its count of radix sorts and of overflows; every result exact.  The
    sorts make their planes in their own first and last launches (K4's
    source form, K13's unbiasing form; the overflow fallback's network
    from the same sources): no window may run PyTorch's preparation."""
    from radx_tpu_torch import SortConfig, argsort, groupby, sort, sort_pairs
    from radx_tpu_torch import bench
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import radix as RX
    from radx_tpu_torch.ops import sort as S

    cfg = SortConfig(strategy="radix")
    gen = torch.Generator(device=dev).manual_seed(51)

    def u32(n, lo=-(2**31), hi=2**31):
        return torch.randint(lo, hi, (n,), dtype=torch.int32, generator=gen,
                             device=dev).view(torch.uint32)

    def flag_line(name, mode, **extra):
        sorts, over = radix_overflows(*MODES[mode])
        _line("radix", path=name, radix_sorts=sorts, overflows=over, **extra)
        return over

    n26, n28 = RADIX_N, RADIX_N_BIG
    for n in (n26, n28):
        keys = u32(n)
        with window(f"radix_sort_2e{n.bit_length() - 1}",
                    radix_required(1, 1), radix_top(1, 1), prep="none"):
            got = sort(keys, cfg)
        ok = torch.equal(_i32(got), _i32(bench.torch_sort_u32(keys)))
        flag_line(f"radix_sort_n{n}", "keys", equal_torch_sort=ok)
        if not ok:
            _fail(f"radix sort at n={n} differs from torch.sort")
        del keys, got
    base = bench.torch_sort_u32(u32(n26))
    dists = {
        "presorted": base,
        "reverse": base.view(torch.int32).flip(0).view(torch.uint32),
        "clustered": (torch.randint(0, 4, (n26,), dtype=torch.int32,
                                    generator=gen, device=dev) * 0x10000000
                      + torch.randint(0, 1000, (n26,), dtype=torch.int32,
                                      generator=gen, device=dev)
                      ).view(torch.uint32),
        "lowcard": u32(n26, 0, 97),
    }
    for name, keys in dists.items():
        # low-cardinality keys may overflow a slot: the network then sorts
        required = (radix_required(1, 1) if name != "lowcard" else
                    ("radix_hist", "radix_rank", B.radix_source_kernel(1, 1),
                     "chunk_sort", *src_kernels(1, 1)))
        with window(f"radix_sort_{name}_2e26", required,
                    radix_top(1, 1, merge=name != "lowcard"), prep="none"):
            got = sort(keys, cfg)
        ok = torch.equal(_i32(got), _i32(bench.torch_sort_u32(keys)))
        flag_line(f"radix_sort_{name}_n{n26}", "keys", equal_torch_sort=ok)
        if not ok:
            _fail(f"radix sort of {name} keys differs from torch.sort")
    del base, dists, keys, got
    torch.cuda.empty_cache()

    keys, payload = bench.pairs_data(n28)
    # (key, index) through the lex2 distribution sort, then the payload's
    # gather
    with window("radix_sort_pairs_stable_2e28",
                (*radix_required(2, 2),
                 *gather_routes("index", "partitioned")), radix_top(2, 2),
                prep="none"):
        got = sort_pairs(keys, payload, cfg)
    want = bench.torch_sort_pairs(keys, payload)
    ok = all(torch.equal(_i32(a), _i32(b)) for a, b in zip(got, want))
    flag_line(f"radix_sort_pairs_n{n28}", "lex2", equal_reference=ok)
    if not ok:
        _fail("radix sort_pairs differs from torch.sort(stable=True)")
    del keys, payload, got, want
    torch.cuda.empty_cache()

    k26 = u32(n26, 0, 1 << 20)
    with window("radix_argsort_2e26", radix_required(2, 2, unbias=False),
                radix_top(2, 2), prep="none"):
        got = argsort(k26, cfg)
    ok = torch.equal(got.long(), _biased_order(_i32(k26) ^ SIGN))
    flag_line(f"radix_argsort_n{n26}", "lex2", equal_reference=ok)
    if not ok:
        _fail("radix argsort differs from torch.sort(stable=True)")
    del k26, got
    # 15/16 of 2^26 rows, the most pads that the power-of-two rider sort
    # keeps (below 10%): its last 2^22 rows are pads (key 0xFFFFFFFF,
    # n_valid = total), which skip the buckets
    n_g = n26 - n26 // 16
    if S._use_decomposition(n_g, cfg) or S._pad_len(n_g) != n26:
        _fail(f"n = {n_g} does not keep the power-of-two rider sort")
    keys, vals = bench.groupby_data(n_g)
    with window("radix_groupby_sum_15x2e22", radix_required(1, 2),
                radix_top(1, 2), prep="none"):
        res = groupby(keys, vals, "sum", cfg)
    g = bench._check_groups(*res, keys, vals)
    flag_line(f"radix_groupby_sum_n{n_g}", "rider", groups=g,
              equal_reference=True)
    del keys, vals, res
    # 3/4 of 2^26 rows: the arbitrary-N rider sort (pieces of 2^25 and
    # 2^24 rows, no pads), its last piece through the distribution sort
    n_g = n26 - n26 // 4
    if S._decompose_blocks(n_g, cfg.rider_chunk_elems)[1] != [4096, 2048]:
        _fail(f"n = {n_g} does not take the arbitrary-N rider sort")
    keys, vals = bench.groupby_data(n_g)
    # the heads sort descending on the network and the valley merges store
    # the keys, so the last piece's K13 writes its planes as they are
    with window("radix_groupby_sum_arbn_3x2e24",
                (*radix_required(1, 2, unbias=False),
                 *B.source_kernels(1, 2)),
                radix_top(1, 2), prep="none"):
        res = groupby(keys, vals, "sum", cfg)
    g = bench._check_groups(*res, keys, vals)
    flag_line(f"radix_groupby_sum_arbn_n{n_g}", "rider", groups=g,
              equal_reference=True)
    del keys, vals, res

    same = torch.full((RADIX_N_EQUAL,), 0x12345678, dtype=torch.int32,
                      device=dev).view(torch.uint32)
    # the network's sort of 2^23 keys: levels of up to 9 cross distances
    with window("radix_sort_all_equal_2e23",
                ("radix_hist", "radix_rank", B.radix_source_kernel(1, 1),
                 *src_kernels(1, 1, 9)), radix_top(1, 1, merge=False),
                prep="none"):
        got = sort(same, cfg)
    ok = torch.equal(_i32(got), _i32(same))
    if flag_line(f"radix_sort_all_equal_n{RADIX_N_EQUAL}", "keys",
                 equal_torch_sort=ok) != 1 or not ok:
        _fail("all-equal keys did not overflow, or were not sorted exactly")
    x = u32(n26)
    with window("tile_histograms_2e26", ("radix_hist/tile",)):
        hists = {s: RX.tile_histograms(x, s) for s in (0, 8, 16, 24)}
    for s, h in hists.items():
        want = torch.bincount(((_i32(x).long() & 0xFFFFFFFF) >> s) & 255,
                              minlength=256)
        if not torch.equal(h.sum(0).long(), want):
            _fail(f"tile_histograms at shift {s} differ from bincount")
    _line("slice", input=f"tile_histograms_n{n26}", shifts=[0, 8, 16, 24],
          equal_reference=True)
    del same, got, x, hists
    torch.cuda.empty_cache()


def _bits_equal(runs):
    """Whether every run of a kernel gave the same bits."""
    return all(torch.equal(_i32(a), _i32(runs[0])) for a in runs[1:])


def single_pass_checks(dev, cfg, rng):
    """Phase 3 for the single-pass kernels with a decoupled look-back,
    ``compact`` (K7) and ``segscan`` (K6), on ragged sizes:

    * compact bit-equal to ``compact_ref`` at 2^26 + 4097 rows (16,386
      tiles) for bool and int32 masks, P = 0..4 planes (0: the count
      alone), densities 0 / 0.01
      / 0.5 / 1 (a warp's few kept rows written directly, many staged),
      planes (and mask) aligned and offset by one row (the scalar loads),
      each case three times with the same bits, and a device row limit
      n_valid (P = 0 and 2);
    * segscan bit-equal to ``segscan_ref`` (float32 sums within 1e-5 x the
      run's sum of |v|) for sum / min / max over uint32 / int32 / float32
      and fill with M = 1..4, on 5000 / 7 / 1 groups and all-equal keys
      0xFFFFFFFF, at tiles of 256 rows (32769 tiles) three times, every run
      with the same bits (float sums included), and at the paths' tile;
      offset planes; and the float32 sum bit-equal to the CPU model
      ``segscan_lookback`` at 2^18 rows."""
    from radx_tpu_torch.kernels import compact as CP
    from radx_tpu_torch.kernels import segscan as SG

    def rand32(n):
        return torch.from_numpy(rng.integers(-(2**31), 2**31, n,
                                             dtype=np.int64).astype(np.int32)
                                ).to(dev)

    n = (1 << 26) + 4097
    planes = [rand32(n + 1) for _ in range(4)]
    for density in (0.0, 0.01, 0.5, 1.0):
        keep = torch.from_numpy(rng.random(n + 1) < density).to(dev)
        for kind, mask in (("bool", keep), ("int32", keep.to(torch.int32))):
            for p in (0, 1, 2, 3, 4):
                for off in (0, 1):
                    m = mask[off: off + n]
                    ps = [x[off: off + n] for x in planes[:p]]
                    limit = (torch.tensor(n // 3, dtype=torch.int32, device=dev)
                             if density == 0.5 and p in (0, 2) else None)
                    want, wcount = CP.compact_ref(m, ps, limit)
                    c = int(wcount)
                    runs = [CP.compact(m, ps, cfg.compact_elems,
                                       n_valid=limit) for _ in range(3)]
                    torch.cuda.synchronize()
                    e = max(abs(int(count) - c) + max(
                        [int((o[:c].long() - w[:c].long()).abs().max())
                         if c else 0 for o, w in zip(outs, want)], default=0)
                        for outs, count in runs)
                    same = all(_bits_equal([r[0][i][:c] for r in runs])
                               for i in range(p))
                    record(list(CP.KERNELS), e, e == 0 and same, n=n,
                           mask=kind, planes=p, density=density, kept=c,
                           offset_rows=off, tiles=-(-n // (
                               CP.TILE if p else CP.COUNT_TILE_BYTES
                               // m.element_size())),
                           n_valid=None if limit is None else n // 3,
                           runs=len(runs))
    del planes, keep, mask, m, ps, want

    scan_n = (1 << 23) + 33
    many = 256

    def check_scan(name, keys, vals, op, dtype, flags=None, **case):
        want = SG.segscan_ref(keys, vals, op, dtype, flags)
        for tile, reps in ((many, 3), (cfg.scan_elems, 1)):
            runs = [SG.segscan_planes(keys, vals, op, dtype, tile, flags)
                    for _ in range(reps)]
            torch.cuda.synchronize()
            if op == "fill":
                got = [x for r in runs for x in r[0] + r[1]]
                ref = (want[0] + want[1]) * reps
                e = max(int((a.long() - b.long()).abs().max())
                        for a, b in zip(got, ref))
                ok = e == 0
            elif op == "sum" and dtype == torch.float32:
                tols = [_segscan_tol(SG, keys, vals, r, want) for r in runs]
                e, ok = max(t[0] for t in tols), all(t[1] for t in tols)
            else:
                e = max(int((r.long() - want.long()).abs().max()) for r in runs)
                ok = e == 0
            same = (all(_bits_equal([r[0][j] for r in runs])
                        for j in range(len(vals)))
                    if op == "fill" else _bits_equal(runs))
            record(list(SG.KERNELS), e, ok and same, n=keys.numel(),
                   keys=name, op=op, dtype=str(dtype), tile=tile,
                   tiles=-(-keys.numel() // tile), runs=reps, **case)

    for groups in (5000, 7, 1, "all_ffffffff"):
        if groups == "all_ffffffff":
            keys = torch.full((scan_n,), -1, dtype=torch.int32, device=dev)
        else:
            keys = torch.from_numpy(np.sort(rng.integers(
                0, groups, scan_n).astype(np.uint32)).view(np.int32)).to(dev)
        for dtype in (torch.uint32, torch.int32, torch.float32):
            vals = (torch.from_numpy(rng.standard_normal(scan_n).astype(
                np.float32).view(np.int32)).to(dev)
                if dtype == torch.float32 else rand32(scan_n))
            for op in ("sum", "min", "max"):
                check_scan(f"groups_{groups}", keys, vals, op, dtype)
        for m in (1, 2, 3, 4):
            flags = [torch.from_numpy((rng.random(scan_n) < 0.01).astype(
                np.int32)).to(dev) for _ in range(m)]
            fvals = [rand32(scan_n) for _ in range(m)]
            check_scan(f"groups_{groups}", keys, fvals, "fill", torch.int32,
                       flags, planes=m)
    # planes offset by one row
    keys = torch.from_numpy(np.sort(rng.integers(0, 7, scan_n + 1).astype(
        np.uint32)).view(np.int32)).to(dev)
    vals = rand32(scan_n + 1)
    check_scan("groups_7_offset_row", keys[1:], vals[1:], "sum", torch.uint32)
    # the float32 sum against the CPU model, bit for bit
    small = (1 << 18) + 33
    for groups in (5000, 7, 1):
        keys = np.sort(rng.integers(0, groups, small).astype(np.uint32)).view(
            np.int32)
        vals = rng.standard_normal(small).astype(np.float32).view(np.int32)
        kt, vt = torch.from_numpy(keys), torch.from_numpy(vals)
        got = SG.segscan_planes(kt.to(dev), vt.to(dev), "sum", torch.float32,
                                many).cpu()
        model = SG.segscan_lookback(kt, vt, "sum", torch.float32, many,
                                    torch.Generator().manual_seed(groups))
        e = int((got.long() - model.long()).abs().max())
        record(list(SG.KERNELS), e, e == 0, n=small, groups=groups, op="sum",
               dtype="torch.float32", tile=many, against="segscan_lookback")
    del keys, vals, flags, fvals
    torch.cuda.empty_cache()


def gather_routes(mode, route):
    """The launch names of one ``gather_planes`` route: the direct kernel,
    or the partitioned route's five steps."""
    from radx_tpu_torch.kernels import gather as GT

    tag = "tagged/" if mode == "tagged" else ""
    if route == "direct":
        return (GT._KERNEL[mode],)
    return tuple(f"gather_planes/{tag}{s}" for s in GT.STEPS)


def gather_steps(idx, srcs, mode, window_rows=None, tile=None, **case):
    """Each kernel of the partitioned route against its plain version on
    the same inputs (the counts, their prefixes and totals, P, V, the
    outputs), every one bit-equal; then the whole route against
    ``gather_planes_ref``."""
    from radx_tpu_torch.kernels import gather as GT

    kw = {k: v for k, v in (("window_rows", window_rows), ("tile", tile))
          if v is not None}
    geo = GT.geometry(idx, srcs, mode, **kw)
    steps = {}
    counts = GT.count(idx, geo)
    steps["count"] = [(counts, GT.count_ref(idx, geo))]
    offsets, totals = GT.scan(counts, geo)
    want_o, want_t = GT.scan_ref(counts, geo)
    steps["scan"] = [(offsets, want_o), (totals, want_t)]
    del counts, want_o, want_t
    p = GT.part(idx, geo, offsets, totals)
    steps["part"] = [(p, GT.part_ref(idx, geo, offsets, totals))]
    side = srcs if geo.tagged else srcs[:1]
    v = GT.window(p, side, geo, torch.empty_like(p))
    steps["window"] = [(v, GT.window_ref(p, side, geo, torch.empty_like(p)))]
    outs = [torch.empty_like(idx) for _ in range(1 + geo.tagged)]
    steps["place"] = list(zip(
        GT.place(idx, geo, offsets, totals, v, outs),
        GT.place_ref(idx, geo, offsets, totals, v,
                     [torch.empty_like(o) for o in outs])))
    torch.cuda.synchronize()
    for step, pairs in steps.items():
        e = max(int((a - b).abs().max()) if a.numel() else 0
                for a, b in pairs)
        record([geo.name(step)], e, e == 0, n=idx.numel(), windows=geo.nb,
               tiles=geo.tiles, **case)
    del steps, p, v, offsets, totals
    got = GT.partitioned(idx, srcs, mode, **kw)
    want = GT.gather_planes_ref(idx, srcs, mode)
    e = _max_err(got, want)
    record(list(gather_routes(mode, "partitioned")), e, e == 0,
           n=idx.numel(), sources=len(srcs), route="partitioned", **kw,
           **case)


def gather_checks(dev):
    """``gather_planes`` (csrc/gather.cu) against its plain version, every
    output bit-equal, through the route that ``gather_planes`` picks by
    size (its launches counted: one direct launch, or count / scan / part
    once and window / place once a value plane): index mode with one source
    on a permutation of 2^28 rows (config 2's payload), with 1..4 sources
    on a permutation of 2^26 + 4099 rows (no multiple of a tile) whose
    index plane sits one row off 16-byte alignment and holds out-of-range
    indices (0 out); tagged mode on the join's union of 2 x 10^8 rows
    (build and probe ties, shuffled) and on 2^20 + 4099 ties with pads
    (direct; partitioned at 2^16-row windows and 2^12-row tiles); the skew
    cases at 2^26 (the identity: one bucket a tile; the reversal; one index
    for every row: one bucket holds all; a quarter out of range); index
    mode through the direct route at 2^20 and at one window (2^22 rows).
    The partitioned cases also hold each step's kernel against its plain
    version (``gather_steps``)."""
    from radx_tpu_torch.kernels import gather as GT

    gen = torch.Generator(device=dev).manual_seed(61)

    def rand32(n):
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                             generator=gen, device=dev)

    def perm(n, offset=0):
        buf = torch.empty(n + offset, dtype=torch.int32, device=dev)
        buf[offset:] = torch.randperm(n, generator=gen, device=dev)
        return buf[offset:]

    def check(idx, srcs, mode, **case):
        route = "partitioned" if GT.takes_partitioned(srcs) else "direct"
        GT.reset_counts()
        got = GT.gather_planes(idx, srcs, mode)
        torch.cuda.synchronize()
        launched = {k: v for k, v in GT.LAUNCHES.items() if v}
        planes = 1 if mode == "tagged" else len(srcs)
        expect = ({GT._KERNEL[mode]: 1} if route == "direct" else
                  {k: planes if k.endswith(("/window", "/place")) else 1
                   for k in gather_routes(mode, route)})
        if launched != expect:
            _fail(f"gather_planes launched {launched}, not {expect} ({case})")
        want = GT.gather_planes_ref(idx, srcs, mode)
        e = _max_err(got, want)
        record(list(expect), e, e == 0, n=idx.numel(), sources=len(srcs),
               route=route, **case)

    n28 = 1 << 28
    idx, srcs = perm(n28), [rand32(n28)]
    check(idx, srcs, "index", what="config 2 payload")
    gather_steps(idx, srcs, "index", what="config 2 payload")
    del idx, srcs
    torch.cuda.empty_cache()
    n = (1 << 26) + 4099
    idx = perm(n, offset=1)
    idx[:3] = torch.tensor([-1, n, 2**31 - 1], dtype=torch.int32, device=dev)
    srcs = [rand32(n) for _ in range(4)]
    for g in range(1, 5):
        check(idx, srcs[:g], "index", offset=1, out_of_range=3)
    gather_steps(idx, srcs, "index", offset=1, out_of_range=3)
    del idx, srcs
    for nb, np_, pads, offset in ((10**8, 10**8, 0, 0),
                                  (1 << 19, (1 << 19) + 99, 4000, 1)):
        ties = torch.cat((torch.arange(nb, device=dev),
                          torch.arange(np_, device=dev) + GT.PROBE_TIE,
                          torch.full((pads,), GT.PAD_TIE, device=dev)))
        n = ties.numel()
        idx = torch.empty(n + offset, dtype=torch.int32, device=dev)[offset:]
        idx.copy_(ties[torch.randperm(n, generator=gen, device=dev)])
        del ties
        srcs = [rand32(nb), rand32(np_)]
        case = dict(build=nb, probe=np_, pads=pads, offset=offset)
        check(idx, srcs, "tagged", **case)
        if GT.takes_partitioned(srcs):
            gather_steps(idx, srcs, "tagged", **case)
        else:
            gather_steps(idx, srcs, "tagged", 1 << 16, 1 << 12, **case)
        del idx, srcs
        torch.cuda.empty_cache()
    n26 = 1 << 26
    src = [rand32(n26)]
    ar = torch.arange(n26, dtype=torch.int32, device=dev)
    quarter = perm(n26)
    quarter[: n26 // 4] += n26
    for skew, idx in (("identity", ar), ("reversal", ar.flip(0)),
                      ("one_index", torch.full_like(ar, 12345)),
                      ("quarter_out_of_range", quarter)):
        check(idx, src, "index", skew=skew)
        gather_steps(idx, src, "index", skew=skew)
    del ar, quarter, src
    for n in (1 << 20, GT.WINDOW_BYTES // 4):
        idx = perm(n)
        idx[:2] = torch.tensor([-7, n], dtype=torch.int32, device=dev)
        check(idx, [rand32(n)], "index", out_of_range=2)
        del idx
    torch.cuda.empty_cache()


def merge_inputs(dev, na, nb, ncmp, planes, keys, seed):
    """Two ascending runs of ``planes`` int32 planes on the card: keys
    uniform, ``equal`` (one value) or ``ffffffff`` (half of them the
    sign-biased 0xFFFFFFFF, the pads' key), the tie plane (lex2) unique
    where the keys are uniform, else random, payloads random."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run(n, base):
        if keys == "equal":
            k = torch.full((n,), 0x5EED, dtype=torch.int32, device=dev)
        elif keys == "ffffffff":
            k = torch.where(torch.rand(n, device=dev, generator=gen) < 0.5,
                            PAD, torch.randint(0, 1 << 20, (n,), device=dev,
                                               generator=gen,
                                               dtype=torch.int32))
        else:
            k = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                              device=dev, generator=gen)
        rest = [torch.arange(base, base + n, dtype=torch.int32, device=dev)
                if i == 0 and keys == "uniform" else
                torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                              device=dev, generator=gen)
                for i in range(planes - 1)]
        if ncmp == 2:  # (key, tie) order: stable by the tie, then the key
            order = torch.sort(rest[0], stable=True).indices
            order = order[torch.sort(k[order], stable=True).indices]
        else:
            order = torch.sort(k, stable=True).indices
        return [k[order], *(r[order] for r in rest)]

    return run(na, 0), run(nb, na)


def merge_checks(dev):
    """``merge_runs`` (csrc/merge.cu) against its plain version on the card,
    bit for bit, the key XOR on: 1 to 4 planes (keys, lex2, lex2 and one
    or two payloads, keys and three riders) at lengths from 0 to 2^28 in
    all; runs shorter than a tile, and a tile, a row less and a row more at
    each tile size (``THREADS`` x ``ITEMS``); the main paths' shapes (the
    8-shard mesh's last merge, 2^24 + 2^24; two runs of 2^27, the four-card
    cell's first level); all-equal keys and real 0xFFFFFFFF keys; runs and
    outputs that start 1, 2 or 3 rows past a 16-byte boundary (views of
    larger planes; the rows around the output untouched)."""
    from radx_tpu_torch.kernels import merge as MG

    def tile(planes):
        return MG.THREADS * MG.ITEMS[planes]

    def at(run, off):
        """``run``'s planes as views ``off`` rows into larger planes."""
        n = run[0].numel()
        held = torch.zeros((len(run), n + 8), dtype=torch.int32, device=dev)
        base = (4 - (held.data_ptr() >> 2) % 4) % 4
        held[:, base + off:base + off + n] = torch.stack(run)
        return [h[base + off:base + off + n] for h in held]

    # (na, nb, ncmp, planes, keys, offsets of a / b / out)
    cases = [(0, 1 << 20, 1, 1, "uniform"), (1 << 20, 0, 2, 2, "uniform"),
             (1, 1, 1, 1, "uniform"), (2047, 2049, 2, 3, "uniform"),
             (5, 17, 1, 1, "uniform"), (100, 1000, 2, 3, "uniform"),
             *((na, tile(p) + d - na, ncmp, p, "uniform")
               for ncmp, p in ((1, 1), (2, 3)) for d in (-1, 0, 1)
               for na in (tile(p) // 3,)),
             (1 << 24, 1 << 24, 1, 1, "uniform"),
             ((1 << 27) + 3, (1 << 27) - 3, 1, 1, "uniform"),
             (1 << 27, 1 << 27, 2, 3, "uniform"),
             ((1 << 20) + 3, (1 << 20) - 1, 1, 4, "uniform"),
             (1 << 22, 12345, 2, 4, "uniform"),
             ((1 << 24) + 1, 1 << 23, 1, 1, "equal"),
             ((1 << 22) + 5, 1 << 22, 2, 3, "equal"),
             (1 << 24, (1 << 24) - 7, 1, 1, "ffffffff"),
             (1 << 24, (1 << 24) - 7, 2, 2, "ffffffff")]
    cases = [(*c, (0, 0, 0)) for c in cases] + [
        ((1 << 22) + 1, (1 << 21) + 7, 1, 1, "uniform", (1, 2, 3)),
        (1 << 22, (1 << 22) + 9, 2, 3, "uniform", (3, 1, 2)),
        (tile(4) - 1, 2, 2, 4, "uniform", (2, 3, 1)),
        (777, 5, 1, 2, "uniform", (1, 1, 1)),
        ((1 << 23) + 5, 1 << 23, 1, 1, "uniform", (2, 1, 3)),
        ((1 << 22) + 5, 1 << 22, 2, 2, "equal", (0, 0, 1))]
    for i, (na, nb, ncmp, planes, keys, (oa, ob, oo)) in enumerate(cases):
        a, b = merge_inputs(dev, na, nb, ncmp, planes, keys, 70 + i)
        a, b = at(a, oa), at(b, ob)
        n = a[0].numel() + b[0].numel()
        held = torch.full((planes, n + 8), 7, dtype=torch.int32, device=dev)
        base = (4 - (held.data_ptr() >> 2) % 4) % 4
        out = [h[base + oo:base + oo + n] for h in held]
        MG.merge_runs(a, b, ncmp, out=out, key_xor=SIGN)
        want = MG.merge_runs_ref(a, b, ncmp, key_xor=SIGN)
        e = _max_err(out, want)
        untouched = bool((held[:, :base + oo] == 7).all()
                         and (held[:, base + oo + n:] == 7).all())
        record(["merge_runs"], e, e == 0 and untouched, na=na, nb=nb,
               ncmp=ncmp, planes=planes, keys=keys, offsets=[oa, ob, oo],
               items=MG.ITEMS[planes])
        del a, b, held, out, want
    torch.cuda.empty_cache()


@contextlib.contextmanager
def window(name, required, top=(), prep=None):
    """Drive one path inside the block: every launch count is set to 0 just
    before it and read just after it.  Fails unless every kernel of
    ``required`` launched at least once, every kernel of ``top`` at least
    once on its compile-time plan, and no plain version ran.  ``prep``:
    "none", the path's sorts make their planes in the network's first and
    last launches, so no call of PyTorch's preparation
    (``ops/sort.PREP_CALLS``) may run on the card; "runs", the path keeps
    that preparation (the radix sort), so some call must run."""
    from radx_tpu_torch.ops import sort as S

    mods = _kernel_modules()
    torch.cuda.synchronize()
    for m in mods:
        m.reset_counts()
    S.reset_prep_counts()
    yield
    torch.cuda.synchronize()
    launches, plain = {}, {}
    for m in mods:
        launches.update(m.LAUNCHES)
        plain.update(m.PLAIN_CALLS)
    for k, v in launches.items():
        TOTAL_LAUNCHES[k] = TOTAL_LAUNCHES.get(k, 0) + v
    from radx_tpu_torch.kernels import bitonic as B

    tops = {k: v for k, v in B.TOP_LAUNCHES.items() if v}
    preps = {k: v for k, v in S.PREP_CALLS.items() if v}
    _line("counts", path=name, launches={k: v for k, v in launches.items() if v},
          compile_time_plan_launches=tops, plain_calls=plain,
          prep_calls=preps, prep_rule=prep)
    missing = [k for k in required if launches[k] < 1]
    missing += [f"{k} (compile-time plan)" for k in top if k not in tops]
    if missing or any(plain.values()):
        _fail(f"kernels not launched by the {name} path: {missing}; "
              f"plain calls {plain}")
    if prep == "none" and preps:
        _fail(f"the {name} path prepared its planes with PyTorch: {preps}")
    if prep == "runs" and not preps:
        _fail(f"the {name} path no longer runs PyTorch's preparation")


def src_kernels(ncmp, planes, distances=None, unbias=True):
    """The launch names of a sort whose planes the network makes
    (``bitonic.sort_kernels``: the source chunk sort, the cross passes,
    finish and, where the keys come back, the unbiasing finish)."""
    from radx_tpu_torch.kernels import bitonic as B

    return B.sort_kernels(ncmp, planes, distances, unbias)


def top_src(ncmp, planes, distances, unbias=True):
    """``top_kernels`` of such a sort: its source chunk sort, finish, the
    unbiasing finish and the strided passes, on compile-time plans."""
    from radx_tpu_torch.kernels import bitonic as B

    first, last = B.source_kernels(ncmp, planes)
    rest = [k for k in top_kernels(ncmp, planes, distances)
            if not k.startswith("chunk_sort")]
    return (first, *rest, *((last,) if unbias else ()))


def top_kernels(ncmp, planes, distances):
    """The launch names that a sort of one mode runs on compile-time plans:
    its chunk sort, finish, and the strided cross passes (more than
    max_fusion(P) distances) that ``distances`` a level reach, in the modes
    where they have one (``bitonic.TOP_MODES``)."""
    from radx_tpu_torch.kernels import bitonic as B

    r = B.max_fusion(planes)
    strided = planes in B.TOP_MODES["cross_stage"]
    return tuple(k for k in B.mode_kernels(ncmp, planes, distances)
                 if not k.startswith("cross_stage<") or strided
                 and int(k[len("cross_stage<"):].split(">")[0]) > r)


@contextlib.contextmanager
def peak_memory(name, recorded_gib, *inputs):
    """Print the block's peak device memory as the benchmark counts it
    (``max_memory_allocated`` around one call, its inputs included: the
    peak over what was allocated before the block, plus the inputs'
    bytes), beside the figure PERF.md records for the cell."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    held = sum(x.numel() * x.element_size() for x in inputs)
    _line("peak", path=name, peak_device_gib=(extra + held) / 2**30,
          perf_md_gib=recorded_gib)


def _lex(*planes):
    from radx_tpu_torch.kernels import bitonic as B

    return tuple(k for p in planes for k in B.mode_kernels(2, p))


def _dense_ref_slabs(keys, vals, n_valid, is_min=None, slab=1 << 27):
    """The plain dense_sums (is_min None) or dense_extrema over ``slab``-row
    slabs, each with its share of ``n_valid``, combined: (int64 sums or
    int32 extrema, int64 counts)."""
    from radx_tpu_torch.kernels import aggregate as AG

    acc = cnt = None
    for s in range(0, keys.numel(), slab):
        k, v = keys[s: s + slab], vals[s: s + slab]
        nv = (n_valid - s).clamp(0, k.numel()).to(torch.int32)
        if is_min is None:
            out, c = AG.dense_sums_ref(k, v, 256, nv)
            out = _i32(out).long() & 0xFFFFFFFF
            acc = out if acc is None else (acc + out) & 0xFFFFFFFF
        else:
            out, c = AG.dense_extrema_ref(k, v, 256, is_min, nv)
            acc = out if acc is None else (
                torch.minimum(acc, out) if is_min else torch.maximum(acc, out))
        cnt = c.long() if cnt is None else cnt + c.long()
    return acc, cnt


def dense_path(dev, card):
    """BASELINE config 3 at 2^30 rows through LazyTable: filter(pred < 2^31),
    then the dense group-by (256 buckets) for every aggregate, under the
    sync guard until ``collect()``; then K8 / K9 held against their plain
    versions on the path's own inputs (2^30 rows, the kept count as
    n_valid)."""
    from radx_tpu_torch import bench
    from radx_tpu_torch.examples.query_pipeline import no_sync
    from radx_tpu_torch.kernels import aggregate as AG
    from radx_tpu_torch.kernels import compact as CP

    table = bench.query_dense_data(1 << 30)
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    with window("config3_dense_lazy_2e30", (*AG.KERNELS, *CP.KERNELS)):
        with no_sync(dev):  # raises on any sync until collect()
            lt = table.lazy()
            kept = lt.filter(_i32(lt.column("pred")) >= 0)
            lazies = {agg: kept.groupby("bucket", "value", agg, bins=256)
                      for agg in AGGS}
        dense = {agg: t.collect() for agg, t in lazies.items()}
    _line("memory", what="config-3 dense query at 2^30 through LazyTable "
          "(3 input columns, filter, 4 group-bys)",
          max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
          input_column_bytes=3 * 4 * table.num_rows,
          free_total_before=free0, **card)
    kept_rows = int(kept.count)
    ref = bench.query_dense_ref(table)
    if kept_rows != int(ref[0].sum()):
        _fail("the dense query kept another row count than the reference")
    for agg in AGGS:
        g = bench.check_query_dense(dense[agg], ref, agg)
        _line("slice", input=f"config3_dense_lazy_n{table.num_rows}", agg=agg,
              kept=kept_rows, groups=g, sync_guard="error until collect()",
              equal_reference=True)
    del dense, lazies, ref

    keys, vals, nv = kept.column("bucket"), kept.column("value"), kept.count
    case = dict(n=keys.numel(), n_valid=kept_rows, bins=256,
                keys="config3_bucket")
    got_s, got_c = AG.dense_sums(keys, vals, 256, nv)
    want_s, want_c = _dense_ref_slabs(keys, vals, nv)
    e = max(int((_i32(got_s).long() & 0xFFFFFFFF).sub(want_s).abs().max()),
            int((got_c.long() - want_c).abs().max()))
    record(["dense_sums"], e, e == 0, **case)
    for is_min in (True, False):
        got_e, got_c = AG.dense_extrema(keys, vals, 256, is_min, nv)
        want_e, want_c = _dense_ref_slabs(keys, vals, nv, is_min)
        e = max(int((got_e.long() - want_e.long()).abs().max()),
                int((got_c.long() - want_c).abs().max()))
        record(["dense_extrema"], e, e == 0, op="min" if is_min else "max",
               **case)
    del table, kept, keys, vals
    torch.cuda.empty_cache()


@contextlib.contextmanager
def sorted_rows(seen):
    """Append to ``seen`` the rows of every ``bitonic.sort_planes`` call
    inside the block (the whole sorts and the arbitrary-N pieces)."""
    from radx_tpu_torch.kernels import bitonic as B

    real = B.sort_planes

    def spy(x, *args, **kwargs):
        seen.append(x.numel())
        return real(x, *args, **kwargs)

    B.sort_planes = spy
    try:
        yield
    finally:
        B.sort_planes = real


@contextlib.contextmanager
def overhang_passes(seen):
    """Append to ``seen`` (rows, launches) of every valley-merge overhang
    inside the block: the rows of its planes and the ``cross_stage<1>``
    launches the pass made (one: the row-limited cross pass)."""
    from radx_tpu_torch.kernels import bitonic as B

    real = B._overhang

    def spy(planes, *args, **kwargs):
        before = sum(v for k, v in B.LAUNCHES.items()
                     if k.startswith("cross_stage<1>"))
        real(planes, *args, **kwargs)
        seen.append((planes[0].numel(), sum(
            v for k, v in B.LAUNCHES.items()
            if k.startswith("cross_stage<1>")) - before))

    B._overhang = spy
    try:
        yield
    finally:
        B._overhang = real


def check_overhangs(name, seen, expect):
    """The window's valley merges ran ``expect`` overhangs, each as one
    row-limited ``cross_stage<1>`` launch (the window itself fails on any
    call of the plain ``_cx_directed``)."""
    _line("overhang", path=name, passes=[{"rows": r, "launches": k}
                                         for r, k in seen])
    if len(seen) != expect or any(k != 1 for _, k in seen):
        _fail(f"{name}: the valley merges' overhangs ran {seen}, expected "
              f"{expect} row-limited cross_stage<1> launches")


def join_path(dev):
    """Config 4 (``Table.join`` of two 10^8-row tables, inner and left with
    float32 build values: the union sorted at its own length, pieces of
    2^27 and 2^26 rows), ``LazyTable.join`` under ``"radix"`` and the sync
    guard with a union in pieces, and the multi-match join at 2^24, each
    exactly against a plain torch reference."""
    from radx_tpu_torch import SortConfig, Table
    from radx_tpu_torch import bench
    from radx_tpu_torch.examples.query_pipeline import no_sync
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import compact as CP
    from radx_tpu_torch.kernels import msd as M
    from radx_tpu_torch.kernels import radix as RX
    from radx_tpu_torch.kernels import segscan as SG
    from radx_tpu_torch.ops import join as J
    from radx_tpu_torch.ops import sort as S

    # the union's (key, tie) sort, its value planes' gather (sides of 10^8
    # and 2^24 rows: the partitioned route), scan, compact
    join_kernels = (*src_kernels(2, 2, unbias=False),
                    *gather_routes("tagged", "partitioned"),
                    *SG.KERNELS, *CP.KERNELS)
    gen = torch.Generator(device=dev).manual_seed(31)

    def rand32(n):
        return torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                             generator=gen, device=dev)

    def union_rows(n):
        """The rows the union's network sorts: whole lex2 blocks."""
        chunk = SortConfig().lex_tiles(2)[0]
        return S._decompose_blocks(n, chunk)[0] * chunk

    n8 = 10**8
    build, probe = bench._join_tables(n8)
    want = bench.torch_join_ref(build.column("k"), build.column("w"),
                                probe.column("k"), probe.column("v"))
    pieces, overhangs = [], []
    with window("config4_join_inner_1e8", join_kernels,
                top_src(2, 2, 14, unbias=False), prep="none"), peak_memory(
            "config4_join_inner_1e8", 8.95094,
            *(t.column(c) for t, c in ((build, "k"), (build, "w"),
                                       (probe, "k"), (probe, "v")))), \
            sorted_rows(pieces), overhang_passes(overhangs):
        inner = probe.join(build, "k", "v", "w")
    bench.check_join(inner, "k", "v", "w", want)
    # pieces of 2^27 and 2^26 rows: one valley merge, one overhang
    check_overhangs("config4_join_inner_1e8", overhangs, 1)
    if sum(pieces) != union_rows(2 * n8) or len(pieces) != 2:
        _fail(f"the union of 2 x 10^8 rows sorted pieces of {pieces} rows")
    _line("slice", input=f"config4_join_inner_n{n8}x{n8}", rows=inner.num_rows,
          union_rows=2 * n8, union_sorted_rows=sum(pieces),
          union_pieces=pieces, pow2_rows=S._pad_len(2 * n8),
          equal_reference=True)
    del inner, want
    build_f = Table({"k": build.column("k"),
                     "w": build.column("w").view(torch.float32)})
    with window("config4_join_left_float32_1e8", join_kernels, prep="none"):
        left = probe.join(build_f, "k", "v", "w", how="left", missing=-1.5)
    bench.check_join(left, "k", "v", "w", bench.torch_join_ref(
        build.column("k"), build.column("w"), probe.column("k"),
        probe.column("v"), how="left",
        missing_bits=int(np.float32(-1.5).view(np.int32))))
    if left.num_rows != n8 or left.column("w").dtype != torch.float32:
        _fail("the left join lost probe rows or the build dtype")
    _line("slice", input=f"config4_join_left_float32_n{n8}x{n8}",
          rows=left.num_rows, equal_reference=True, build_bits_kept=True)
    del build, probe, build_f, left

    # LazyTable.join under "radix" with a union of 2 x 5 * 2^20 rows (2^24
    # as a power of two): its pieces stay on the network, so nothing reads
    # the host and no radix kernel runs until collect()
    n20 = 5 << 20
    build, probe = bench._join_tables(n20)
    radix = SortConfig(strategy="radix")
    pieces = []
    with window("lazy_join_radix_arbn", join_kernels, prep="none"), \
            sorted_rows(pieces):
        with no_sync(dev):
            lazy = probe.lazy(radix).join(build.lazy(radix), "k", "v", "w")
        got = lazy.collect()
    ran = {k: v for m in (B, RX, M) for k, v in m.LAUNCHES.items()
           if v and k in (*B.RADIX_KERNELS, *RX.KERNELS, *M.KERNELS)}
    if ran or sum(pieces) != union_rows(2 * n20) or len(pieces) < 2:
        _fail(f"the lazy join's union ran radix kernels {ran} or sorted "
              f"pieces of {pieces} rows")
    bench.check_join(got, "k", "v", "w", bench.torch_join_ref(
        build.column("k"), build.column("w"), probe.column("k"),
        probe.column("v")))
    _line("slice", input=f"lazy_join_radix_n{n20}x{n20}", rows=got.num_rows,
          union_sorted_rows=sum(pieces), union_pieces=pieces,
          pow2_rows=S._pad_len(2 * n20), sync_guard="error until collect()",
          radix_launches=0, equal_reference=True)
    del build, probe, lazy, got

    # the multi-match join: every build key 4 times, one key 5 times
    n24 = 1 << 24
    base_keys = bench._distinct_u32(0, n24 // 4, dev)
    bk = _i32(base_keys).repeat_interleave(4)
    bk[-1] = _i32(base_keys)[0]
    bk = bk[torch.randperm(n24, generator=gen, device=dev)].view(torch.uint32)
    bv = rand32(n24).view(torch.uint32)
    hit = _i32(base_keys)[torch.randint(0, n24 // 4, (n24 * 9 // 10,),
                                        generator=gen, device=dev)]
    miss = _i32(bench._distinct_u32(n24, n24 - hit.numel(), dev))
    pk = torch.cat((hit, miss))[torch.randperm(n24, generator=gen,
                                               device=dev)].view(torch.uint32)
    pv = rand32(n24).view(torch.uint32)
    with window("join_multi_2e24", join_kernels, prep="none"):
        truncated = {m: J.join_merge_multi(bk, bv, pk, pv, m)[4]
                     for m in (4, 6)}
        multi = Table({"k": pk, "v": pv}).join(
            Table({"k": bk, "w": bv}), "k", "v", "w", max_matches=6)
    truncated = {m: bool(t) for m, t in truncated.items()}
    if truncated != {4: True, 6: False}:
        _fail(f"join_merge_multi truncated flags {truncated}")
    bs = torch.sort(_i32(bk) ^ SIGN, stable=True)
    po = torch.sort(_i32(pk) ^ SIGN, stable=True).indices
    pb = (_i32(pk) ^ SIGN)[po]
    lo = torch.searchsorted(bs.values, pb)
    cnt = torch.searchsorted(bs.values, pb, right=True) - lo
    j = torch.arange(6, device=dev)
    valid = j < cnt[:, None]
    idx = (lo[:, None] + j).clamp(max=n24 - 1)
    want = [(pb ^ SIGN)[:, None].expand(-1, 6)[valid],
            _i32(bv)[bs.indices[idx]][valid],
            _i32(pv)[po][:, None].expand(-1, 6)[valid]]
    bench.check_join(multi, "k", "v", "w", want)
    _line("slice", input=f"join_multi_n{n24}_max6", rows=multi.num_rows,
          truncated=truncated, equal_reference=True)
    del bk, bv, pk, pv, multi, bs, po, pb, lo, cnt, valid, idx, want, hit, miss
    torch.cuda.empty_cache()


def sort_path(dev):
    """Config 2 (stable ``sort_pairs`` of 2^28 pairs: the (key, index)
    sort and the payload's gather), ``assume_unique`` on a permutation,
    ``argsort`` (also on the arbitrary-N path), ``sort_multi``,
    ``sort_u64``, 64-bit ``sort_any``, ``top_k`` and ``LazyTable.sort_by``
    on 2..6 columns, each exactly against torch (or numpy)."""
    from radx_tpu_torch import (SortConfig, Table, argsort, sort_any,
                                sort_pairs, sort_u64, top_k)
    from radx_tpu_torch import bench
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.ops import sort as S

    i32 = torch.int32
    gen = torch.Generator(device=dev).manual_seed(32)

    def rand32(n, lo=-(2**31), hi=2**31):
        return torch.randint(lo, hi, (n,), dtype=i32, generator=gen,
                             device=dev)

    n28 = 1 << 28
    keys, payload = bench.pairs_data(n28)
    required = (*src_kernels(2, 2), *gather_routes("index", "partitioned"))
    with window("config2_sort_pairs_stable_2e28", required,
                top_src(2, 2, 15), prep="none"), peak_memory(
            "config2_sort_pairs_stable_2e28", 6.0, keys, payload):
        got = sort_pairs(keys, payload)
    want = bench.torch_sort_pairs(keys, payload)
    if not all(torch.equal(_i32(a), _i32(b)) for a, b in zip(got, want)):
        _fail("sort_pairs differs from torch.sort(stable=True)")
    _line("slice", input=f"config2_sort_pairs_stable_n{n28}",
          equal_reference=True)
    del got, want, keys
    perm = torch.randperm(n28, generator=gen, device=dev).to(i32)
    with window("sort_pairs_assume_unique_2e28", src_kernels(1, 2),
                prep="none"):
        gk, gp = sort_pairs(perm.view(torch.uint32), payload,
                            assume_unique=True)
    wp = torch.empty_like(_i32(payload))
    wp[perm.long()] = _i32(payload)
    if not (torch.equal(_i32(gk), torch.arange(n28, dtype=i32, device=dev))
            and torch.equal(_i32(gp), wp)):
        _fail("sort_pairs(assume_unique=True) differs on a permutation")
    _line("slice", input=f"sort_pairs_assume_unique_n{n28}",
          equal_reference=True)
    del perm, payload, gk, gp, wp

    n26, n_odd, small = 1 << 26, 3 * (1 << 22) + 7, 1 << 22
    k26 = rand32(n26, 0, 1 << 20)
    if not S._use_decomposition(n_odd, SortConfig()):
        _fail(f"n = {n_odd} does not take the arbitrary-N path")
    with window("argsort_2e26_and_arbitrary_n", src_kernels(2, 2,
                                                           unbias=False),
                prep="none"):
        got = argsort(k26.view(torch.uint32))
        got_odd = argsort(k26[:n_odd].view(torch.uint32))
    if not torch.equal(got.long(), _biased_order(k26)):
        _fail("argsort differs from torch.sort(stable=True)")
    if not torch.equal(got_odd.long(), _biased_order(k26[:n_odd])):
        _fail("argsort on the arbitrary-N path differs from torch.sort")
    _line("slice", input="argsort_pow2_and_arbitrary_n", n=n26, n_odd=n_odd,
          equal_reference=True)
    del got, got_odd
    pays = [rand32(n26) for _ in range(6)]
    for m, size in ((5, n26), (3, small), (4, small), (6, small)):
        with window(f"sort_multi_{m}_payloads",
                    (*src_kernels(2, 2),
                     *gather_routes("index", "partitioned")), prep="none"):
            sk, sp = S.sort_multi(k26[:size].view(torch.uint32),
                                  [p[:size].view(torch.float32)
                                   for p in pays[:m]])
        o = _biased_order(k26[:size])
        if not (torch.equal(_i32(sk), k26[o]) and all(
                torch.equal(_i32(a), p[:size][o]) for a, p in zip(sp, pays))):
            _fail(f"sort_multi with {m} payloads differs at n={size}")
        _line("slice", input=f"sort_multi_{m}_payloads", n=size,
              gathers=-(-m // 4), equal_reference=True)
    del sk, sp, o
    hi, lo_ = pays[0], pays[1]
    with window("sort_u64_2e26", _lex(2)):
        sh, sl = sort_u64(hi.view(torch.uint32), lo_.view(torch.uint32))
    packed = ((hi ^ SIGN).long() << 32) | (lo_.long() & 0xFFFFFFFF)
    ws = torch.sort(packed).values
    if not (torch.equal(_i32(sh) ^ SIGN, (ws >> 32).to(i32)) and
            torch.equal(_i32(sl).long() & 0xFFFFFFFF, ws & 0xFFFFFFFF)):
        _fail("sort_u64 differs from torch.sort of the packed 64-bit keys")
    _line("slice", input="sort_u64", n=n26, equal_reference=True)
    del sh, sl, packed, ws, pays

    rng64 = np.random.default_rng(40)
    inputs = (("int64", rng64.integers(-(2**63), 2**63 - 1, small,
                                       dtype=np.int64)),
              ("float64", rng64.standard_normal(small)))
    with window("sort_any_64bit_2e22", _lex(2)):
        got = {(name, desc): sort_any(x, desc, device=dev)
               for name, x in inputs for desc in (False, True)}
    for name, x in inputs:
        for desc in (False, True):
            want = np.sort(x)[::-1] if desc else np.sort(x)
            if not np.array_equal(got[name, desc], want):
                _fail(f"64-bit sort_any ({name}, descending={desc}) differs")
    _line("slice", input="sort_any_64bit", n=small,
          dtypes=["int64", "float64"], equal_numpy=True)

    # top_k on float keys with NaN and ties
    fkeys = torch.randn(n26, generator=gen, device=dev)
    fkeys[torch.randint(0, n26, (n26 // 1000,), generator=gen,
                        device=dev)] = float("nan")
    fkeys[: n26 // 4] = torch.round(fkeys[: n26 // 4] * 4) / 4  # ties
    cases = [(k, largest) for k in (1, 100, 10_000) for largest in (True, False)]
    with window("top_k_2e26", _lex(2)):
        got = {c: top_k(fkeys, *c) for c in cases}
    fb = _i32(fkeys)
    enc = torch.where(fb < 0, ~fb ^ SIGN, fb)  # order-isomorphic int32
    for k, largest in cases:
        v, ix = got[k, largest]
        o = _biased_order(~enc if largest else enc)[:k]
        if not (torch.equal(ix.long(), o) and torch.equal(_i32(v), fb[o])):
            _fail(f"top_k(k={k}, largest={largest}) differs")
    _line("slice", input="top_k_float32_nan", n=n26, k=[1, 100, 10_000],
          equal_reference=True)
    del k26, fkeys, fb, enc, got

    # LazyTable.sort_by sends the (key', tie) planes and every column
    # through the network: 2..6 columns are the lex4..lex8 modes
    n20 = 1 << 20
    cols = {f"c{j}": rand32(n20) for j in range(6)}
    cols["c0"] = rand32(n20, 0, 1 << 12)  # ties
    o = torch.sort(cols["c0"], stable=True).indices
    for m in range(2, 7):
        names = list(cols)[:m]
        with window(f"lazy_sort_by_{m}_columns", _lex(2 + m)):
            got = Table({k: cols[k] for k in names}).lazy().sort_by(
                "c0").collect()
        if not all(torch.equal(got.column(k), cols[k][o]) for k in names):
            _fail(f"LazyTable.sort_by with {m} columns differs")
        _line("slice", input=f"lazy_sort_by_{m}_columns", n=n20,
              planes=2 + m, equal_reference=True)
    del cols, o, got
    torch.cuda.empty_cache()


def rider_arbn_path(dev):
    """The group-by of db-benchmark q3's size, 1e8 rows over about 1e6 ids:
    the rider sort takes the arbitrary-N path (pieces of 2^26 and 2^25 rows,
    one valley merge: 100,663,296 rows instead of 2^27), then the segmented
    scan and the run-end compaction.  Sum and count exact against
    ``torch.unique`` + ``index_add_`` / ``bincount``."""
    from radx_tpu_torch import SortConfig, groupby
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import compact as CP
    from radx_tpu_torch.kernels import segscan as SG
    from radx_tpu_torch.ops import sort as S

    n, cfg = 10**8, SortConfig()
    blocks, sizes = S._decompose_blocks(n, cfg.rider_chunk_elems)
    if not S._use_decomposition(n, cfg) or sizes != [8192, 4096]:
        _fail(f"n = {n} does not take the arbitrary-N rider sort")
    gen = torch.Generator(device=dev).manual_seed(53)
    ids = torch.randint(1, 1_000_001, (n,), dtype=torch.int32, generator=gen,
                        device=dev)
    v1 = torch.randint(1, 101, (n,), dtype=torch.int32, generator=gen,
                       device=dev)
    overhangs = []
    with window("groupby_rider_arbn_1e8",
                (*src_kernels(1, 2), *SG.KERNELS, *CP.KERNELS),
                top_src(1, 2, 13), prep="none"), \
            overhang_passes(overhangs):
        res = {agg: groupby(ids.view(torch.uint32), v1.view(torch.uint32),
                            agg, cfg) for agg in ("sum", "count")}
    # two rider sorts, each of pieces of 2^26 and 2^25 rows: one valley
    # merge and one overhang a sort
    check_overhangs("groupby_rider_arbn_1e8", overhangs, 2)
    want_ids, inv = torch.unique(ids, sorted=True, return_inverse=True)
    g = want_ids.numel()
    want = {"sum": torch.zeros(g, dtype=torch.int64, device=dev).index_add_(
                0, inv, v1.long()),
            "count": torch.bincount(inv, minlength=g)}
    for agg, (uk, out, ng) in res.items():
        ok = (uk.numel() == blocks * cfg.rider_chunk_elems and int(ng) == g
              and torch.equal(_i32(uk[:g]), want_ids)
              and torch.equal(_i32(out[:g]).long(), want[agg]))
        _line("slice", input=f"groupby_{agg}_arbn_1e8", n=n, groups=g,
              padded_rows=uk.numel(), pow2_rows=S._pad_len(n),
              equal_reference=bool(ok))
        if not ok:
            _fail(f"the arbitrary-N group-by ({agg}) at n = {n} differs "
                  "from torch.unique + index_add_")
    del ids, v1, res, want, inv
    torch.cuda.empty_cache()


def example_path(dev):
    """The query_pipeline example at 2^26 sales rows and 2^16 stores, eager
    and lazy (sync guard in the lazy one), checked against numpy."""
    from radx_tpu_torch.examples import query_pipeline
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import compact as CP
    from radx_tpu_torch.kernels import segscan as SG

    # filter, sort-based group-by (rider sort, segscan), joins (their
    # (key, tie) sorts and the value planes' gather), the eager distinct and
    # sort_by ((key, index) and the columns' gather), the lazy sort_by
    # (every column through the network: five planes over the joined
    # 2^17 rows, four over the 16,384-row query, which reaches F <= 2),
    # top_k's chunk pass (its final sort of 24 candidates fits one chunk)
    required = (*CP.KERNELS, *SG.KERNELS, *src_kernels(1, 2), *_lex(2, 5),
                *B.source_kernels(2, 2), "chunk_sort/lex4",
                "cross_stage<1>/lex4",
                "cross_stage<2>/lex4", "finish/lex4", "gather_planes",
                "gather_planes/tagged")
    with window("query_pipeline_example", required):
        ex = query_pipeline.run(1 << 26, 1 << 16, dev)
    _line("slice", input="query_pipeline_example", **ex, eager=True,
          lazy="sync guard until collect()", equal_numpy=True)


def _timed(fn):
    """(fn(), host seconds), the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _staged(name):
    """Check that every copy of the streamed calls since the last
    ``_staging.reset_stats()`` went through pinned pieces on a copy stream;
    print the staged bytes and GB/s each way."""
    from radx_tpu_torch.ops import _staging

    st = dict(_staging.STATS)
    pieces = st["pieces_up"] + st["pieces_down"]
    _line("chunked", staged=name, **st,
          staged_to_card_gb_per_s=st["bytes_up"] / max(st["seconds_up"], 1e-9) / 1e9,
          staged_to_host_gb_per_s=st["bytes_down"] / max(st["seconds_down"], 1e-9) / 1e9)
    if not pieces or st["pinned_pieces"] != pieces:
        _fail(f"{name}: {st['pinned_pieces']} of {pieces} pieces went "
              "through pinned memory on a copy stream")


def chunked_path(dev, card):
    """Slice 9, the streaming operators: BASELINE config 3 eager at 2^30
    rows from host memory (``filter_chunked`` + ``groupby_chunked``, slabs
    of ``chunked.SLAB``) against the plain answer built in slabs on the
    card, beside the LazyTable query on the same rows; ``sort_chunked`` of
    5 * 2^26 + 7 keys in slabs of 2^26 (8 runs, three merge levels, a last
    merge of 2^29 keys) and of one slab (the shortcut through ``sort``),
    against ``torch.sort``.  Every streamed copy must have gone through the
    pinned staging ring on a copy stream (``_staged``); the host copies'
    measurements (``bench.measure_host_copies``) and the query's phases
    (mask, ``filter_chunked``, ``groupby_chunked``) are printed."""
    from radx_tpu_torch import bench
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import compact as CP
    from radx_tpu_torch.kernels import segscan as SG
    from radx_tpu_torch.ops import _staging, chunked
    from radx_tpu_torch.utils import timing

    _line("chunked", **bench.measure_host_copies(), **card)
    n30 = 1 << 30
    table = bench.query_dense_data(n30)
    ref = bench.query_dense_ref(table)
    lazy = timing.time_cuda(lambda: bench.run_query_dense(table, "sum"),
                            iters=1, repeats=3, warmup=1)
    cols = tuple(table.column(c).cpu().numpy()
                 for c in ("bucket", "value", "pred"))
    del table
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _staging.reset_stats()
    with window("config3_eager_chunked_2e30",
                (*src_kernels(1, 2), *CP.KERNELS, *SG.KERNELS)):
        res, first = _timed(lambda: bench.run_query_chunked(*cols))
    peak = torch.cuda.max_memory_allocated()
    _staged("config3_eager_chunked_2e30")
    g = bench.check_query_chunked(*res, ref)
    _line("slice", input=f"config3_eager_chunked_n{n30}", kept=res[0],
          groups=g, equal_reference=True)
    del res
    phases = {}
    _, secs = _timed(lambda: bench.run_query_chunked(*cols, phase_ms=phases))
    _line("chunked", what="config 3 eager at 2^30 rows from host memory: "
          "filter_chunked(pred < 2^31) + groupby_chunked sum by bucket, the "
          "host mask and the copies included; seconds: a second run by the "
          "host clock, first_seconds: the window's; phase_ms: the second "
          "run's host-clock phases", rows_per_s=n30 / secs,
          seconds=secs, first_seconds=first, phase_ms=phases,
          slab=chunked.SLAB, max_memory_allocated_bytes=peak,
          lazytable_rows_per_s=n30 / lazy.seconds,
          lazytable_ms=lazy.seconds * 1e3,
          lazytable_spread_pct=lazy.spread_pct, **card)
    del cols, ref

    n = 5 * (1 << 26) + 7
    gen = torch.Generator(device=dev).manual_seed(91)
    keys_dev = bench._randint(-(2**31), 2**31, n, gen).view(torch.uint32)
    keys = keys_dev.cpu().numpy()
    # many slabs: each slab's planes prepared on the card and merged by
    # the network's merge levels; one slab: ``sort`` itself
    for name, m, slab, required in (
            ("sort_chunked_8_runs_2e26_slabs", n, 1 << 26, B.KEY_KERNELS),
            ("sort_chunked_one_slab", (1 << 26) - 5, 1 << 26,
             src_kernels(1, 1))):
        _staging.reset_stats()
        with window(name, required):
            got, secs = _timed(lambda: chunked.sort_chunked(keys[:m],
                                                            slab=slab))
        _staged(name)
        want = bench.torch_sort_u32(keys_dev[:m])
        ok = got.dtype == np.uint32 and torch.equal(
            torch.from_numpy(got).to(dev).view(torch.int32), _i32(want))
        _line("chunked", window=name, n=m, slab=slab, keys_per_s=m / secs,
              seconds=secs, equal_torch_sort=ok, **card)
        if not ok:
            _fail(f"sort_chunked ({name}) differs from torch.sort")
        del got, want
    del keys, keys_dev
    torch.cuda.empty_cache()


def dist_path(dev, card):
    """Slice 9, the distributed sort (``parallel/``): the in-process mesh
    of 8 shards on the one card, 2^28 keys in all (flat with and without
    overlap, hier 4 x 2, stable and unstable pairs on keys below 2^16,
    argsort, ``sort_sharded_auto`` on presorted keys, ragged n on 6
    shards, all-0xFFFFFFFF keys with payloads through
    ``sort_pairs_sharded_auto``), each against torch; then one NCCL rank
    through ``init_multihost`` -> ``shard_global`` ->
    ``sort_sharded_guarded`` -> ``allgather_result`` at 2^26 keys, and
    ``dryrun_multichip(8)``.  The shards share one card, so no rate here
    says anything about scaling."""
    import torch.distributed as dist

    from radx_tpu_torch import bench, sort
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import merge as MG
    from radx_tpu_torch.parallel import Mesh, dryrun_multichip, multihost
    from radx_tpu_torch.parallel import dist_sort as DS

    n28 = 1 << 28
    gen = torch.Generator(device=dev).manual_seed(92)
    keys = bench._randint(-(2**31), 2**31, n28, gen).view(torch.uint32)
    want = bench.torch_sort_u32(keys)
    sort(keys)
    _, t_single = _timed(lambda: sort(keys))
    mesh8 = Mesh([dev] * 8)

    def rows_equal(rows, valid, expect):
        v = valid.tolist()
        got = torch.cat([_i32(rows[d, : v[d]]) for d in range(len(v))])
        return got.numel() == expect.numel() and torch.equal(got, _i32(expect))

    def drive(name, required, n, fn, check, prep="none"):
        """The path once in its window (checked by ``check(out) -> (ok,
        fields)``; every path runs the merge kernels too; ``prep`` as
        ``window``'s: the local sorts of keys and of (key, index) make their
        planes in the network), then once more by the host clock, warm, with
        its peak device memory (the peak over what was allocated before the
        call: inputs not counted)."""
        with window(name, (*required, *MG.KERNELS), prep=prep):
            out, first = _timed(fn)
        ok, extra = check(out)
        del out
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, secs = _timed(fn)
        del out
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        _line("dist", window=name, n=n, keys_per_s=n / secs, seconds=secs,
              peak_device_gib_above_inputs=peak, first_seconds=first,
              single_device_sort_keys_per_s_n2e28=n28 / t_single,
              equal_reference=ok, note="the shards share one card: no "
              "scaling can be read from this rate", **extra, **card)
        if not ok:
            _fail(f"{name} differs from the torch reference")

    def keys_ok(expect):
        return lambda o: (not o[2].any() and rows_equal(o[0], o[1], expect),
                          {})

    local = src_kernels(1, 1, unbias=False)  # the shards' local sorts
    for name, kw in (("dist_sort_flat_overlap_8x2e25", {}),
                     ("dist_sort_flat_no_overlap_8x2e25", {"overlap": False}),
                     ("dist_sort_hier_4x2_8x2e25", {"exchange": "hier"})):
        drive(name, local, n28,
              lambda: DS.sort_sharded(keys, mesh8, **kw), keys_ok(want))

    pk = bench._randint(0, 1 << 16, n28, gen)
    pv = bench._randint(-(2**31), 2**31, n28, gen)
    order = torch.sort(pk, stable=True).indices
    want_k, want_v = pk[order], pv[order]
    pk = pk.view(torch.uint32)
    for stable in (True, False):
        drive(f"dist_sort_pairs_{'stable' if stable else 'unstable'}_8x2e25",
              _lex(3), n28,
              lambda: DS.sort_pairs_sharded(pk, pv, mesh8, stable=stable),
              lambda o: (not o[3].any() and rows_equal(o[0], o[2], want_k)
                         and rows_equal(o[1], o[2], want_v), {}), prep=None)
    drive("dist_argsort_8x2e25", src_kernels(2, 2, unbias=False), n28,
          lambda: DS.argsort_sharded(pk, mesh8),
          lambda o: (not o[3].any() and rows_equal(o[0], o[2], want_k)
                     and rows_equal(o[1], o[2], order.to(torch.int32)), {}))
    del pk, pv, order, want_k, want_v
    drive("dist_sort_auto_presorted_8x2e25", local, n28,
          lambda: DS.sort_sharded_auto(want, mesh8),
          lambda o: (o[2] > 2 and rows_equal(o[0], o[1], want),
                     {"capacity_used": o[2]}))
    nr = n28 - 12345
    drive("dist_sort_ragged_6_shards", local, nr,
          lambda: DS.sort_sharded(keys[:nr], Mesh([dev] * 6)),
          keys_ok(bench.torch_sort_u32(keys[:nr])))
    del keys, want
    torch.cuda.empty_cache()

    nf = 1 << 26
    fk = torch.full((nf,), -1, dtype=torch.int32, device=dev).view(torch.uint32)
    fv = torch.arange(nf, dtype=torch.int32, device=dev)
    drive("dist_sort_pairs_all_ffffffff_8x2e23", _lex(3), nf,
          lambda: DS.sort_pairs_sharded_auto(fk, fv, mesh8),
          lambda o: (rows_equal(o[0], o[2], fk) and rows_equal(o[1], o[2], fv),
                     {"capacity_used": o[3]}), prep=None)
    del fk, fv
    torch.cuda.empty_cache()

    n26 = 1 << 26
    host = np.random.default_rng(93).integers(0, 2**32, n26, dtype=np.uint32)
    expect = bench.torch_sort_u32(torch.from_numpy(host).to(dev)).cpu().numpy()
    multihost.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             [dev.index or 0])
    try:
        mesh = multihost.global_mesh()

        def group_sort():
            shard = multihost.shard_global(host, mesh)
            out = multihost.sort_sharded_guarded(shard, mesh)
            return [multihost.allgather_result(x) for x in out]

        drive("dist_sort_nccl_one_rank_2e26", local, n26, group_sort,
              lambda o: (not o[2].any()
                         and np.array_equal(DS.collect(o[0], o[1]), expect),
                         {"backend": dist.get_backend(),
                          "world_size": dist.get_world_size()}))
    finally:
        dist.destroy_process_group()
    del host, expect
    # shards of 2^18 keys: levels of up to 4 cross distances
    with window("dryrun_multichip_8", (*src_kernels(1, 1, 4, unbias=False),
                                       "chunk_sort/lex3", "finish/lex3",
                                       *MG.KERNELS)):
        _, secs = _timed(lambda: dryrun_multichip(8, dev))
    _line("dist", window="dryrun_multichip_8", seconds=secs, ok=True, **card)
    torch.cuda.empty_cache()


def suite_path(dev, card):
    """Slice 10, the measuring surface: every config of
    ``radx_tpu_torch.bench_suite`` but the host-bound ``sort_chunked_1g``
    (``DEFAULT_SET``), each gated before it is timed (``bench_suite.run``,
    three repeats of three calls) in a window of its own that requires the
    kernels of its op (``Config.kernels``); the strategy A/B of
    radx_tpu_torch/tools/bench_strategies.py at 2^23 and 2^26; ``tuned()``
    on the card, which must give the ``TUNING`` row of an H100; and a
    ``utils.timing.trace`` whose Chrome trace ``json.load`` reads."""
    import tempfile
    import pathlib

    from radx_tpu_torch import bench_suite as BS
    from radx_tpu_torch import config, sort, tuned
    from radx_tpu_torch.tools import bench_strategies
    from radx_tpu_torch.utils import timing

    t0 = time.perf_counter()
    for name in BS.DEFAULT_SET:
        # the sorts whose planes the network makes prepare none on the
        # card; the radix sorts keep PyTorch's preparation
        first = BS.CONFIGS[name].kernels[0]
        prep = ("none" if first.startswith("chunk_sort/src") else
                "runs" if name.startswith("sort_radix") else None)
        with window(f"suite_{name}", BS.CONFIGS[name].kernels, prep=prep):
            m, row = BS.run(name, iters=3, repeats=3)
        _line("suite", metrics_row=m.row(), **row, **card)
        if name == "arbn_600m" and not row["decomposition"]:
            _fail("arbn_600m did not take the arbitrary-N path")
    _line("suite_phase", configs=len(BS.DEFAULT_SET),
          seconds=time.perf_counter() - t0)
    t1 = time.perf_counter()
    with window("bench_strategies_2e23_2e26", BS.CONFIGS["sort_radix_64m"]
                .kernels):
        rows = bench_strategies.run([23, 26], iters=3, repeats=3)
    for n in (1 << 23, 1 << 26):
        r = {row["strategy"]: row for row in rows if row["n"] == n}
        _line("strategies", n=n, radix_ms=r["radix"]["ms"],
              bitonic_ms=r["bitonic"]["ms"],
              radix_over_bitonic=r["bitonic"]["ms"] / r["radix"]["ms"],
              **card)
    kind = config.device_kind()
    got = tuned()
    if kind.startswith("NVIDIA H100") and got != config.SortConfig(
            **config.TUNING["NVIDIA H100"]):
        _fail(f"tuned() on {kind} is not the NVIDIA H100 row: {got}")
    keys = torch.randint(-(2**31), 2**31, (1 << 20,), dtype=torch.int32,
                         device=dev).view(torch.uint32)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        with timing.trace(path):
            sort(keys)
        events = json.load(open(path)).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        _fail("the trace holds no kernel event")
    _line("tools", device_kind=kind, tuned=repr(got), trace_events=len(events),
          trace_kernel_events=len(kernels),
          seconds=time.perf_counter() - t1, **card)
    torch.cuda.empty_cache()


def last_modules_path(dev, card):
    """Slice 11, the last modules: the count-only filter (ROADMAP P1), the
    scaling model of config 5 (``tools/scaling_model``), the host oracle
    and runtime (BASELINE config 1 against C++ that does not use torch) and
    ``utils.debug``."""
    import concurrent.futures
    import pathlib
    import tempfile

    from radx_tpu_torch import bench, filter_columns, sort, sort_pairs
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import compact as CP
    from radx_tpu_torch.ops import chunked
    from radx_tpu_torch.oracle import native as oracle
    from radx_tpu_torch import runtime
    from radx_tpu_torch.tools import scaling_model as SM
    from radx_tpu_torch.utils import debug, timing

    t0 = time.perf_counter()
    # -- the count-only filter: compact with no planes ----------------------
    gen = torch.Generator(device=dev).manual_seed(111)
    for log_n in (26, 30):
        n = 1 << log_n
        m32 = bench._randint(0, 2, n, gen)
        for kind, mask in (("bool", m32.bool()), ("int32", m32)):
            want = torch.count_nonzero(mask)
            with window(f"filter_count_only_{kind}_2e{log_n}", CP.KERNELS):
                outs, count = filter_columns(mask, [])
            if outs != [] or count.dtype != torch.int32 or count.dim():
                _fail("filter_columns(mask, []) must return ([], 0-d int32)")
            _, ref_count = CP.compact_ref(mask, [])
            _, one = CP.compact(mask, [m32], CP.TILE)
            e = abs(int(count) - int(ref_count)) + abs(int(count) - int(one))
            record(list(CP.KERNELS), e, e == 0 and int(count) == int(want),
                   n=n, mask=kind, planes=0, kept=int(want),
                   against="compact_ref and the one-plane count")
            del outs, count, want, ref_count, one
        del m32, mask
        torch.cuda.empty_cache()
    nc = 3 * (1 << 26) - 7
    host_mask = np.random.default_rng(112).integers(0, 2, nc, dtype=np.int32)
    with window("filter_chunked_count_only_3_slabs", CP.KERNELS):
        outs, total = chunked.filter_chunked(host_mask, [], slab=1 << 26)
    want = int(np.count_nonzero(host_mask))
    _line("slice", input=f"filter_chunked_count_only_n{nc}", slabs=3,
          count=total, equal_reference=outs == [] and total == want)
    if outs != [] or total != want:
        _fail("filter_chunked(mask, []) differs from numpy's count")
    del host_mask
    t_p1 = time.perf_counter() - t0

    # -- the scaling model: rates, audit, calibration, table, trace -------------
    t1 = time.perf_counter()
    with window("scaling_model_rates", src_kernels(1, 1), prep="none"):
        rates = SM.measure_rates(dev)
    _line("scaling_rates", sort_gkeys_per_s={str(k): v for k, v in
                                             rates["sort"].items()},
          merge_level_gkeys_per_s=rates["merge_per_level"], **card)
    # shards of 2^23 keys: levels of up to 9 cross distances
    for exchange in ("flat", "hier"):
        with window(f"scaling_model_audit_{exchange}_8x2e23",
                    src_kernels(1, 1, 9, unbias=False)):
            a = SM.audit(8, SM.DEFAULT_L, exchange, device=dev)
        _line("scaling_audit", **a, **card)
        if not a["agrees"]:
            _fail(f"the counted exchange ({exchange}) departs from the "
                  "model's")
    with window("scaling_model_calibration_8x2e23",
                src_kernels(1, 1, 9, unbias=False)):
        cal = SM.calibrate(rates, SM.DEFAULT_L, device=dev)
    _line("scaling_calibration", **cal, **card)
    for name, (bw, t_wave) in SM.LINKS.items():
        _line("scaling_link", link=name, gbytes_per_s=bw,
              per_wave_s=t_wave, source=SM.LINK_SOURCES[name])
    for row in SM.table(SM.model(rates), SM.DEFAULT_L):
        _line("scaling_model", row=row, **card)
    with tempfile.TemporaryDirectory() as tmp:
        with window("scaling_model_trace_8x2e15",
                    ("chunk_sort/src", "cross_stage<1>", "finish")):
            path = SM.trace(pathlib.Path(tmp) / "dist_sort_8shard.json",
                            device=dev)
        events = json.load(open(path)).get("traceEvents", [])
    network = [e for e in events if e.get("cat") == "kernel"
               and ("cross_stage" in e.get("name", "")
                    or "finish" in e.get("name", ""))]
    _line("scaling_trace", trace_events=len(events),
          cross_stage_or_finish_events=len(network))
    if not network:
        _fail("the 8-shard trace holds no cross_stage or finish launch")
    t_model = time.perf_counter() - t1

    # -- BASELINE config 1 against the host C++ oracle ------------------------
    t2 = time.perf_counter()
    n26 = 1 << 26
    gens = {"permutation": lambda: runtime.gen_permutation(n26, seed=1),
            "uniform": lambda: runtime.gen_uniform(n26, seed=2),
            "skewed": lambda: runtime.gen_skewed(n26, seed=3)}
    # the host sorts run in threads (ctypes drops the GIL) beside the card's
    with concurrent.futures.ThreadPoolExecutor(len(gens)) as pool:
        keys = dict(zip(gens, pool.map(lambda g: g(), gens.values())))
        want = {k: pool.submit(oracle.sort_u32, v) for k, v in keys.items()}
        with window("oracle_config1_2e26", src_kernels(1, 1), prep="none"):
            got = {k: sort(torch.from_numpy(v).to(dev)).cpu().numpy()
                   for k, v in keys.items()}
        for name in gens:
            equal = np.array_equal(got[name], want[name].result())
            valid = runtime.validate_sort(keys[name], got[name])
            _line("oracle", input=f"{name}_2e26", n=n26,
                  equal_cpp_oracle=equal, validate_sort=valid)
            if not equal or valid != 0:
                _fail(f"sort of {name} keys differs from the C++ oracle")
    del keys, want, got
    n22 = 1 << 22
    pk = runtime.gen_uniform(n22, seed=2)
    pv = np.arange(n22, dtype=np.uint32)
    with window("oracle_pairs_2e22", (*src_kernels(2, 2), "gather_planes"),
                prep="none"):
        gk, gv = sort_pairs(torch.from_numpy(pk).to(dev),
                            torch.from_numpy(pv).to(dev))
        gk, gv = gk.cpu().numpy(), gv.cpu().numpy()
    wk, wv = oracle.sort_pairs(pk, pv)
    ok = np.array_equal(gk, wk) and np.array_equal(gv, wv)
    _line("oracle", input="pairs_uniform_2e22", n=n22, equal_cpp_oracle=ok,
          validate_sort=runtime.validate_sort(pk, gk))
    if not ok:
        _fail("stable sort_pairs differs from the C++ oracle")
    t_oracle = time.perf_counter() - t2

    # -- utils.debug -----------------------------------------------------------
    t3 = time.perf_counter()
    k20 = np.random.default_rng(113).integers(0, 2**32, 1 << 20,
                                              dtype=np.uint32)
    ok, diff = debug.interpret_parity(lambda interpret: sort, k20, device=dev)
    _line("debug", what="interpret_parity(sort), card against CPU", n=k20.size,
          ok=ok, max_abs_diff=diff)
    if not ok or diff != 0:
        _fail("interpret_parity(sort) found a difference")
    k26 = bench._randint(-(2**31), 2**31, n26, gen).view(torch.uint32)
    with window("checked_sort_2e26", src_kernels(1, 1), prep="none"):
        got = debug.checked(sort)(k26)
    same = torch.equal(_i32(got), _i32(sort(k26)))
    _line("debug", what="checked(sort) against sort", n=n26, equal=same)
    if not same:
        _fail("checked(sort) differs from sort")
    del k26, got
    torch.cuda.empty_cache()
    _line("last_modules_phase", p1_seconds=t_p1, model_seconds=t_model,
          oracle_seconds=t_oracle, debug_seconds=time.perf_counter() - t3,
          seconds=time.perf_counter() - t0)


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        raise SystemExit(2)

    from radx_tpu_torch import (SortConfig, filter_columns, groupby, sort,
                                sort_any, unique)
    from radx_tpu_torch import bench
    from radx_tpu_torch.kernels import _build
    from radx_tpu_torch.kernels import aggregate as AG
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import compact as CP
    from radx_tpu_torch.kernels import gather as GT
    from radx_tpu_torch.kernels import merge as MG
    from radx_tpu_torch.kernels import msd as M
    from radx_tpu_torch.kernels import radix as RX
    from radx_tpu_torch.kernels import radix_sort as RS
    from radx_tpu_torch.kernels import segscan as SG
    from radx_tpu_torch.ops import sort as S
    from radx_tpu_torch.tools.finish_bench import int_ops_per_s
    from radx_tpu_torch.utils import timing

    global OPS_PER_S
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = timing.nvidia_smi()
    OPS_PER_S = int_ops_per_s()
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    cfg = SortConfig()
    C, T = cfg.chunk_elems, cfg.finish_elems
    log_t = T.bit_length() - 1
    RC, RT = cfg.rider_chunk_elems, cfg.rider_finish_elems
    r_log_t = RT.bit_length() - 1
    # the kernel instances the paths below drive (the radix ones in the
    # keys, rider, lex2 and lex3 modes)
    all_kernels = (*B.KEY_KERNELS, *B.RIDER_KERNELS, *B.LEX_KERNELS,
                   *B.SOURCE_KERNELS, *CP.KERNELS, *SG.KERNELS, *AG.KERNELS, *RX.KERNELS,
                   *GT.KERNELS, *MG.KERNELS, "radix_rank", *M.UNBIAS_KERNELS,
                   *(k for m in MODES.values() for k in
                     (*B.radix_kernels(*m), *M.mode_kernels(*m))))
    i32 = torch.int32

    # -- 1. the card ---------------------------------------------------------
    _line("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvidia_smi=smi, config=repr(cfg),
          int_ops_per_s=OPS_PER_S)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    ptxas = ptxas_report(_build.library_path()[1])
    spills = {k: v for k, v in ptxas.items()
              if re.search(r"[1-9]\d* bytes spill", v)}
    _line("build", seconds=time.perf_counter() - t0, library=so.name,
          kernels_compiled=len(ptxas), ptxas=ptxas, spills=spills,
          dynamic_smem_bytes={"chunk_sort/finish": 4 * max(C, T),
                              "rider": 8 * max(RC, RT),
                              **{f"lex{p}": 4 * p * max(cfg.lex_tiles(p))
                                 for p in B.LEX_PLANES}})
    if spills:
        _fail(f"ptxas reports spills: {spills}")

    # -- 3. kernel vs plain version on the card ------------------------------
    n = 1 << 23
    rng = np.random.default_rng(1)
    base = torch.from_numpy(
        rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    ).to(dev)
    ties = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32)).to(dev)
    iota = torch.arange(n, dtype=i32, device=dev)

    def check(name, kernel, ref, **case):
        x = base.clone()
        kernel(x)
        want = ref(base)
        torch.cuda.synchronize()
        e = int((x.long() - want.long()).abs().max())
        record([name], e, e == 0, n=n, **case)

    def check_rider(name, kernel, ref, **case):
        x, r = ties.clone(), iota.clone()
        kernel(x, r)
        wk, wr = ref(ties, iota)
        torch.cuda.synchronize()
        e = max(int((x.long() - wk.long()).abs().max()),
                int((r.long() - wr.long()).abs().max()))
        whole = torch.equal(torch.sort(r).values, iota)  # no rider lost
        record([name + "/rider"], e, e == 0 and whole, n=n, keys="[0,16)",
               **case)

    for inv in (False, True):
        check("chunk_sort", lambda x: B.chunk_sort(x, C, invert=inv),
              lambda x: B.chunk_sort_ref(x, C, invert=inv), invert=inv)
        check_rider("chunk_sort",
                    lambda x, r: B.chunk_sort(x, RC, invert=inv, rider=r),
                    lambda x, r: B.chunk_sort_ref(x, RC, invert=inv, rider=r),
                    invert=inv)
    check("chunk_sort", lambda x: B.chunk_sort(x, C, ascending=True),
          lambda x: B.chunk_sort_ref(x, C, ascending=True), ascending=True)
    check_rider("chunk_sort",
                lambda x, r: B.chunk_sort(x, RC, ascending=True, rider=r),
                lambda x, r: B.chunk_sort_ref(x, RC, ascending=True, rider=r),
                ascending=True)
    # every cross pass of the cap, ascending and descending, the lowest
    # distance at the finish tile (below it where f distances from the tile
    # would pass 2^23 rows)
    for f, inv in ((f, inv) for f in B.CROSS_FUSION for inv in (False, True)):
        j = min(log_t, 23 - f)
        check(f"cross_stage<{f}>",
              lambda x: B.cross_stage(x, j, f, j + f, inv),
              lambda x: B.cross_stage_ref(x, j, f, j + f, inv),
              j_low=j, kk=j + f, invert=inv)
        if f > B.cross_fusion(2):
            continue
        rj = min(r_log_t, 23 - f)
        check_rider(f"cross_stage<{f}>",
                    lambda x, r: B.cross_stage(x, rj, f, rj + f, inv, r),
                    lambda x, r: B.cross_stage_ref(x, rj, f, rj + f, inv, r),
                    j_low=rj, kk=rj + f, invert=inv)
    # finish: the run-time plan, and the compile-time plan where it applies
    for kk, inv in ((log_t + 1, False), (23, True), (5, False)):
        for top in plans("finish", 1, T.bit_length() - 1, kk):
            check("finish", lambda x: forced("finish", top)(x, T, kk,
                                                           invert=inv),
                  lambda x: B.finish_ref(x, T, kk, inv), tile=T, kk=kk,
                  invert=inv, compile_time_plan=top)
        for top in plans("finish", 2, RT.bit_length() - 1, kk):
            check_rider("finish",
                        lambda x, r: forced("finish", top)(
                            x, RT, kk, invert=inv, rider=r),
                        lambda x, r: B.finish_ref(x, RT, kk, inv, r),
                        tile=RT, kk=kk, invert=inv, compile_time_plan=top)
    # the radix sort's span passes: directions from the index within 2^19
    # (the lowest distance cut below the tile where f distances from the
    # tile would pass the span's top level)
    span = 1 << 19
    for f in B.CROSS_FUSION:
        j = min(log_t, 19 - f)
        check(f"cross_stage<{f}>",
              lambda x: B.cross_stage(x, j, f, 19, span=span),
              lambda x: B.cross_stage_ref(x, j, f, 19, span=span),
              j_low=j, kk=19, span=span)
    for f in range(1, B.cross_fusion(2) + 1):
        j = min(r_log_t, 19 - f)
        check_rider(f"cross_stage<{f}>",
                    lambda x, r: B.cross_stage(x, j, f, 19, True, r,
                                               span=span),
                    lambda x, r: B.cross_stage_ref(x, j, f, 19, True, r,
                                                   span=span),
                    j_low=j, kk=19, invert=True, span=span)
    for top in plans("finish", 1, T.bit_length() - 1, 19):
        check("finish", lambda x: forced("finish", top)(x, T, 19,
                                                       span=span),
              lambda x: B.finish_ref(x, T, 19, span=span), tile=T, kk=19,
              span=span, compile_time_plan=top)

    # the lexicographic mode: plane 0 in [0, 16), plane 1 a permutation (the
    # stable sorts' index plane), the rest random riders
    tie_plane = torch.randperm(n, device=dev).to(i32)
    riders = [base.clone()] + [
        torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                         .astype(np.int32)).to(dev) for _ in range(5)]

    def check_lex(p, name, kernel, ref, **case):
        planes = [ties, tie_plane, *riders[: p - 2]]
        got = [x.clone() for x in planes]
        kernel(got[0], got[1:])
        want = ref(planes[0], planes[1:])
        torch.cuda.synchronize()
        e = max(int((a.long() - b.long()).abs().max())
                for a, b in zip(got, want))
        kept = torch.equal(torch.sort(got[1]).values,
                           torch.sort(tie_plane).values)
        record([f"{name}/lex{p}"], e, e == 0 and kept, n=n, planes=p,
               keys="[0,16)", **case)

    for p in B.LEX_PLANES:
        lc, lf = cfg.lex_tiles(p)
        ll = lf.bit_length() - 1
        check_lex(p, "chunk_sort", lambda x, lx: B.chunk_sort(x, lc, lex=lx),
                  lambda x, lx: B.chunk_sort_ref(x, lc, lex=lx), tile=lc)
        check_lex(p, "chunk_sort",
                  lambda x, lx: B.chunk_sort(x, lc, ascending=True, lex=lx),
                  lambda x, lx: B.chunk_sort_ref(x, lc, ascending=True,
                                                 lex=lx),
                  tile=lc, ascending=True)
        for f in range(1, B.cross_fusion(p) + 1):
            kk, inv = ll + f + 1, f % 2 == 0
            check_lex(p, f"cross_stage<{f}>",
                      lambda x, lx: B.cross_stage(x, ll, f, kk, inv, lex=lx),
                      lambda x, lx: B.cross_stage_ref(x, ll, f, kk, inv,
                                                      lex=lx),
                      j_low=ll, kk=kk, invert=inv)
            if p == 2:  # descending too, and under a radix span
                check_lex(p, f"cross_stage<{f}>",
                          lambda x, lx: B.cross_stage(x, ll, f, kk, not inv,
                                                      lex=lx),
                          lambda x, lx: B.cross_stage_ref(x, ll, f, kk,
                                                          not inv, lex=lx),
                          j_low=ll, kk=kk, invert=not inv)
                j = min(ll, 19 - f)
                check_lex(p, f"cross_stage<{f}>",
                          lambda x, lx: B.cross_stage(x, j, f, 19, lex=lx,
                                                      span=span),
                          lambda x, lx: B.cross_stage_ref(x, j, f, 19,
                                                          lex=lx, span=span),
                          j_low=j, kk=19, span=span)
        for kk, inv in ((ll + 1, True), (23, False), (ll - 2, False)):
            for top in plans("finish", p, lf.bit_length() - 1, kk):
                check_lex(p, "finish",
                          lambda x, lx: forced("finish", top)(
                              x, lf, kk, invert=inv, lex=lx),
                          lambda x, lx: B.finish_ref(x, lf, kk, inv, lex=lx),
                          tile=lf, kk=kk, invert=inv, compile_time_plan=top)
    del tie_plane, riders
    # finish at 2^28 keys and 2^28 (key, index) pairs (the sort cells'
    # sizes), the top level and one below, both plans
    for p, tile in ((1, T), (2, cfg.lex_tiles(2)[1])):
        big = [torch.randint(0, 1 << 20, (1 << 28,), dtype=i32,
                             device=dev)]
        if p == 2:
            big.append(torch.randperm(1 << 28, device=dev).to(i32))
        for kk, inv in ((28, False), (20, True)):
            want = B.finish_ref(big[0], tile, kk, inv, lex=big[1:] or None)
            want = want if isinstance(want, tuple) else (want,)
            for top in plans("finish", p, tile.bit_length() - 1, kk):
                got = [q.clone() for q in big]
                forced("finish", top)(got[0], tile, kk, invert=inv,
                                      lex=got[1:] or None)
                torch.cuda.synchronize()
                e = _max_err(got, want)
                record(["finish" + ("/lex2" if p == 2 else "")], e, e == 0,
                       n=1 << 28,
                       tile=tile, kk=kk, invert=inv, compile_time_plan=top)
                del got
            del want
        del big
        torch.cuda.empty_cache()
    tile_engine_checks(dev, cfg)
    edge_checks(dev)

    del base, ties, iota
    single_pass_checks(dev, cfg, rng)
    gather_checks(dev)
    merge_checks(dev)

    # the dense aggregates at 2^26 rows, a ragged n_valid
    n26 = 1 << 26
    gen = torch.Generator(device=dev).manual_seed(21)
    zipf = torch.from_numpy(np.minimum(
        np.random.default_rng(22).zipf(1.3, n26), 1 << 17).astype(np.int32)
        - 1).to(dev)
    avals = torch.randint(-(2**31), 2**31, (n26,), dtype=i32, generator=gen,
                          device=dev)
    n_valid = torch.full((), n26 - 12345, dtype=i32, device=dev)
    for bins in (128, 256, 8192, 65536):
        oob = torch.randint(0, 2 * bins, (n26,), dtype=i32, generator=gen,
                            device=dev)
        high = torch.rand(n26, generator=gen, device=dev) < 0.05
        dists = {
            "uniform": torch.randint(0, bins, (n26,), dtype=i32,
                                     generator=gen, device=dev),
            "one_key": torch.full((n26,), 3, dtype=i32, device=dev),
            "zipf": zipf.clamp(max=bins - 1),
            "out_of_range": torch.where(high, oob | SIGN, oob),
        }
        for dist, k in dists.items():
            ku = k.view(torch.uint32)
            got = AG.dense_sums(ku, avals, bins, n_valid)
            want = AG.dense_sums_ref(ku, avals, bins, n_valid)
            torch.cuda.synchronize()
            e = max(int((_i32(a).long() - _i32(b).long()).abs().max())
                    for a, b in zip(got, want))
            record(["dense_sums"], e, e == 0, n=n26, n_valid=n26 - 12345,
                   bins=bins, keys=dist)
            if bins > AG.MAX_EXTREMA_BINS:
                continue
            for is_min in (True, False):
                got = AG.dense_extrema(ku, avals, bins, is_min, n_valid)
                want = AG.dense_extrema_ref(ku, avals, bins, is_min, n_valid)
                torch.cuda.synchronize()
                e = max(int((a.long() - b.long()).abs().max())
                        for a, b in zip(got, want))
                record(["dense_extrema"], e, e == 0, n=n26,
                       n_valid=n26 - 12345, bins=bins, keys=dist,
                       op="min" if is_min else "max")
        del oob, high, dists
    del zipf, avals, got, want
    torch.cuda.empty_cache()
    radix_checks(dev)
    _line("elapsed", seconds=time.perf_counter() - t_start)

    # -- 4a. slice 1: sort / sort_any -----------------------------------------
    rng = np.random.default_rng(2)
    perm = bench.permutation_keys(1 << 23)
    f32 = rng.standard_normal(1_000_000).astype(np.float32)
    f32[rng.integers(0, f32.size, 5000)] = np.nan
    f32[rng.integers(0, f32.size, 5000)] = np.inf
    f32[rng.integers(0, f32.size, 5000)] = -np.inf
    f32[rng.integers(0, f32.size, 5000)] = 0.0
    f32[rng.integers(0, f32.size, 5000)] = -0.0
    i32a = rng.integers(-(2**31), 2**31, 1_000_000, dtype=np.int64).astype(np.int32)
    i32a[:1000] = np.iinfo(np.int32).min
    i32a[1000:2000] = np.iinfo(np.int32).max
    u32_inputs = {
        "permutation_2e23": perm,
        "uniform_2e26": rng.integers(0, 2**32, 1 << 26, dtype=np.uint32),
        "uniform_60e6": rng.integers(0, 2**32, 60_000_000, dtype=np.uint32),
        "dup16_2e24": rng.integers(0, 16, 1 << 24, dtype=np.uint32),
        "all_ffffffff_3e6": np.full(3_000_000, 0xFFFFFFFF, np.uint32),
        **{f"uniform_{m}": rng.integers(0, 2**32, m, dtype=np.uint32)
           for m in (1, 2, 1000, 4097)},
    }
    if not S._use_decomposition(60_000_000, cfg):
        _fail("n = 60,000,000 does not take the decomposition path")
    dev_inputs = {k: torch.from_numpy(v).to(dev) for k, v in u32_inputs.items()}
    any_inputs = {
        f"{name}_{'desc' if desc else 'asc'}": (torch.from_numpy(a).to(dev), desc)
        for name, a in (("int32_1e6", i32a), ("float32_1e6", f32))
        for desc in (False, True)
    }
    torch.cuda.synchronize()

    with window("sort", src_kernels(1, 1), top_src(1, 1, 9), prep="none"):
        outs = {k: sort(v) for k, v in dev_inputs.items()}
        any_outs = {k: sort_any(x, descending=d)
                    for k, (x, d) in any_inputs.items()}

    for k, x in dev_inputs.items():
        got, want = outs[k], bench.torch_sort_u32(x)
        ok = got.dtype == torch.uint32 and got.device == x.device and torch.equal(
            _i32(got), _i32(want))
        if k == "permutation_2e23":
            ok = ok and np.array_equal(got.cpu().numpy(), np.sort(u32_inputs[k]))
        _line("slice", input=k, n=x.numel(), equal_torch_sort=bool(ok))
        if not ok:
            _fail(f"sort({k}) differs from torch.sort")
    for k, (x, desc) in any_inputs.items():
        got = any_outs[k]
        want = torch.sort(x, descending=desc, stable=True).values
        if x.dtype == torch.float32:
            # torch.sort ties -0.0 and +0.0; sort_any orders -0.0 < +0.0
            zeros = (want == 0).nonzero().flatten()
            n_neg = int(torch.signbit(x[x == 0]).sum())
            signed = torch.full_like(zeros, 0, dtype=torch.float32)
            if desc:
                signed[zeros.numel() - n_neg:] = -0.0
            else:
                signed[:n_neg] = -0.0
            want[zeros] = signed
        ok = got.dtype == x.dtype and torch.equal(_i32(got), _i32(want))
        _line("slice", input=f"sort_any_{k}", n=x.numel(),
              equal_torch_sort=bool(ok))
        if not ok:
            _fail(f"sort_any({k}) differs from torch.sort")
    del dev_inputs, any_inputs, outs, any_outs
    torch.cuda.empty_cache()

    # -- 4b. slice 2: the sort-based config-3 query and the other group-bys --
    def check_groups(name, res, keys, vals, field):
        g = bench._check_groups(*res, keys, vals, field)
        _line("slice", input=name, n=keys.numel(), groups=g, agg=field,
              equal_reference=True)

    n28 = 1 << 28
    key, value, pred = bench.query_data(n28)
    n_bucket = 1 << 26
    digits = torch.from_numpy(
        (np.random.default_rng(4).integers(0, 2**32, n_bucket, dtype=np.uint32)
         >> 24).astype(np.uint32)).to(dev)
    bvals = torch.from_numpy(np.random.default_rng(5).integers(
        0, 2**32, n_bucket, dtype=np.uint32)).to(dev)
    rng = np.random.default_rng(6)
    n_ff = 3_000_017  # pads to 2^22: the phantom all-pad group exists
    ff_keys = rng.integers(0, 1000, n_ff, dtype=np.uint32)
    ff_with = ff_keys.copy()
    ff_with[::101] = 0xFFFFFFFF
    ff_vals = torch.from_numpy(rng.integers(0, 2**32, n_ff, dtype=np.uint32)
                               ).to(dev)
    ff = {"key_ffffffff_absent": torch.from_numpy(ff_keys).to(dev),
          "key_ffffffff_present": torch.from_numpy(ff_with).to(dev)}
    n_typed = 5_000_000
    ik = torch.from_numpy(rng.integers(-3000, 3000, n_typed).astype(np.int32)
                          ).to(dev)
    iv = torch.from_numpy(rng.integers(-(2**31), 2**31, n_typed,
                                       dtype=np.int64).astype(np.int32)).to(dev)
    fk = torch.from_numpy((rng.integers(-400, 400, n_typed) / 8).astype(
        np.float32)).to(dev)
    fv = torch.from_numpy((rng.standard_normal(n_typed) * 100).astype(
        np.float32)).to(dev)
    ukeys = torch.from_numpy(rng.integers(0, 1_000_003, n_bucket,
                                          dtype=np.uint32)).to(dev)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    with window("filter_groupby_unique",
                (*B.KEY_KERNELS, *src_kernels(1, 2), *CP.KERNELS,
                 *SG.KERNELS), top_src(1, 2, 9)):
        mask = _i32(pred) >= 0  # pred < 2^31
        (qk, qv), qcount = filter_columns(mask, [key, value])
        qc = int(qcount)
        qk, qv = qk[:qc], qv[:qc]
        q_res = {agg: groupby(qk, qv, agg) for agg in AGGS}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        bucket = groupby(digits, bvals, "sum")
        ff_res = {k: {agg: groupby(x, ff_vals, agg) for agg in ("min", "count")}
                  for k, x in ff.items()}
        typed = {"int32_keys_int32_vals": {agg: groupby(ik, iv, agg)
                                           for agg in ("sum", "min", "max")},
                 "float32_keys_float32_vals": {agg: groupby(fk, fv, agg)
                                               for agg in ("sum", "min", "max")}}
        uq = unique(ukeys, return_counts=True)

    want_q = _i32(key)[mask]
    if qc != want_q.numel() or not (
            torch.equal(_i32(qk), want_q)
            and torch.equal(_i32(qv), _i32(value)[mask])):
        _fail("filter_columns differs from boolean indexing at 2^28")
    _line("slice", input="query_filter_2e28", n=n28, kept=qc,
          equal_reference=True)
    fields = {"sum": "sums", "count": "counts", "min": "mins", "max": "maxs"}
    for agg, res in q_res.items():
        check_groups("query_groupby_2e28", res, qk, qv, fields[agg])
    _line("memory", what="config-3 query at 2^28 (filter + 4 group-bys)",
          max_memory_allocated_bytes=peak, **card)
    check_groups("digit_bucket_256_2e26", bucket, digits, bvals, "sums")
    if int(bucket[2]) != 256:
        _fail("the digit bucket does not have 256 groups")
    for k, res in ff_res.items():
        for agg, r in res.items():
            check_groups(k, r, ff[k], ff_vals, fields[agg])
    # int32 keys / values: the uint32 reference on sign-flipped keys
    flip = torch.tensor(SIGN, dtype=i32, device=dev)
    for agg, (uk, out, ng) in typed["int32_keys_int32_vals"].items():
        if agg == "sum":
            g = bench._check_groups((uk ^ flip).view(torch.uint32), out, ng,
                                    (ik ^ flip).view(torch.uint32), iv, "sums")
        else:
            ref = torch.sort(ik, stable=True)
            uk_w, cnt = torch.unique_consecutive(ref.values, return_counts=True)
            group = torch.repeat_interleave(
                torch.arange(uk_w.numel(), device=dev), cnt)
            init = torch.full(uk_w.shape, 2**31 - 1 if agg == "min" else SIGN,
                              dtype=i32, device=dev)
            want = init.scatter_reduce(0, group, iv[ref.indices],
                                       "amin" if agg == "min" else "amax")
            g = uk_w.numel()
            if int(ng) != g or not (torch.equal(uk[:g], uk_w)
                                    and torch.equal(out[:g], want)):
                _fail(f"int32 groupby {agg} differs from the reference")
        _line("slice", input="int32_keys_int32_vals", n=n_typed, agg=agg,
              groups=g, equal_reference=True)
    # float32 keys (no -0.0, no NaN here) / values: float64 reference
    enc_f = torch.where(_i32(fk) < 0, ~_i32(fk), _i32(fk) ^ flip)
    uk_w, _, sums, abss, mins, maxs = _float_group_ref(enc_f ^ flip, fv)
    g = uk_w.numel()
    for agg, (uk, out, ng) in typed["float32_keys_float32_vals"].items():
        got_enc = torch.where(_i32(uk[:g]) < 0, ~_i32(uk[:g]),
                              _i32(uk[:g]) ^ flip) ^ flip
        ok = int(ng) == g and torch.equal(got_enc, uk_w)
        if agg == "sum":
            e = float((out[:g].double() - sums).abs().max())
            ok = ok and bool(((out[:g].double() - sums).abs()
                              <= 1e-5 * abss).all())
        else:
            want = mins if agg == "min" else maxs
            e = float((out[:g].double() - want).abs().max())
            ok = ok and e == 0
        _line("slice", input="float32_keys_float32_vals", n=n_typed, agg=agg,
              groups=g, max_abs_err=e, equal_reference=ok)
        if not ok:
            _fail(f"float32 groupby {agg} differs from the reference")
    vals_u, cnts_u, cu = uq
    ref = torch.sort(_i32(ukeys) ^ flip)
    uk_w, cnt_w = torch.unique_consecutive(ref.values, return_counts=True)
    g = uk_w.numel()
    if int(cu) != g or not (torch.equal(_i32(vals_u[:g]) ^ flip, uk_w)
                            and torch.equal(cnts_u[:g].long(), cnt_w)):
        _fail("unique with counts differs from torch.unique_consecutive")
    _line("slice", input="unique_counts_2e26", n=n_bucket, groups=g,
          equal_reference=True)
    del key, value, pred, mask, qk, qv, q_res, digits, bvals, bucket, ff, ff_res
    del ik, iv, fk, fv, typed, ukeys, uq
    torch.cuda.empty_cache()
    rider_arbn_path(dev)
    _line("elapsed", seconds=time.perf_counter() - t_start)

    # -- 4c. slice 3: the Table query path, one window per path ---------------
    dense_path(dev, card)
    join_path(dev)
    sort_path(dev)
    example_path(dev)
    torch.cuda.empty_cache()
    _line("elapsed", seconds=time.perf_counter() - t_start)

    # -- 4d. slice 4: strategy="radix" ----------------------------------------
    radix_path(dev)
    _line("elapsed", seconds=time.perf_counter() - t_start)

    # -- 4e. slice 9: the streaming operators and the distributed sort --------
    chunked_path(dev, card)
    dist_path(dev, card)
    _line("elapsed", seconds=time.perf_counter() - t_start)

    # -- 4f. slice 10: the benchmark suite and its tools -------------------------
    suite_path(dev, card)
    _line("elapsed", seconds=time.perf_counter() - t_start)

    # -- 4g. slice 11: count-only filter, scaling model, oracle, debug -----------
    last_modules_path(dev, card)
    _line("elapsed", seconds=time.perf_counter() - t_start)

    # -- 5. timings ------------------------------------------------------------
    rows = {}

    def in_turns(kernel, planes, ncmp, args, ops, lib=None, top=True,
                 **extra):
        """A tile-engine kernel (chunk_sort, a strided cross pass, finish;
        chunk_sort_cyclic / slot_merge, ``args`` their wrapper's after the
        planes and ncmp, the output planes first) on the run-time plan (the
        kernel before its compile-time plan) and on the compile-time plan,
        in turns (old, new, new, old), each beside the bound and the library
        call; with ``top`` false (a mode whose compile-time plan lost and
        has no kernel) the run-time plan twice."""
        n = planes[0].numel()
        bound_ms, bound_by = bound(8 * len(planes) * n, ops)
        k, rd, lx = B._keywords(planes, ncmp)
        io = kernel in ("chunk_sort_cyclic", "slot_merge")
        ms = {}
        for top in (False, True, True, False) if top else (False, False):
            run = forced(kernel, top)
            t = timing.time_cuda(
                (lambda: run(planes, args[0], ncmp, *args[1:])) if io else
                (lambda: run(k, *args, rider=rd, lex=lx)),
                iters=10, repeats=5)
            ms.setdefault("compile_time_plan" if top else "runtime_plan",
                          []).append(t.seconds * 1e3)
        lib_ms = (None if lib is None else
                  timing.time_cuda(lib, iters=10, repeats=5).seconds * 1e3)
        name = (f"cross_stage<{args[1]}>" if kernel == "cross_stage"
                else kernel)
        size = (f"n=2^{n.bit_length() - 1}" if n & (n - 1) == 0
                else f"rows={n}")
        _line("context", what=f"{name}{_suffix(ncmp, len(planes))} in "
              f"turns, {size}", **ms, bound_ms=bound_ms, bound_by=bound_by,
              library_ms=lib_ms, **extra, **card)

    def chunk_ops(n, chunk, planes):
        lc = chunk.bit_length() - 1
        return _cx_ops(n, lc * (lc + 1) // 2, planes)

    def time_pair(name, log_n, kern, ref, bytes_, ops=0, lib=None, iters=10,
                  n=None, **extra):
        """Kernel and plain version, the bound of the kernel's work and,
        where one PyTorch call computes the same function, that call, on
        2^log_n rows (``n`` where they are no power of two); ``extra``:
        fields printed beside the time (a tile pass's shared-memory round
        trips)."""
        tk = timing.time_cuda(kern, iters=iters, repeats=5)
        tp = timing.time_cuda(ref, iters=1, repeats=2, warmup=0)
        tl = None if lib is None else timing.time_cuda(lib, iters=iters,
                                                       repeats=5)
        bound_ms, bound_by = bound(bytes_, ops)
        row = {"ms": tk.seconds * 1e3, "plain_ms": tp.seconds * 1e3,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None if tl is None else tl.seconds * 1e3}
        size = 1 << log_n if n is None else n
        rows.setdefault(name, {})[log_n] = {**row, "n": size}
        _line("kernel_time", name=name, n=size, **row, **extra,
              spread_pct=tk.spread_pct, plain_spread_pct=tp.spread_pct,
              **card)

    def ptxas_of(name):
        """ptxas's report of a launch name's instances (run-time plan, and
        compile-time plan: "/top")."""
        return {k: v for k, v in ptxas.items() if k in (name, f"{name}/top")}

    def radix_edge_timings(planes, out, ncmp, geo, log_r):
        """K4's source form in turns with the in-place K4 (its output
        equal to the in-place kernel's on the planes its sources make:
        ``_sources_of``), and K13's unbiasing form in turns with K13 on
        the merged buckets of the same planes (in place, in place, new,
        new: old, new, new, old); at 2^28 each also beside its plain
        version and bound (``time_pair``)."""
        np_ = len(planes)
        if (ncmp, np_) not in B.SOURCE_MODES:
            return
        n = planes[0].numel()
        c = rcfg.mode_tiles(np_, ncmp)[0]
        lc = c.bit_length() - 1
        cyc = B.radix_kernels(ncmp, np_)[0]
        k4s = B.radix_source_kernel(ncmp, np_)
        sources = _sources_of(planes, ncmp)
        src_out = [torch.empty_like(q) for q in planes]
        if log_r == 28:
            time_pair(k4s, log_r,
                      lambda: B.chunk_sort_cyclic_sources(src_out, ncmp,
                                                          geo.C, c, sources),
                      lambda: B.chunk_sort_cyclic_ref(
                          B.source_planes_ref(sources, 0, n, dev), ncmp,
                          geo.C, c),
                      sum(4 * n for s in sources if s.cols) + 4 * np_ * n,
                      chunk_ops(n, c, np_) + n,
                      round_trips=B.round_trips(lc, 1, lc, np_),
                      ptxas=ptxas_of(k4s))
        ms = {}
        for which in ("in_place", "sources", "sources", "in_place"):
            run = ((lambda: B.chunk_sort_cyclic(planes, out, ncmp, geo.C, c))
                   if which == "in_place" else
                   (lambda: B.chunk_sort_cyclic_sources(src_out, ncmp, geo.C,
                                                        c, sources)))
            ms.setdefault(which, []).append(
                timing.time_cuda(run, iters=10, repeats=5).seconds * 1e3)
        e = _max_err(src_out, out)
        record([k4s], e, e == 0, n=n, against=cyc, shape="cell")
        _line("context", what=f"{k4s} in turns with the in-place {cyc}, "
              f"n=2^{log_r}", **ms, ptxas=ptxas_of(k4s), **card)
        del src_out
        torch.cuda.empty_cache()
        concat = M.mode_kernels(ncmp, np_)[1]
        k13 = M.unbias_kernel(ncmp, np_)
        sorted_, b, merged = _radix_stages(planes, ncmp, geo, rcfg)
        src = sorted_ if ncmp == 1 and np_ == 2 else None
        cout = [torch.empty_like(q) for q in planes]
        keys = torch.empty_like(planes[0])
        if log_r == 28:
            time_pair(k13, log_r,
                      lambda: M.concat(merged, src, cout, b.start, b.src,
                                       geo.nb_pad, ncmp, (cout[0], 0)),
                      lambda: M.concat_ref(merged, src, b.start, b.src,
                                           geo.nb_pad, n, ncmp)[0] ^ SIGN,
                      8 * np_ * n + 16 * b.src.numel(), n,
                      ptxas=ptxas_of(k13))
        ms = {}
        for which in ("plain_form", "unbias", "unbias", "plain_form"):
            key_out = None if which == "plain_form" else (keys, 0)
            run = (lambda: M.concat(merged, src, cout, b.start, b.src,
                                    geo.nb_pad, ncmp, key_out))
            ms.setdefault(which, []).append(
                timing.time_cuda(run, iters=10, repeats=5).seconds * 1e3)
        e = _max_err([keys], [cout[0] ^ SIGN])
        record([k13], e, e == 0, n=n, against=concat, shape="cell")
        _line("context", what=f"{k13} in turns with {concat}, n=2^{log_r}",
              **ms, ptxas=ptxas_of(k13), **card)
        del sorted_, b, merged, src, cout, keys
        torch.cuda.empty_cache()

    def tile_sort(x, tile):
        """The library call of a tile sort: torch.sort of the (n / tile,
        tile) view, every tile ascending."""
        return lambda: torch.sort(x.view(-1, tile), dim=1)

    for log_n in (23, 26):
        m = bench.measure(1 << log_n)
        _line("metric", **{m["metric"]: m["value"]}, ms=m["ms"],
              spread_pct=m["spread_pct"], **card)
        keys = torch.from_numpy(
            bench.permutation_keys(1 << 23) if log_n == 23 else
            rng.integers(0, 2**32, 1 << 26, dtype=np.uint32)).to(dev)
        ts = timing.time_cuda(lambda: bench.torch_sort_u32(keys), iters=10,
                              repeats=5)
        _line("context", what=f"torch.sort n=2^{log_n} (sign-biased int32)",
              ms=ts.seconds * 1e3, keys_per_s=keys.numel() / ts.seconds, **card)
        x = torch.from_numpy(
            rng.integers(-(2**31), 2**31, 1 << log_n, dtype=np.int64).astype(np.int32)
        ).to(dev)
        nx = x.numel()
        log_c = C.bit_length() - 1
        time_pair("chunk_sort", log_n, lambda: B.chunk_sort(x, C),
                  lambda: B.chunk_sort_ref(x, C), 8 * nx,
                  _cx_ops(nx, log_c * (log_c + 1) // 2, 1), tile_sort(x, C),
                  round_trips=B.round_trips(log_c, 1, log_c, 1))
        in_turns("chunk_sort", [x], 1, (C,), chunk_ops(nx, C, 1),
                 tile_sort(x, C))
        # cross_stage<F> at the distances 2^(F-1) T .. T of the last merge
        # level, where every block ascends, on columns that are bitonic
        # along the 2^F axis (an ascending half, a descending half): it
        # sorts each column, as torch.sort(dim=1) of the (n / 2^F T, 2^F,
        # T) view does
        for f in (f for f in B.CROSS_FUSION if log_t + f <= log_n):
            halves = x.view(-1, 2, 1 << (f - 1), T).clone()
            halves[:, 0] = torch.sort(halves[:, 0], dim=1).values
            halves[:, 1] = torch.sort(halves[:, 1], dim=1,
                                      descending=True).values
            y = halves.view(-1)
            want = torch.sort(y.view(-1, 1 << f, T), dim=1).values.view(-1)
            B.cross_stage(y, log_t, f, log_n)
            if not torch.equal(y, want):
                _fail(f"cross_stage<{f}> at the last level differs from "
                      f"torch.sort of the (n / 2^{f} T, 2^{f}, T) view")
            del halves, y, want
            kk = log_n if f == 1 else log_t + f
            time_pair(f"cross_stage<{f}>", log_n,
                      lambda f=f, kk=kk: B.cross_stage(x, log_t, f, kk),
                      lambda f=f, kk=kk: B.cross_stage_ref(x, log_t, f, kk),
                      8 * nx, _cx_ops(nx, f, 1),
                      lambda f=f: torch.sort(x.view(-1, 1 << f, T), dim=1),
                      round_trips=B.cross_round_trips(1, log_t, f, kk))
        # finish on tiles that are bitonic (an ascending half, a descending
        # half), at the last level: it sorts each tile, as torch.sort(dim=1)
        # of the (n / T, T) view does
        halves = torch.sort(x.view(-1, 2, T // 2), dim=2).values
        halves[:, 1] = halves[:, 1].flip(-1)
        xb = halves.view(-1)
        y = xb.clone()
        B.finish(y, T, log_n)
        if not torch.equal(y, tile_sort(xb, T)().values.view(-1)):
            _fail("finish on bitonic tiles differs from torch.sort of the "
                  "tile view")
        time_pair("finish", log_n, lambda: B.finish(xb, T, log_n),
                  lambda: B.finish_ref(xb, T, log_n), 8 * nx,
                  _cx_ops(nx, log_t, 1), tile_sort(xb, T),
                  round_trips=B.round_trips(log_t, log_n, log_n, 1))
        if log_n == 26:
            in_turns("finish", [xb], 1, (T, log_n), _cx_ops(nx, log_t, 1),
                     tile_sort(xb, T))
        del x, keys, y, xb, halves
    # the cross passes at 2^28 keys (the sort_u32_uniform_n2e28 cell's
    # size), each first held equal to the plain version
    x = torch.randint(-(2**31), 2**31, (1 << 28,), dtype=i32, generator=gen,
                      device=dev)
    for f in B.CROSS_FUSION:
        kk = log_t + f
        y = x.clone()
        B.cross_stage(y, log_t, f, kk)
        e = int((y.long() - B.cross_stage_ref(x, log_t, f, kk).long()).abs()
                .max())
        record([f"cross_stage<{f}>"], e, e == 0, n=1 << 28, j_low=log_t,
               kk=kk)
        del y
        time_pair(f"cross_stage<{f}>", 28,
                  lambda f=f, kk=kk: B.cross_stage(x, log_t, f, kk),
                  lambda f=f, kk=kk: B.cross_stage_ref(x, log_t, f, kk),
                  8 << 28, _cx_ops(1 << 28, f, 1),
                  lambda f=f: torch.sort(x.view(-1, 1 << f, T), dim=1),
                  round_trips=B.cross_round_trips(1, log_t, f, kk))
        if f > B.max_fusion(1):
            in_turns("cross_stage", [x], 1, (log_t, f, kk),
                     _cx_ops(1 << 28, f, 1),
                     lambda f=f: torch.sort(x.view(-1, 1 << f, T), dim=1))
    # chunk_sort at 2^28 keys (the cell's size) on both plans
    in_turns("chunk_sort", [x], 1, (C,), chunk_ops(1 << 28, C, 1),
             tile_sort(x, C))
    del x
    torch.cuda.empty_cache()
    # finish at 2^28 keys and 2^28 (key, index) pairs on bitonic tiles (the
    # sort cells' sizes): the rule's kernel beside its plain version, then
    # both plans in turns
    halves = torch.sort(torch.randint(0, 1 << 20, (1 << 28,), dtype=i32,
                                      generator=gen, device=dev)
                        .view(-1, 2, T // 2), dim=2).values
    halves[:, 1] = halves[:, 1].flip(-1)
    xb = halves.view(-1)
    del halves
    time_pair("finish", 28, lambda: B.finish(xb, T, 28),
              lambda: B.finish_ref(xb, T, 28), 8 << 28,
              _cx_ops(1 << 28, log_t, 1), tile_sort(xb, T),
              round_trips=B.round_trips(log_t, 28, 28, 1))
    in_turns("finish", [xb], 1, (T, 28), _cx_ops(1 << 28, log_t, 1),
             tile_sort(xb, T))
    del xb
    lf2 = cfg.lex_tiles(2)[1]
    lex2 = [torch.randint(0, 1 << 20, (1 << 28,), dtype=i32, generator=gen,
                          device=dev),
            torch.randperm(1 << 28, generator=gen, device=dev).to(i32)]
    time_pair("finish/lex2", 28,
              lambda: B.finish(lex2[0], lf2, 28, lex=lex2[1:]),
              lambda: B.finish_ref(lex2[0], lf2, 28, lex=lex2[1:]), 16 << 28,
              _cx_ops(1 << 28, lf2.bit_length() - 1, 2),
              round_trips=B.round_trips(lf2.bit_length() - 1, 28, 28, 2))
    in_turns("finish", lex2, 2, (lf2, 28),
             _cx_ops(1 << 28, lf2.bit_length() - 1, 2))
    # chunk_sort and the strided cross passes of the pairs cell (2^28 lex2)
    # on both plans
    in_turns("chunk_sort", lex2, 2, (lf2,), chunk_ops(1 << 28, lf2, 2))
    ll2 = lf2.bit_length() - 1
    lct = B.cross_tile(2).bit_length() - 1
    for f in range(B.max_fusion(2) + 1, B.cross_fusion(2) + 1):
        in_turns("cross_stage", lex2, 2, (ll2, f, ll2 + f),
                 _cx_ops(1 << 28, f, 2),
                 top=B.compile_time_plan("cross_stage", 2, lct, ll2 + f,
                                         lct - f))
    del lex2
    torch.cuda.empty_cache()
    edge_timings(dev, gen, time_pair, card)
    # the valley merge's overhang at q3's (3 * 2^25 rider rows) and the
    # join's (3 * 2^26 lex2 rows) shapes: the row-limited cross_stage<1>
    # held bit-equal to its plain version in PyTorch (_cx_directed) in both
    # directions (keys in [-1, 15) and 0x7FFFFFFF: ties decided by the
    # second plane), then timed beside it and its bound (each overhang row
    # and its partner read once and written once)
    for ncmp, r in ((1, 3 << 25), (2, 3 << 26)):
        planes = [torch.randint(-1, 15, (r,), dtype=i32, generator=gen,
                                device=dev),
                  torch.randint(-(2**31), 2**31, (r,), dtype=i32,
                                generator=gen, device=dev)]
        planes[0][::5] = 2**31 - 1
        half = 1 << (r - 1).bit_length() - 1
        for desc in (False, True):
            got = [q.clone() for q in planes]
            B._overhang(got, ncmp, desc)
            want = [q.clone() for q in planes]
            B._cx_directed([q[: r - half] for q in want],
                           [q[half:] for q in want], ncmp, desc)
            torch.cuda.synchronize()
            e = max(int((g.long() - w.long()).abs().max())
                    for g, w in zip(got, want))
            record([f"cross_stage<1>{_suffix(ncmp, 2)}"], e, e == 0,
                   n=r, overhang=r - half, descending=desc,
                   keys="[-1,15) and 0x7FFFFFFF")
            del got, want
        tk = timing.time_cuda(lambda: B._overhang(planes, ncmp, False),
                              iters=10, repeats=5)
        tp = timing.time_cuda(lambda: B._cx_directed(
            [q[: r - half] for q in planes], [q[half:] for q in planes], ncmp,
            False), iters=10, repeats=5)
        _line("context", what=f"overhang{_suffix(ncmp, 2)} r={r}",
              ms=tk.seconds * 1e3, plain_ms=tp.seconds * 1e3,
              bound_ms=bound(4 * 2 * 2 * 2 * (r - half))[0], **card)
        del planes
    torch.cuda.empty_cache()

    log_n = 26
    x = torch.from_numpy(rng.integers(0, 10007, n26).astype(np.int32)).to(dev)
    r = torch.arange(n26, dtype=i32, device=dev)
    log_rc = RC.bit_length() - 1
    time_pair("chunk_sort/rider", log_n, lambda: B.chunk_sort(x, RC, rider=r),
              lambda: B.chunk_sort_ref(x, RC, rider=r), 16 * n26,
              _cx_ops(n26, log_rc * (log_rc + 1) // 2, 2),
              round_trips=B.round_trips(log_rc, 1, log_rc, 2))
    in_turns("chunk_sort", [x, r], 1, (RC,), chunk_ops(n26, RC, 2))
    for f in range(1, B.cross_fusion(2) + 1):
        kk = r_log_t + f
        time_pair(f"cross_stage<{f}>/rider", log_n,
                  lambda f=f, kk=kk: B.cross_stage(x, r_log_t, f, kk, rider=r),
                  lambda f=f, kk=kk: B.cross_stage_ref(x, r_log_t, f, kk,
                                                       rider=r),
                  16 * n26, _cx_ops(n26, f, 2),
                  round_trips=B.cross_round_trips(2, r_log_t, f, kk))
    time_pair("finish/rider", log_n, lambda: B.finish(x, RT, log_n, rider=r),
              lambda: B.finish_ref(x, RT, log_n, rider=r), 16 * n26,
              _cx_ops(n26, r_log_t, 2),
              round_trips=B.round_trips(r_log_t, log_n, log_n, 2))
    del x, r

    # the lexicographic mode at 2^23 rows: keys < 2^20, a unique tie plane
    x = torch.randint(0, 1 << 20, (n,), dtype=i32, generator=gen, device=dev)
    lex = [torch.randperm(n, generator=gen, device=dev).to(i32)] + [
        torch.randint(-(2**31), 2**31, (n,), dtype=i32, generator=gen,
                      device=dev) for _ in range(6)]
    for p in B.LEX_PLANES:
        lc, lf = cfg.lex_tiles(p)
        ll = lf.bit_length() - 1
        lcl = lc.bit_length() - 1
        lx = lex[: p - 1]
        time_pair(f"chunk_sort/lex{p}", 23,
                  lambda: B.chunk_sort(x, lc, lex=lx),
                  lambda: B.chunk_sort_ref(x, lc, lex=lx), 8 * p * n,
                  _cx_ops(n, lcl * (lcl + 1) // 2, p),
                  round_trips=B.round_trips(lcl, 1, lcl, p))
        for f in range(1, B.cross_fusion(p) + 1):
            kk = ll + f
            time_pair(f"cross_stage<{f}>/lex{p}", 23,
                      lambda f=f, kk=kk: B.cross_stage(x, ll, f, kk, lex=lx),
                      lambda f=f, kk=kk: B.cross_stage_ref(x, ll, f, kk,
                                                           lex=lx),
                      8 * p * n, _cx_ops(n, f, p),
                      round_trips=B.cross_round_trips(p, ll, f, kk))
        time_pair(f"finish/lex{p}", 23, lambda: B.finish(x, lf, 23, lex=lx),
                  lambda: B.finish_ref(x, lf, 23, lex=lx), 8 * p * n,
                  _cx_ops(n, ll, p), round_trips=B.round_trips(ll, 23, 23, p))
    del x, lex
    # chunk_sort/lex3 at 2^26 (LazyTable's sorts carry a third plane) on
    # both plans
    lex3 = [torch.randint(0, 1 << 20, (n26,), dtype=i32, generator=gen,
                          device=dev),
            torch.randperm(n26, generator=gen, device=dev).to(i32),
            torch.randint(-(2**31), 2**31, (n26,), dtype=i32, generator=gen,
                          device=dev)]
    lc3 = cfg.lex_tiles(3)[0]
    in_turns("chunk_sort", lex3, 2, (lc3,), chunk_ops(n26, lc3, 3))
    del lex3

    # compact on the filter's shape (int32 mask, density 0.5, one plane);
    # beside it a bool mask, and the group-by's two planes by its run ends
    mask = torch.from_numpy((rng.integers(0, 2, n26)).astype(np.int32)).to(dev)
    col = torch.from_numpy(rng.integers(-(2**31), 2**31, n26, dtype=np.int64
                                        ).astype(np.int32)).to(dev)
    bmask = mask.bool()
    time_pair("compact", log_n,
              lambda: CP.compact(mask, [col], cfg.compact_elems),
              lambda: CP.compact_ref(mask, [col]),
              bench.compact_bytes(mask, [col]), n26,
              lambda: torch.masked_select(col, bmask))
    time_pair("compact/bool_mask", log_n,
              lambda: CP.compact(bmask, [col], cfg.compact_elems),
              lambda: CP.compact_ref(bmask, [col]),
              bench.compact_bytes(bmask, [col]), n26,
              lambda: torch.masked_select(col, bmask))
    # with no planes (the count-only filter); its library call counts too
    for name, m in (("compact/count_only", mask),
                    ("compact/count_only_bool_mask", bmask)):
        time_pair(name, log_n,
                  lambda m=m: CP.compact(m, [], cfg.compact_elems),
                  lambda m=m: CP.compact_ref(m, []),
                  m.numel() * m.element_size(), n26,
                  lambda m=m: torch.count_nonzero(m))
    skeys = torch.from_numpy(np.sort(rng.integers(0, 10007, n26).astype(
        np.uint32)).view(np.int32)).to(dev)
    last = torch.ones(n26, dtype=torch.bool, device=dev)
    torch.ne(skeys[1:], skeys[:-1], out=last[:-1])
    time_pair("compact/groupby_run_ends", log_n,
              lambda: CP.compact(last, [skeys, col], cfg.compact_elems),
              lambda: CP.compact_ref(last, [skeys, col]),
              bench.compact_bytes(last, [skeys, col]), n26)
    del mask, bmask, last

    # segscan on the group-by's shape: u32 sum over 10007 sorted groups;
    # beside it the float32 sum, and one-plane fill (the join's)
    plain_scan = lambda: SG.segscan_ref(skeys, col, "sum", torch.uint32)  # noqa: E731
    time_pair("segscan", log_n,
              lambda: SG.segscan_planes(skeys, col, "sum", torch.uint32,
                                        cfg.scan_elems), plain_scan,
              12 * n26, n26)
    time_pair("segscan/float32_sum", log_n,
              lambda: SG.segscan_planes(skeys, col, "sum", torch.float32,
                                        cfg.scan_elems),
              lambda: SG.segscan_ref(skeys, col, "sum", torch.float32),
              12 * n26, n26)
    hflag = (col & 63) == 0
    hflag32 = hflag.to(i32)
    time_pair("segscan/fill", log_n,
              lambda: SG.segscan_planes(skeys, [col], "fill", torch.int32,
                                        cfg.scan_elems, [hflag32]),
              lambda: SG.segscan_ref(skeys, [col], "fill", torch.int32,
                                     [hflag32]), 20 * n26, n26)
    del skeys, col, hflag, hflag32

    # gather_planes at the main path's shapes (bench.gather_inputs):
    # config 2's payload (one source, 2^28 rows), four sources at 2^26
    # (sort_multi), the join's union (tagged, 2 x 10^8 rows from two
    # sources of 10^8).  Each through both routes: the direct kernel (the
    # first design; the route of sources within one window) and the
    # partitioned route that gather_planes takes at these sizes, whole and
    # step by step.  Bound (bench.gather_bytes): the index read, each
    # source row read once, the outputs written; beside it the partitioned
    # route's own floor in sequential passes.  Library call: index_select
    # of the same planes (none computes the tagged mode)
    def gather_time(case, suffix):
        gidx, srcs, mode = bench.gather_inputs(case)
        n = gidx.numel()
        log_n = n.bit_length() - 1
        by = bench.gather_bytes(n, srcs, mode)
        lib = None if mode == "tagged" else (
            lambda: [torch.index_select(s, 0, gidx) for s in srcs])
        floor = {"floor_ms": by["floor"] / HBM_BYTES_PER_S * 1e3}
        direct = GT._KERNEL[mode]
        time_pair(direct + suffix, log_n,
                  lambda: GT.direct(gidx, srcs, mode),
                  lambda: GT.gather_planes_ref(gidx, srcs, mode), by["bound"],
                  lib=lib, n=n, sources=len(srcs), route="direct", **floor)
        time_pair(f"{direct}/partitioned{suffix}", log_n,
                  lambda: GT.partitioned(gidx, srcs, mode),
                  lambda: GT.gather_planes_ref(gidx, srcs, mode), by["bound"],
                  lib=lib, n=n, sources=len(srcs), route="partitioned",
                  **floor)
        if suffix:
            return
        # the steps, on the inputs the route gives them (the window out of
        # place, so that every timed call reads the same P)
        geo = GT.geometry(gidx, srcs, mode)
        side = srcs if geo.tagged else srcs[:1]
        counts = GT.count(gidx, geo)
        offsets, totals = GT.scan(counts, geo)
        p = GT.part(gidx, geo, offsets, totals)
        v = torch.empty_like(p)
        outs = [torch.empty_like(gidx) for _ in range(1 + geo.tagged)]
        table = 8 * counts.numel()
        outs_b = 4 * n * len(outs)
        steps = {
            "count": (lambda: GT.count(gidx, geo),
                      lambda: GT.count_ref(gidx, geo), 4 * n + table, None),
            "scan": (lambda: GT.scan(counts, geo),
                     lambda: GT.scan_ref(counts, geo), 2 * table, None),
            "part": (lambda: GT.part(gidx, geo, offsets, totals),
                     lambda: GT.part_ref(gidx, geo, offsets, totals),
                     8 * n + table, None),
            "window": (lambda: GT.window(p, side, geo, v),
                       lambda: GT.window_ref(p, side, geo, v),
                       8 * n + 4 * sum(q.numel() for q in side),
                       None if geo.tagged else
                       (lambda: torch.index_select(side[0], 0, p))),
            "place": (lambda: GT.place(gidx, geo, offsets, totals, v, outs),
                      lambda: GT.place_ref(gidx, geo, offsets, totals, v,
                                           outs), 8 * n + outs_b + table,
                      None)}
        for step, (kern, ref, bytes_, lib_step) in steps.items():
            time_pair(geo.name(step), log_n, kern, ref, bytes_, lib=lib_step,
                      n=n, windows=geo.nb, tile=1 << geo.log_tile)

    for case, suffix in (("pairs", ""), ("multi", "/4_sources"),
                         ("tagged", "")):
        gather_time(case, suffix)
        torch.cuda.empty_cache()

    # merge_runs at the distributed sort's shapes: the 8-shard mesh's last
    # merge (2^24 + 2^24 rows) and the four-card cell's first level (2^27 +
    # 2^27), keys only, then two runs of 2^24 in lex2 with a payload (the
    # pairs' three planes).  Bound: each row of each plane read once and
    # written once.  Library call: torch.sort of the concatenation
    # (stable), keys only.  Timed into the same output planes, 100 calls a
    # repeat: a repeat of 10 calls also holds the host's time to enqueue its
    # first call and any stall longer than the queue's lead, which late in
    # this process inflate a short merge's time (the context line beside it
    # keeps that reading: a new output a call, 10 calls a repeat)
    for log_n, ncmp, planes in ((25, 1, 1), (28, 1, 1), (25, 2, 3)):
        half = 1 << (log_n - 1)
        ma, mb = merge_inputs(dev, half, half, ncmp, planes, "uniform", 90)
        mo = [torch.empty(2 * half, dtype=i32, device=dev)
              for _ in range(planes)]
        suffix = "" if planes == 1 else f"/lex{planes}"
        lib = None if ncmp == 2 else (
            lambda: torch.sort(torch.cat([ma[0], mb[0]]), stable=True))
        time_pair("merge_runs" + suffix, log_n,
                  lambda: MG.merge_runs(ma, mb, ncmp, out=mo, key_xor=SIGN),
                  lambda: MG.merge_runs_ref(ma, mb, ncmp, key_xor=SIGN),
                  8 * planes * 2 * half, lib=lib, iters=100, planes=planes,
                  items=MG.ITEMS[planes])
        # the kernel's own device time beside the events'
        new_out = timing.time_cuda(
            lambda: MG.merge_runs(ma, mb, ncmp, key_xor=SIGN), iters=10,
            repeats=5)
        _line("context", what=f"merge_runs{suffix} at 2^{log_n}: ms by "
              "events of 10 calls into a new output each, device ms "
              "(torch.profiler) and host µs to enqueue a call",
              new_out_ms=new_out.seconds * 1e3,
              new_out_spread_pct=new_out.spread_pct,
              **timing.profile(
                  lambda: MG.merge_runs(ma, mb, ncmp, out=mo, key_xor=SIGN),
                  lambda: MG.LAUNCHES["merge_runs"], "merge"), **card)
        del ma, mb, mo
        torch.cuda.empty_cache()

    # the pairwise tree that merges a shard's arrivals after the last wave
    # (dist_sort._Merger, K - 1 merge_runs into the output row), keys only,
    # at the 8-shard mesh's shape (8 runs of 2^22) and the four-card cell's
    # (4 runs of 2^27), checked against torch.sort first; beside it the
    # bound of one pass (each row read once and written once)
    from radx_tpu_torch.parallel import dist_sort as DS

    for k, log_run in ((8, 22), (4, 27)):
        runs = [merge_inputs(dev, 1 << log_run, 0, 1, 1, "uniform", 95 + r)[0]
                for r in range(k)]
        tree_out = [torch.empty(k << log_run, dtype=i32, device=dev)]

        def tree():
            merger = DS._Merger(k, 1, tree_out, SIGN)
            for r in runs:
                merger.push(r)

        tree()
        want = torch.sort(torch.cat([r[0] for r in runs])).values ^ SIGN
        if not torch.equal(tree_out[0], want):
            raise AssertionError(f"merge tree of {k} x 2^{log_run} differs")
        del want
        tt = timing.time_cuda(tree, iters=5, repeats=5)
        _line("context", what=f"merge tree of {k} runs of 2^{log_run} "
              f"(dist_sort._Merger: {k - 1} merge_runs)",
              ms=tt.seconds * 1e3, spread_pct=tt.spread_pct,
              one_pass_bound_ms=bound(8 * (k << log_run), 0)[0], **card)
        del runs, tree_out
        torch.cuda.empty_cache()

    # the dense aggregates at 2^26 rows, 256 bins (the config-3 shape)
    dk = torch.randint(0, 256, (n26,), dtype=i32, generator=gen,
                       device=dev).view(torch.uint32)
    dvals = torch.randint(0, 1 << 11, (n26,), dtype=i32, generator=gen,
                          device=dev)
    dk_long, dvals_long = _i32(dk).long(), dvals.long()
    acc = torch.zeros(256, dtype=torch.int64, device=dev)
    ext = torch.full((256,), 2**31 - 1, dtype=i32, device=dev)
    time_pair("dense_sums", log_n, lambda: AG.dense_sums(dk, dvals, 256),
              lambda: AG.dense_sums_ref(dk, dvals, 256), 8 * n26 + 8 * 256,
              2 * n26, lambda: acc.index_add_(0, dk_long, dvals_long))
    time_pair("dense_extrema", log_n,
              lambda: AG.dense_extrema(dk, dvals, 256, True),
              lambda: AG.dense_extrema_ref(dk, dvals, 256, True),
              8 * n26 + 8 * 256, 2 * n26,
              lambda: ext.scatter_reduce_(0, dk_long, dvals, "amin"))
    del dk, dvals, dk_long, dvals_long, acc, ext
    torch.cuda.empty_cache()

    # the radix kernels at the radix geometry of 2^26 keys, on the inputs
    # the sort's own stages give them
    log_n = n26.bit_length() - 1
    rcfg = SortConfig(strategy="radix")
    rp = RS.plan(n26, RS.pick_chunk(n26, rcfg.chunk_elems))
    hx = torch.randint(-(2**31), 2**31, (n26,), dtype=i32, generator=gen,
                       device=dev)
    for name, tile, shift, bias, tot in (
            ("radix_hist", rp.C, 24, 0x80000000, True),
            ("radix_hist/tile", RX.TILE, 8, 0, False)):
        idx = ((torch.arange(n26, device=dev) // tile) * 256
               + ((((_i32(hx).long() & 0xFFFFFFFF) ^ bias) >> shift) & 255))
        time_pair(name, log_n,
                  lambda tile=tile, s=shift, b=bias, tot=tot:
                  RX.histograms(hx, tile, s, b, name=name, totals=tot),
                  lambda tile=tile, s=shift, b=bias, tot=tot:
                  RX.histograms_ref(hx, tile, s, b, n26, tot),
                  4 * n26 + 1024 * (n26 // tile + tot), 3 * n26,
                  lambda idx=idx, tile=tile: torch.bincount(
                      idx, minlength=(n26 // tile) * 256))
        del idx
    del hx
    # both countings on uniform, all-equal and two-valued keys
    for row in bench.sweep_hist(n26):
        _line("hist_sweep", **{k: v for k, v in row.items() if k != "device"},
              **card)
    gen_r = torch.Generator(device=dev).manual_seed(61)
    for mode, (ncmp, np_) in MODES.items():
        planes = _mode_planes(dev, mode, n26, gen_r)
        c, f = rcfg.mode_tiles(np_, ncmp)
        t = min(max(f, c), rp.C)
        log_c = c.bit_length() - 1
        cyc, merge = B.radix_kernels(ncmp, np_)
        pack, concat = M.mode_kernels(ncmp, np_)
        out = [torch.empty_like(q) for q in planes]
        time_pair(cyc, log_n,
                  lambda: B.chunk_sort_cyclic(planes, out, ncmp, rp.C, c),
                  lambda: B.chunk_sort_cyclic_ref(planes, ncmp, rp.C, c),
                  8 * np_ * n26, _cx_ops(n26, log_c * (log_c + 1) // 2, np_),
                  tile_sort(planes[0], c) if mode == "keys" else None,
                  round_trips=B.round_trips(log_c, 1, log_c, np_))
        edge = (ncmp, np_) in B.SOURCE_MODES
        if edge:  # K4's source form: the caller's columns, biased at load
            sources = _sources_of(planes, ncmp)
            k4s = B.radix_source_kernel(ncmp, np_)
            time_pair(k4s, log_n,
                      lambda: B.chunk_sort_cyclic_sources(out, ncmp, rp.C, c,
                                                          sources),
                      lambda: B.chunk_sort_cyclic_ref(
                          B.source_planes_ref(sources, 0, n26, dev), ncmp,
                          rp.C, c),
                      sum(4 * n26 for s in sources if s.cols) + 4 * np_ * n26,
                      _cx_ops(n26, log_c * (log_c + 1) // 2, np_) + n26,
                      round_trips=B.round_trips(log_c, 1, log_c, np_),
                      ptxas=ptxas_of(k4s))
        sorted_ = B.sort_chunks_ascending_cyclic(planes, ncmp, rp.C, c, f)
        tail = mode == "rider"
        args = RS.rank_args(sorted_[0], planes[0], rp, n26,
                            rcfg.mode_tiles(1, 1), tail)
        b = RS.rank_runs(*args)
        if mode == "keys":
            time_pair("radix_rank", log_n, lambda: RS.rank_runs(*args),
                      lambda: RS.rank_runs_ref(*args), *bench.rank_bytes(rp),
                      lambda: bench.rank_runs_library(*args))
            view = sorted_[0].view(rp.n_chunks, rp.C)
            spl2 = b.splitters.expand(rp.n_chunks, rp.nb - 1).contiguous()
            ts = timing.time_cuda(lambda: torch.searchsorted(view, spl2),
                                  iters=10, repeats=5)
            _line("context", what="torch.searchsorted alone (radix_rank's "
                  "ranks)", n=n26, ms=ts.seconds * 1e3, **card)
        packed = M.pack(sorted_, b.bounds, rp.C, rp.slot, rp.nb_pad, ncmp)
        slots = rp.nb_pad * rp.C
        time_pair(pack, log_n,
                  lambda: M.pack(sorted_, b.bounds, rp.C, rp.slot, rp.nb_pad,
                                 ncmp),
                  lambda: M.pack_ref(sorted_, b.bounds, rp.C, rp.slot,
                                     rp.nb_pad, ncmp),
                  4 * np_ * (n26 + slots) + 4 * b.bounds.numel())
        mout = [torch.empty_like(q) for q in packed]
        log_t = t.bit_length() - 1
        log_s = rp.slot.bit_length() - 1
        time_pair(merge, log_n,
                  lambda: B.slot_merge(packed, mout, ncmp, rp.C, rp.slot, t),
                  lambda: B.slot_merge_ref(packed, ncmp, rp.C, rp.slot, t),
                  8 * np_ * slots,
                  _cx_ops(slots, sum(range(log_s + 1, log_t + 1)), np_),
                  tile_sort(packed[0], t) if mode == "keys" else None,
                  round_trips=B.round_trips(log_t, log_s + 1, log_t, np_))
        del mout
        merged = B.merge_slots_ascending(packed, ncmp, rp.C, rp.slot, c, f)
        del packed
        src = sorted_ if tail else None
        cout = [torch.empty_like(q) for q in planes]
        time_pair(concat, log_n,
                  lambda: M.concat(merged, src, cout, b.start, b.src,
                                   rp.nb_pad, ncmp),
                  lambda: M.concat_ref(merged, src, b.start, b.src, rp.nb_pad,
                                       n26, ncmp),
                  8 * np_ * n26 + 16 * b.src.numel())
        if edge:  # K13's unbiasing form, in place
            k13 = M.unbias_kernel(ncmp, np_)
            time_pair(k13, log_n,
                      lambda: M.concat(merged, src, cout, b.start, b.src,
                                       rp.nb_pad, ncmp, (cout[0], 0)),
                      lambda: M.concat_ref(merged, src, b.start, b.src,
                                           rp.nb_pad, n26, ncmp)[0] ^ SIGN,
                      8 * np_ * n26 + 16 * b.src.numel(), n26,
                      ptxas=ptxas_of(k13))
        del planes, out, sorted_, merged, cout, args, b, src
        torch.cuda.empty_cache()
    # K4 and K5 at the radix cells' shapes on both plans, in turns: keys and
    # lex2 at 2^28 (C = 2^19, slots of 1024), rider at 2^26 (slots of
    # 4096); K5 over the packed slots (nb_pad x C rows) of random keys (a
    # compare-exchange network's work does not depend on them)
    for mode, log_r in (("keys", 28), ("lex2", 28), ("rider", 26)):
        ncmp, np_ = MODES[mode]
        nr = 1 << log_r
        geo = RS.plan(nr, RS.pick_chunk(nr, rcfg.chunk_elems))
        c, f = rcfg.mode_tiles(np_, ncmp)
        t = min(max(f, c), geo.C)
        lc, lt, ls = (c.bit_length() - 1, t.bit_length() - 1,
                      geo.slot.bit_length() - 1)
        planes = _mode_planes(dev, mode, nr, gen_r)
        out = [torch.empty_like(q) for q in planes]
        in_turns("chunk_sort_cyclic", planes, ncmp, (out, geo.C, c),
                 chunk_ops(nr, c, np_),
                 tile_sort(planes[0], c) if np_ == 1 else None,
                 top=B.compile_time_plan("chunk_sort_cyclic", np_, lc, lc),
                 C=geo.C, tile=c, round_trips=B.round_trips(lc, 1, lc, np_))
        radix_edge_timings(planes, out, ncmp, geo, log_r)
        del planes, out
        slot_rows = geo.nb_pad * geo.C
        packed = [torch.randint(-(2**31), 2**31, (slot_rows,), dtype=i32,
                                generator=gen_r, device=dev)
                  for _ in range(np_)]
        mout = [torch.empty_like(q) for q in packed]
        in_turns("slot_merge", packed, ncmp, (mout, geo.C, geo.slot, t),
                 _cx_ops(slot_rows, sum(range(ls + 1, lt + 1)), np_),
                 tile_sort(packed[0], t) if np_ == 1 else None,
                 top=B.compile_time_plan("slot_merge", np_, lt, lt,
                                         log_s=ls),
                 n_keys=nr, C=geo.C, slot=geo.slot, tile=t,
                 round_trips=B.round_trips(lt, ls + 1, lt, np_))
        del packed, mout
        torch.cuda.empty_cache()

    _line("elapsed", seconds=time.perf_counter() - t_start)
    for m in (bench.measure_groupby(), bench.measure_filter(),
              bench.measure_query(), bench.measure_sort_pairs(),
              bench.measure_join(), bench.measure_query_dense(),
              bench.measure_radix(1 << 26), bench.measure_radix(1 << 28)):
        extra = {k: m[k] for k in ("bitonic_keys_per_s", "bitonic_ms",
                                   "radix_over_bitonic", "overflow") if k in m}
        _line("metric", **{m["metric"]: m["value"]}, ms=m["ms"],
              spread_pct=m["spread_pct"], **extra, **card)
        torch.cuda.empty_cache()
    _line("elapsed", seconds=time.perf_counter() - t_start)
    for prof in (bench.profile_sort(1 << 23), bench.profile_sort(1 << 26),
                 bench.profile_groupby(), bench.profile_join(),
                 bench.profile_query_dense(), bench.profile_radix(1 << 26)):
        _line("breakdown", **prof)
        torch.cuda.empty_cache()
    for n in (RADIX_N, RADIX_N_BIG):
        _line("launch", **bench.measure_launch(n))
        torch.cuda.empty_cache()

    source = {"bitonic": "radx_tpu_torch/csrc/bitonic.cu",
              "bitonic_io": "radx_tpu_torch/csrc/bitonic_io.cu",
              "compact": "radx_tpu_torch/csrc/compact.cu",
              "segscan": "radx_tpu_torch/csrc/segscan.cu",
              "dense": "radx_tpu_torch/csrc/aggregate.cu",
              "radix": "radx_tpu_torch/csrc/radix.cu",
              "gather": "radx_tpu_torch/csrc/gather.cu",
              "merge": "radx_tpu_torch/csrc/merge.cu"}
    replaces = {
        "chunk_sort": "radx_tpu/kernels/bitonic.py:198",
        "cross_stage<1>": "radx_tpu/kernels/bitonic.py:465",
        "cross_stage<2>": "radx_tpu/kernels/bitonic.py:352",
        "cross_stage<3>": "radx_tpu/kernels/bitonic.py:374",
        "cross_stage<4>": "radx_tpu/kernels/bitonic.py:398",
        # more distances a pass than the TPU fused: its widest kernel
        **{f"cross_stage<{f}>": "radx_tpu/kernels/bitonic.py:398"
           for f in range(5, B.cross_fusion(1) + 1)},
        "finish": "radx_tpu/kernels/bitonic.py:427",
        "chunk_sort_cyclic": "radx_tpu/kernels/bitonic.py:217",
        "slot_merge": "radx_tpu/kernels/bitonic.py:261",
        "compact": "radx_tpu/kernels/compact.py:54",
        "segscan": "radx_tpu/kernels/segscan.py:78",
        "dense_sums": "radx_tpu/kernels/aggregate.py:47",
        "dense_extrema": "radx_tpu/kernels/aggregate.py:164",
        "radix_hist": "radx_tpu/kernels/radix.py:104",
        "radix_hist/tile": "radx_tpu/kernels/radix.py:38",
        "radix_rank": "radx_tpu/kernels/msd.py:117",
        "radix_pack": "radx_tpu/kernels/msd.py:194",
        "radix_concat": "radx_tpu/kernels/msd.py:243",
        # no Pallas kernel: the value planes that the JAX package sorts as
        # riders (the stable sorts' payloads, the join union's values); both
        # routes, every step of the partitioned one
        **{k: "radx_tpu/ops/join.py:70" if "tagged" in k
           else "radx_tpu/ops/sort.py:136" for k in GT.KERNELS},
        # no Pallas kernel: the network's run merge over the padded slots
        # of the JAX distributed sort (XLA's static shapes)
        **{k: "radx_tpu/parallel/dist_sort.py:112" for k in MG.KERNELS},
    }

    def entry(name):
        family = name.split("/")[0]
        if name in B.SOURCE_KERNELS:  # chunk_sort/src.., finish/unbias..
            src, rep = source["bitonic_io"], replaces[family]
        elif name in B.KERNELS:
            src, rep = source["bitonic"], replaces[family]
        elif name in AG.KERNELS:
            src, rep = source["dense"], replaces[name]
        elif family.startswith("radix"):
            src, rep = source["radix"], replaces.get(name, replaces[family])
        elif name in GT.KERNELS:
            src, rep = source["gather"], replaces[name]
        elif name in MG.KERNELS:
            src, rep = source["merge"], replaces[name]
        else:
            kind = name.split("_")[0]
            src, rep = source[kind], replaces[kind]
        times = rows[name]
        log_n = min(times)
        e = {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": TOTAL_LAUNCHES.get(name, 0),
             "max_abs_err": ERR.get(name, 0.0), **times[log_n]}
        for big in (26, 28):
            if log_n != big and big in times:
                e.update({f"{k}_n2e{big}": v for k, v in times[big].items()})
        return e

    kernels = [entry(k) for k in all_kernels]
    _line("unlaunched", kernels=[k["name"] for k in kernels
                                 if k["launches"] < 1])
    _line("elapsed", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
