"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits nonzero):

  1. the card: name, count, torch and CUDA versions, nvidia-smi name and
     power limit;
  2. build the kernels from radx_tpu_torch/csrc/ with nvcc (sm_90a, one
     process per source) and print ptxas's register / shared-memory report
     for each kernel, keys-only and two-plane (rider) bitonic alike;
  3. every kernel against its plain PyTorch version on the card: the bitonic
     kernels on 2^23 keys (keys only; and with a rider on keys in [0, 16),
     both planes bit-equal), compact for 1-3 planes at densities 0, 0.5 and
     1 on a ragged n, segscan for every op x value dtype over 5000, 7 and
     1 groups and fill with two plane pairs (integers and float min/max
     bit-equal, float sums within 1e-5 of the run's sum of magnitudes);
  4. the slices through the public entry points, each driven with the
     launch counts set to 0 just before it and read just after (>= 1 for
     every kernel of the slice, 0 plain-version calls):
       a. ``sort`` / ``sort_any`` (slice 1), bit-equal to ``torch.sort``;
       b. the config-3 query at 2^28 rows (``filter_columns`` then
          ``groupby`` sum / count / min / max), a 256-group digit bucket at
          2^26, key 0xFFFFFFFF present and absent, int32 and float32 keys
          and values, and ``unique`` with counts at 2^26, all against plain
          torch references on the card; the 2^28 run's peak device memory;
  5. timings (CUDA events): the sort, group-by, filter and query metrics,
     each kernel beside its plain version, ``torch.sort`` as context.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

SIGN = -(1 << 31)


def _line(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def _fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def _ptxas_name(kernel, args):
    """Readable name of a compiled kernel from its template arguments."""
    a = [int(x) for x in re.findall(r"Li(\d+)E", args or "")]
    if kernel == "cross_stage":
        return f"cross_stage<{a[0]}>" + ("/rider" if a[1] == 2 else "")
    if kernel in ("chunk_sort", "finish"):
        return kernel + ("/rider" if a[0] == 2 else "")
    if kernel.startswith("segscan"):
        op = ("sum", "min", "max", "fill")[a[0]]
        dt = ("u32", "i32", "f32")[a[1]]
        return f"{kernel}<{op}{a[2] if op == 'fill' else ','+dt}>"
    return kernel + (f"<{a[0]}>" if a else "")


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


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        raise SystemExit(2)

    from radx_tpu_torch import (SortConfig, filter_columns, groupby, sort,
                                sort_any, unique)
    from radx_tpu_torch import bench
    from radx_tpu_torch.kernels import _build
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.kernels import compact as CP
    from radx_tpu_torch.kernels import segscan as SG
    from radx_tpu_torch.ops import sort as S
    from radx_tpu_torch.utils import timing

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = timing.nvidia_smi()
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    cfg = SortConfig()
    C, T = cfg.chunk_elems, cfg.finish_elems
    log_t = T.bit_length() - 1
    RC, RT = cfg.rider_chunk_elems, cfg.rider_finish_elems
    r_log_t = RT.bit_length() - 1
    modules = (B, CP, SG)

    def reset_counts():
        for m in modules:
            m.reset_counts()

    def read_counts():
        launches, plain = {}, {}
        for m in modules:
            launches.update(m.LAUNCHES)
            plain.update(m.PLAIN_CALLS)
        return launches, plain

    # -- 1. the card ---------------------------------------------------------
    _line("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvidia_smi=smi, config=repr(cfg))

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    _, log = _build.library_path()
    ptxas, kernel = {}, None
    for ln in log.read_text().splitlines():
        found = re.search(
            r"Compiling entry function .*?(chunk_sort|finish|cross_stage|"
            r"compact_count|compact_write|segscan_tile|segscan_carry|"
            r"segscan_apply)_kernel(I(?:Li\d+E)+E)?", ln)
        if found:
            kernel = _ptxas_name(found.group(1), found.group(2))
        elif kernel and ("Used" in ln or "spill" in ln):
            info = ln.split(":", 1)[-1] if "ptxas info" in ln else ln
            ptxas[kernel] = f"{ptxas.get(kernel, '')} {info.strip()}".strip()
    _line("build", seconds=time.perf_counter() - t0, library=so.name,
          ptxas=ptxas, dynamic_smem_bytes={
              "chunk_sort": 4 * C, "finish": 4 * T,
              "chunk_sort/rider": 8 * RC, "finish/rider": 8 * RT})

    # -- 3. kernel vs plain version on the card ------------------------------
    n = 1 << 23
    rng = np.random.default_rng(1)
    base = torch.from_numpy(
        rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    ).to(dev)
    ties = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32)).to(dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    err = {k: 0.0 for k in (*B.KERNELS, *CP.KERNELS, *SG.KERNELS)}

    def record(names, e, ok, **case):
        for name in names:
            err[name] = max(err[name], e)
        _line("kernel", name="+".join(names), equal=ok, max_abs_err=e, **case)
        if not ok:
            _fail(f"{names} differ from the plain version ({case})")

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
    for f in B.CROSS_FUSION:
        kk, inv = log_t + f, f % 2 == 0
        check(f"cross_stage<{f}>",
              lambda x: B.cross_stage(x, log_t, f, kk, inv),
              lambda x: B.cross_stage_ref(x, log_t, f, kk, inv),
              j_low=log_t, kk=kk, invert=inv)
        rkk = r_log_t + f
        check_rider(f"cross_stage<{f}>",
                    lambda x, r: B.cross_stage(x, r_log_t, f, rkk, inv, r),
                    lambda x, r: B.cross_stage_ref(x, r_log_t, f, rkk, inv, r),
                    j_low=r_log_t, kk=rkk, invert=inv)
    for kk, inv in ((log_t + 1, False), (23, True), (5, False)):
        check("finish", lambda x: B.finish(x, T, kk, inv),
              lambda x: B.finish_ref(x, T, kk, inv), tile=T, kk=kk,
              invert=inv)
        check_rider("finish", lambda x, r: B.finish(x, RT, kk, inv, r),
                    lambda x, r: B.finish_ref(x, RT, kk, inv, r), tile=RT,
                    kk=kk, invert=inv)

    ragged = n + 4097
    planes = [torch.from_numpy(rng.integers(-(2**31), 2**31, ragged,
                                            dtype=np.int64).astype(np.int32)
                               ).to(dev) for _ in range(3)]
    for density in (0.0, 0.5, 1.0):
        mask = torch.from_numpy(
            (rng.random(ragged) < density).astype(np.int32)).to(dev)
        for p in (1, 2, 3):
            outs, count = CP.compact(mask, planes[:p], cfg.compact_elems)
            want, wcount = CP.compact_ref(mask, planes[:p])
            torch.cuda.synchronize()
            c = int(wcount)
            e = max([abs(int(count) - c)] + [
                int((o[:c].long() - w[:c].long()).abs().max()) if c else 0
                for o, w in zip(outs, want)])
            record(list(CP.KERNELS), e, e == 0, n=ragged, planes=p,
                   density=density, kept=c)
    del planes, mask

    scan_n = n + 33
    for groups in (5000, 7, 1):
        keys = torch.from_numpy(np.sort(rng.integers(0, groups, scan_n).astype(
            np.uint32)).view(np.int32)).to(dev)
        for dtype in (torch.uint32, torch.int32, torch.float32):
            if dtype == torch.float32:
                vals = torch.from_numpy(rng.standard_normal(scan_n).astype(
                    np.float32).view(np.int32)).to(dev)
            else:
                vals = torch.from_numpy(rng.integers(
                    -(2**31), 2**31, scan_n, dtype=np.int64).astype(np.int32)
                ).to(dev)
            for op in ("sum", "min", "max"):
                got = SG.segscan_planes(keys, vals, op, dtype, cfg.scan_elems)
                want = SG.segscan_ref(keys, vals, op, dtype)
                torch.cuda.synchronize()
                if op == "sum" and dtype == torch.float32:
                    e, ok = _segscan_tol(SG, keys, vals, got, want)
                else:
                    e = int((got.long() - want.long()).abs().max())
                    ok = e == 0
                record(list(SG.KERNELS), e, ok, n=scan_n, groups=groups,
                       op=op, dtype=str(dtype))
    flags = [torch.from_numpy((rng.random(scan_n) < 0.01).astype(np.int32)
                              ).to(dev) for _ in range(2)]
    fvals = [torch.from_numpy(rng.integers(-(2**31), 2**31, scan_n,
                                           dtype=np.int64).astype(np.int32)
                              ).to(dev) for _ in range(2)]
    gv, gh = SG.segscan_planes(keys, fvals, "fill", torch.int32,
                               cfg.scan_elems, flags)
    wv, wh = SG.segscan_ref(keys, fvals, "fill", torch.int32, flags)
    torch.cuda.synchronize()
    e = max(int((a.long() - b.long()).abs().max()) for a, b in
            zip(gv + gh, wv + wh))
    record(list(SG.KERNELS), e, e == 0, n=scan_n, op="fill", planes=2)
    del base, ties, iota, keys, vals, got, want, flags, fvals, gv, gh, wv, wh
    torch.cuda.empty_cache()

    # -- 4a. slice 1: sort / sort_any -----------------------------------------
    rng = np.random.default_rng(2)
    perm = bench.permutation_keys(1 << 23)
    f32 = rng.standard_normal(1_000_000).astype(np.float32)
    f32[rng.integers(0, f32.size, 5000)] = np.nan
    f32[rng.integers(0, f32.size, 5000)] = np.inf
    f32[rng.integers(0, f32.size, 5000)] = -np.inf
    f32[rng.integers(0, f32.size, 5000)] = 0.0
    f32[rng.integers(0, f32.size, 5000)] = -0.0
    i32 = rng.integers(-(2**31), 2**31, 1_000_000, dtype=np.int64).astype(np.int32)
    i32[:1000] = np.iinfo(np.int32).min
    i32[1000:2000] = np.iinfo(np.int32).max
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
        for name, a in (("int32_1e6", i32), ("float32_1e6", f32))
        for desc in (False, True)
    }
    torch.cuda.synchronize()

    reset_counts()
    outs = {k: sort(v) for k, v in dev_inputs.items()}
    any_outs = {k: sort_any(x, descending=d) for k, (x, d) in any_inputs.items()}
    torch.cuda.synchronize()
    launches, plain = read_counts()

    for k, x in dev_inputs.items():
        got, want = outs[k], bench.torch_sort_u32(x)
        ok = got.dtype == torch.uint32 and got.device == x.device and torch.equal(
            got.view(torch.int32), want.view(torch.int32))
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
        ok = got.dtype == x.dtype and torch.equal(
            got.view(torch.int32), want.view(torch.int32))
        _line("slice", input=f"sort_any_{k}", n=x.numel(),
              equal_torch_sort=bool(ok))
        if not ok:
            _fail(f"sort_any({k}) differs from torch.sort")
    sort_launches = {k: launches[k] for k in B.KEY_KERNELS}
    _line("counts", slice="sort", launches=sort_launches, plain_calls=plain)
    missing = [k for k, v in sort_launches.items() if v < 1]
    if missing or any(plain.values()):
        _fail(f"kernels not launched by the sort slice: {missing}; "
              f"plain calls {plain}")
    del dev_inputs, any_inputs, outs, any_outs
    torch.cuda.empty_cache()

    # -- 4b. slice 2: the config-3 query and the other relational inputs -----
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

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mask = pred.view(torch.int32) >= 0  # pred < 2^31
    (qk, qv), qcount = filter_columns(mask, [key, value])
    qc = int(qcount)
    qk, qv = qk[:qc], qv[:qc]
    q_res = {agg: groupby(qk, qv, agg) for agg in ("sum", "count", "min", "max")}
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
    torch.cuda.synchronize()
    launches, plain = read_counts()

    i32v = torch.int32
    want_q = key.view(i32v)[mask]
    if qc != want_q.numel() or not (
            torch.equal(qk.view(i32v), want_q)
            and torch.equal(qv.view(i32v), value.view(i32v)[mask])):
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
    flip = torch.tensor(SIGN, dtype=i32v, device=dev)
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
                              dtype=i32v, device=dev)
            want = init.scatter_reduce(0, group, iv[ref.indices],
                                       "amin" if agg == "min" else "amax")
            g = uk_w.numel()
            if int(ng) != g or not (torch.equal(uk[:g], uk_w)
                                    and torch.equal(out[:g], want)):
                _fail(f"int32 groupby {agg} differs from the reference")
        _line("slice", input="int32_keys_int32_vals", n=n_typed, agg=agg,
              groups=g, equal_reference=True)
    # float32 keys (no -0.0, no NaN here) / values: float64 reference
    enc_f = torch.where(fk.view(i32v) < 0, ~fk.view(i32v), fk.view(i32v) ^ flip)
    uk_w, _, sums, abss, mins, maxs = _float_group_ref(enc_f ^ flip, fv)
    g = uk_w.numel()
    for agg, (uk, out, ng) in typed["float32_keys_float32_vals"].items():
        got_enc = torch.where(uk[:g].view(i32v) < 0, ~uk[:g].view(i32v),
                              uk[:g].view(i32v) ^ flip) ^ flip
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
    ref = torch.sort(ukeys.view(i32v) ^ flip)
    uk_w, cnt_w = torch.unique_consecutive(ref.values, return_counts=True)
    g = uk_w.numel()
    if int(cu) != g or not (torch.equal(vals_u[:g].view(i32v) ^ flip, uk_w)
                            and torch.equal(cnts_u[:g].long(), cnt_w)):
        _fail("unique with counts differs from torch.unique_consecutive")
    _line("slice", input="unique_counts_2e26", n=n_bucket, groups=g,
          equal_reference=True)
    _line("counts", slice="filter_groupby_unique", launches=launches,
          plain_calls=plain)
    missing = [k for k, v in launches.items() if v < 1]
    if missing or any(plain.values()):
        _fail(f"kernels not launched by the relational slice: {missing}; "
              f"plain calls {plain}")
    relational_launches = launches
    del key, value, pred, mask, qk, qv, q_res, digits, bvals, bucket, ff, ff_res
    del ik, iv, fk, fv, typed, ukeys, uq
    torch.cuda.empty_cache()
    _line("elapsed", seconds=time.perf_counter() - t_start)

    # -- 5. timings ------------------------------------------------------------
    rows = {}

    def time_pair(name, log_n, kern, ref, iters=10):
        tk = timing.time_cuda(kern, iters=iters, repeats=5)
        tp = timing.time_cuda(ref, iters=3, repeats=3, warmup=1)
        rows.setdefault(name, {})[log_n] = (tk.seconds * 1e3, tp.seconds * 1e3)
        _line("kernel_time", name=name, n=1 << log_n, ms=tk.seconds * 1e3,
              spread_pct=tk.spread_pct, plain_ms=tp.seconds * 1e3,
              plain_spread_pct=tp.spread_pct, **card)

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
        time_pair("chunk_sort", log_n, lambda: B.chunk_sort(x, C),
                  lambda: B.chunk_sort_ref(x, C))
        for f in B.CROSS_FUSION:
            kk = log_t + f
            time_pair(f"cross_stage<{f}>", log_n,
                      lambda f=f, kk=kk: B.cross_stage(x, log_t, f, kk),
                      lambda f=f, kk=kk: B.cross_stage_ref(x, log_t, f, kk))
        time_pair("finish", log_n, lambda: B.finish(x, T, log_n),
                  lambda: B.finish_ref(x, T, log_n))
        del x, keys

    log_n = 26
    n26 = 1 << log_n
    x = torch.from_numpy(rng.integers(0, 10007, n26).astype(np.int32)).to(dev)
    r = torch.arange(n26, dtype=torch.int32, device=dev)
    time_pair("chunk_sort/rider", log_n, lambda: B.chunk_sort(x, RC, rider=r),
              lambda: B.chunk_sort_ref(x, RC, rider=r))
    for f in B.CROSS_FUSION:
        kk = r_log_t + f
        time_pair(f"cross_stage<{f}>/rider", log_n,
                  lambda f=f, kk=kk: B.cross_stage(x, r_log_t, f, kk, rider=r),
                  lambda f=f, kk=kk: B.cross_stage_ref(x, r_log_t, f, kk,
                                                       rider=r))
    time_pair("finish/rider", log_n, lambda: B.finish(x, RT, log_n, rider=r),
              lambda: B.finish_ref(x, RT, log_n, rider=r))
    del x, r

    mask = torch.from_numpy((rng.integers(0, 2, n26)).astype(np.int32)).to(dev)
    col = torch.from_numpy(rng.integers(-(2**31), 2**31, n26, dtype=np.int64
                                        ).astype(np.int32)).to(dev)
    counts = CP.count_tiles(mask, cfg.compact_elems)
    inclusive = torch.cumsum(counts, 0)
    plain_compact = lambda: CP.compact_ref(mask, [col])  # noqa: E731
    time_pair("compact_count", log_n,
              lambda: CP.count_tiles(mask, cfg.compact_elems), plain_compact)
    time_pair("compact_write", log_n,
              lambda: CP.write_tiles(mask, [col], inclusive, cfg.compact_elems),
              plain_compact)
    del mask, col, counts, inclusive

    skeys = torch.from_numpy(np.sort(rng.integers(0, 10007, n26).astype(
        np.uint32)).view(np.int32)).to(dev)
    svals = torch.from_numpy(rng.integers(-(2**31), 2**31, n26, dtype=np.int64
                                          ).astype(np.int32)).to(dev)
    launch = SG.Launch(skeys, [svals], [], "sum", torch.uint32, cfg.scan_elems)
    plain_scan = lambda: SG.segscan_ref(skeys, svals, "sum", torch.uint32)  # noqa: E731
    for phase, name in enumerate(SG.KERNELS):
        time_pair(name, log_n, lambda phase=phase: launch.run(phase),
                  plain_scan)
    del skeys, svals, launch
    torch.cuda.empty_cache()

    for m in (bench.measure_groupby(), bench.measure_filter(),
              bench.measure_query()):
        _line("metric", **{m["metric"]: m["value"]}, ms=m["ms"],
              spread_pct=m["spread_pct"], **card)

    source = {"bitonic": "radx_tpu_torch/csrc/bitonic.cu",
              "compact": "radx_tpu_torch/csrc/compact.cu",
              "segscan": "radx_tpu_torch/csrc/segscan.cu"}
    replaces = {
        "chunk_sort": "radx_tpu/kernels/bitonic.py:198",
        "cross_stage<1>": "radx_tpu/kernels/bitonic.py:465",
        "cross_stage<2>": "radx_tpu/kernels/bitonic.py:352",
        "cross_stage<3>": "radx_tpu/kernels/bitonic.py:374",
        "cross_stage<4>": "radx_tpu/kernels/bitonic.py:398",
        "finish": "radx_tpu/kernels/bitonic.py:427",
        "compact": "radx_tpu/kernels/compact.py:54",
        "segscan": "radx_tpu/kernels/segscan.py:78",
    }

    def entry(name):
        family = name.split("/")[0]
        if name in B.KERNELS:
            src, rep = source["bitonic"], replaces[family]
        else:
            kind = name.split("_")[0]
            src, rep = source[kind], replaces[kind]
        times = rows[name]
        log_n = 23 if 23 in times else 26
        e = {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": relational_launches[name], "max_abs_err": err[name],
             "ms": times[log_n][0], "plain_ms": times[log_n][1],
             "n": 1 << log_n}
        if log_n == 23:
            e.update(ms_n2e26=times[26][0], plain_ms_n2e26=times[26][1])
        return e

    kernels = [entry(k) for k in (*B.KERNELS, *CP.KERNELS, *SG.KERNELS)]
    _line("elapsed", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
