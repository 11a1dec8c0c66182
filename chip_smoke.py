"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits nonzero):

  1. the card: name, count, torch and CUDA versions, nvidia-smi name and
     power limit;
  2. build the kernels from radx_tpu_torch/csrc/ with nvcc (sm_90a) and print
     ptxas's register / shared-memory report for each;
  3. every kernel against its plain PyTorch version on the card, on 2^23
     keys, for bit equality;
  4. the slice through ``radx_tpu_torch.sort`` / ``sort_any``: every result
     bit-equal to ``torch.sort`` on the card (and to ``np.sort`` at 2^23),
     with each kernel's launch count over this phase (>= 1) and the plain
     versions' call count (0);
  5. timings (CUDA events): ``sort_u32_keys_per_s_n2e23`` and ``_n2e26``,
     each kernel beside its plain version, and ``torch.sort`` as context.

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


def _line(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def _fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        raise SystemExit(2)

    from radx_tpu_torch import SortConfig, sort, sort_any
    from radx_tpu_torch import bench
    from radx_tpu_torch.kernels import _build
    from radx_tpu_torch.kernels import bitonic as B
    from radx_tpu_torch.ops import sort as S
    from radx_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = timing.nvidia_smi()
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    cfg = SortConfig()
    C, T = cfg.chunk_elems, cfg.finish_elems
    log_t = T.bit_length() - 1

    # -- 1. the card ---------------------------------------------------------
    _line("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvidia_smi=smi, chunk_elems=C,
          finish_elems=T)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    _, log = _build.library_path()
    ptxas, kernel = {}, None
    for ln in log.read_text().splitlines():
        found = re.search(
            r"Compiling entry function .*?(chunk_sort|finish|cross_stage)"
            r"_kernel(?:ILi(\d))?", ln)
        if found:
            kernel = found.group(1) + (
                f"<{found.group(2)}>" if found.group(2) else "")
        elif kernel and ("Used" in ln or "spill" in ln):
            info = ln.split(":", 1)[-1] if "ptxas info" in ln else ln
            ptxas[kernel] = f"{ptxas.get(kernel, '')} {info.strip()}".strip()
    _line("build", seconds=time.perf_counter() - t0, library=so.name,
          ptxas=ptxas, dynamic_smem_bytes={"chunk_sort": 4 * C, "finish": 4 * T})

    # -- 3. kernel vs plain version on the card ------------------------------
    n = 1 << 23
    rng = np.random.default_rng(1)
    base = torch.from_numpy(
        rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    ).to(dev)
    err = dict.fromkeys(B.KERNELS, 0)

    def check(name, kernel, ref, **case):
        x = base.clone()
        kernel(x)
        want = ref(base)
        torch.cuda.synchronize()
        e = int((x.long() - want.long()).abs().max())
        err[name] = max(err[name], e)
        _line("kernel", name=name, n=n, equal=e == 0, max_abs_err=e, **case)
        if e:
            _fail(f"{name} differs from its plain version ({case})")

    for inv in (False, True):
        check("chunk_sort", lambda x: B.chunk_sort(x, C, invert=inv),
              lambda x: B.chunk_sort_ref(x, C, invert=inv), invert=inv)
    check("chunk_sort", lambda x: B.chunk_sort(x, C, ascending=True),
          lambda x: B.chunk_sort_ref(x, C, ascending=True), ascending=True)
    for f in B.CROSS_FUSION:
        kk, inv = log_t + f, f % 2 == 0
        check(f"cross_stage<{f}>",
              lambda x: B.cross_stage(x, log_t, f, kk, inv),
              lambda x: B.cross_stage_ref(x, log_t, f, kk, inv),
              j_low=log_t, kk=kk, invert=inv)
    for kk, inv in ((log_t + 1, False), (23, True), (5, False)):
        check("finish", lambda x: B.finish(x, T, kk, inv),
              lambda x: B.finish_ref(x, T, kk, inv), tile=T, kk=kk,
              invert=inv)

    # -- 4. the slice through the public entry points -------------------------
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

    B.reset_counts()
    outs = {k: sort(v) for k, v in dev_inputs.items()}
    any_outs = {k: sort_any(x, descending=d) for k, (x, d) in any_inputs.items()}
    torch.cuda.synchronize()
    launches = dict(B.LAUNCHES)
    plain = dict(B.PLAIN_CALLS)

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
    _line("counts", launches=launches, plain_calls=plain)
    missing = [k for k, v in launches.items() if v < 1]
    if missing or any(plain.values()):
        _fail(f"kernels not launched by the slice: {missing}; plain calls {plain}")

    # -- 5. timings ------------------------------------------------------------
    rows = {}
    for log_n in (23, 26):
        m = bench.measure(1 << log_n)
        _line("metric", **{m["metric"]: m["value"]}, ms=m["ms"],
              spread_pct=m["spread_pct"], **card)
        keys = dev_inputs["permutation_2e23"] if log_n == 23 else dev_inputs["uniform_2e26"]
        ts = timing.time_cuda(lambda: bench.torch_sort_u32(keys), iters=10, repeats=5)
        _line("context", what=f"torch.sort n=2^{log_n} (sign-biased int32)",
              ms=ts.seconds * 1e3, keys_per_s=keys.numel() / ts.seconds, **card)
        x = torch.from_numpy(
            rng.integers(-(2**31), 2**31, 1 << log_n, dtype=np.int64).astype(np.int32)
        ).to(dev)
        pairs = [("chunk_sort", lambda: B.chunk_sort(x, C),
                  lambda: B.chunk_sort_ref(x, C))]
        for f in B.CROSS_FUSION:
            kk = log_t + f
            pairs.append((f"cross_stage<{f}>",
                          lambda f=f, kk=kk: B.cross_stage(x, log_t, f, kk),
                          lambda f=f, kk=kk: B.cross_stage_ref(x, log_t, f, kk)))
        pairs.append(("finish", lambda: B.finish(x, T, log_n),
                      lambda: B.finish_ref(x, T, log_n)))
        for name, kern, ref in pairs:
            tk = timing.time_cuda(kern, iters=10, repeats=5)
            tp = timing.time_cuda(ref, iters=3, repeats=3, warmup=1)
            rows.setdefault(name, {})[log_n] = (tk.seconds * 1e3, tp.seconds * 1e3)
            _line("kernel_time", name=name, n=1 << log_n, ms=tk.seconds * 1e3,
                  spread_pct=tk.spread_pct, plain_ms=tp.seconds * 1e3,
                  plain_spread_pct=tp.spread_pct, **card)
        del x

    replaces = {
        "chunk_sort": "radx_tpu/kernels/bitonic.py:198",
        "cross_stage<1>": "radx_tpu/kernels/bitonic.py:465",
        "cross_stage<2>": "radx_tpu/kernels/bitonic.py:352",
        "cross_stage<3>": "radx_tpu/kernels/bitonic.py:374",
        "cross_stage<4>": "radx_tpu/kernels/bitonic.py:398",
        "finish": "radx_tpu/kernels/bitonic.py:427",
    }
    kernels = [
        {"name": k, "route": "cuda", "source": "radx_tpu_torch/csrc/bitonic.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": err[k], "ms": rows[k][23][0], "plain_ms": rows[k][23][1],
         "ms_n2e26": rows[k][26][0], "plain_ms_n2e26": rows[k][26][1]}
        for k in B.KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
