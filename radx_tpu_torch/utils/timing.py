"""Timing on the card with CUDA events — counterpart of radx_tpu/utils/timing.py.

PyTorch returns before the device finishes, so a host clock without a
synchronise measures only the enqueue.  ``time_cuda`` records a CUDA event
before and after ``iters`` back-to-back calls on the current stream, waits
for the second, and divides; it repeats that ``repeats`` times after a
warm-up and reports the least per-call time with the spread of the repeats.
A repeat that reads zero or less is dropped, never clamped to a tiny
positive time that would report an absurd rate.  With no CUDA device every
function here raises: a measurement never falls back to the CPU.

``time_op`` wraps ``time_cuda`` in the JAX package's interface and returns a
``Metrics`` row (items/s, GB/s, the JAX row format).  The JAX ``time_op``
chains k applications inside one ``jit`` and reports (t_k - t_1)/(k - 1):
that defeats XLA's dead-code elimination and a relay's asynchronous
dispatch, neither of which PyTorch has, so it is not ported.  ``trace``
records a ``torch.profiler`` trace of the enclosed calls; ``profile`` gives
the device time a call of some kernels by the profiler, beside the host's
time to enqueue the call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import subprocess
import time
from typing import Callable

import torch


@dataclasses.dataclass
class Timing:
    """Per-call seconds of each kept repeat; ``seconds`` is the least."""

    samples: list[float]

    @property
    def seconds(self) -> float:
        return min(self.samples)

    @property
    def spread_pct(self) -> float:
        return 100.0 * (max(self.samples) - self.seconds) / self.seconds


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: timings are taken on the card only")
    return torch.device("cuda", torch.cuda.current_device())


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    proc = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return proc.stdout.strip() or proc.stderr.strip()


def device_info() -> dict:
    dev = require_cuda()
    return {
        "name": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi(),
    }


def time_cuda(fn: Callable[[], object], *, iters: int = 10, repeats: int = 5,
              warmup: int = 2) -> Timing:
    """Least per-call device time of ``fn`` over ``repeats`` runs of
    ``iters`` back-to-back calls, bracketed by CUDA events."""
    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
        if dt > 0:
            samples.append(dt)
    if not samples:
        raise RuntimeError("every timing repeat read zero or less")
    return Timing(samples)


@dataclasses.dataclass
class Metrics:
    """One timed operation: least seconds per call, the items and bytes one
    call processes, and the spread of the repeats (the JAX ``Metrics`` with
    ``spread_pct`` added)."""

    name: str
    seconds: float
    items: int
    bytes_moved: int = 0
    spread_pct: float = 0.0

    @property
    def items_per_s(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else float("inf")

    @property
    def gbytes_per_s(self) -> float:
        return self.bytes_moved / self.seconds / 1e9 if self.seconds > 0 else 0.0

    def row(self) -> str:
        return (
            f"{self.name:32s} {self.seconds*1e3:9.3f} ms  "
            f"{self.items_per_s/1e9:8.3f} G items/s  "
            f"{self.gbytes_per_s:8.1f} GB/s"
        )


def time_op(fn: Callable, x, *, name: str = "op", items: int | None = None,
            bytes_moved: int = 0, iters: int = 8, repeats: int = 3,
            warmup: int = 2) -> Metrics:
    """``Metrics`` of ``fn(x)`` on the card: ``time_cuda`` over
    back-to-back calls (CUDA events, least of ``repeats`` runs of ``iters``
    calls).  ``items`` defaults to ``x.numel()`` (give it where ``x`` is
    not one tensor)."""
    t = time_cuda(lambda: fn(x), iters=iters, repeats=repeats, warmup=warmup)
    return Metrics(name=name, seconds=t.seconds,
                   items=x.numel() if items is None else items,
                   bytes_moved=bytes_moved, spread_pct=t.spread_pct)


@contextlib.contextmanager
def trace(path):
    """Profile the enclosed calls (host and CUDA activities) and write a
    Chrome trace to ``path`` (the counterpart of the JAX ``trace``, which
    writes an XProf trace); the card is synchronised before the profile
    stops."""
    require_cuda()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def profile(fn: Callable[[], object], launches: Callable[[], int],
            match: str, calls: int = 10) -> dict:
    """The device ms a call of ``fn``'s kernels whose names hold ``match``,
    by ``torch.profiler``: the mean of the kernel events it recorded, times
    the launches a call (``launches()`` reads a launch count before and
    after), so a profiler that drops events does not skew it.  Beside it
    the host µs to enqueue one call (``2 * calls`` calls, no sync)."""
    require_cuda()
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(2 * calls):
        fn()
    host_us = (time.perf_counter() - start) / (2 * calls) * 1e6
    torch.cuda.synchronize()
    launched = launches()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_call = (launches() - launched) / calls
    events = [e for e in prof.key_averages() if match in e.key]
    device_us = sum(getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0) for e in events)
    recorded = sum(e.count for e in events)
    return {"device_ms": device_us / max(recorded, 1) * per_call / 1e3,
            "host_us": host_us, "kernel_events": recorded,
            "launches": per_call * calls}
