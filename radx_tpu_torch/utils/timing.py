"""Timing on the card with CUDA events — counterpart of radx_tpu/utils/timing.py.

PyTorch returns before the device finishes, so a host clock without a
synchronise measures only the enqueue.  ``time_cuda`` records a CUDA event
before and after ``iters`` back-to-back calls on the current stream, waits
for the second, and divides; it repeats that ``repeats`` times after a
warm-up and reports the least per-call time with the spread of the repeats.
A repeat that reads zero or less is dropped, never clamped to a tiny
positive time that would report an absurd rate.  With no CUDA device every
function here raises: a measurement never falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
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
