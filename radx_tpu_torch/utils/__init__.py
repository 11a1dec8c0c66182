"""Utilities: CUDA-event timing, metrics and profiler traces (timing.py);
the watchdog and deterministic retry around device steps (guard.py)."""

from radx_tpu_torch.utils.timing import Metrics, time_op  # noqa: F401
