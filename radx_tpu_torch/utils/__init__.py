"""Utilities: CUDA-event timing, metrics and profiler traces (timing.py);
the watchdog and deterministic retry around device steps (guard.py); the
card-against-CPU parity and the checked call (debug.py)."""

from radx_tpu_torch.utils.timing import Metrics, time_op  # noqa: F401
from radx_tpu_torch.utils.guard import (  # noqa: F401
    DeviceTimeout,
    retry_deterministic,
    watchdog,
)
