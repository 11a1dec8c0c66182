"""The port's failure guard (radx_tpu_torch/utils/guard.py): the six
behaviours of tests/test_guard.py with torch steps, and what is not
retried."""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from radx_tpu_torch.parallel import Mesh, dist_sort, multihost
from radx_tpu_torch.utils import guard

torch.set_num_threads(1)


def test_watchdog_passes_fast_step():
    out = guard.watchdog(lambda x: x * 2, torch.arange(8), timeout_s=30.0)
    assert torch.equal(out, torch.arange(8) * 2)


def test_watchdog_times_out_on_hung_step():
    def slow(x):
        time.sleep(1.5)
        return x

    with pytest.raises(guard.DeviceTimeout, match="deadline"):
        guard.watchdog(slow, torch.arange(4), timeout_s=0.2)


def test_watchdog_reraises_step_errors():
    def bad(x):
        raise RuntimeError("injected fault")

    with pytest.raises(RuntimeError, match="injected fault"):
        guard.watchdog(bad, torch.arange(4), timeout_s=30.0)


def test_retry_deterministic_recovers_and_is_exact():
    calls = []

    def flaky(x):
        # the first attempt hangs past the deadline, the relaunch returns
        # the same bits (a stateless step)
        calls.append(None)
        if len(calls) == 1:
            time.sleep(1.5)
        return torch.sort(x).values

    keys = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2**31, 256, dtype=np.int64).astype(np.int32))
    seen = []
    out = guard.retry_deterministic(
        flaky, keys, retries=2, timeout_s=0.4,
        on_retry=lambda a, e: seen.append((a, type(e).__name__)))
    assert seen and seen[0][1] == "DeviceTimeout"
    assert torch.equal(out, torch.sort(keys).values)


def test_guarded_entry_detects_and_recovers(monkeypatch):
    """Fault injection through sort_sharded_guarded: the first dispatch
    dies with a torch.distributed.DistError (a failed collective), the
    guard catches it, on_retry sees it, and the relaunch is exact."""
    real = dist_sort.sort_sharded
    calls = []

    def dies_once(keys, mesh, **kw):
        calls.append(None)
        if len(calls) == 1:
            raise dist.DistError("injected transient fault")
        return real(keys, mesh, **kw)

    monkeypatch.setattr(dist_sort, "sort_sharded", dies_once)
    mesh = Mesh([torch.device("cpu")] * 2)
    keys = np.random.default_rng(7).integers(0, 2**32, 2048, dtype=np.uint32)
    seen = []
    out, valid, overflow = multihost.sort_sharded_guarded(
        keys, mesh, capacity=4, timeout_s=600.0, retries=2,
        on_retry=lambda a, e: seen.append(type(e).__name__))
    assert seen == ["DistError"] and len(calls) == 2
    assert not overflow.any()
    np.testing.assert_array_equal(dist_sort.collect(out, valid), np.sort(keys))


def test_retry_gives_up_after_budget():
    def always_slow(x):
        time.sleep(1.0)
        return x

    with pytest.raises(guard.DeviceTimeout):
        guard.retry_deterministic(always_slow, torch.arange(4), retries=1,
                                  timeout_s=0.2)


def test_programming_errors_are_not_retried():
    calls = []

    def wrong(x):
        calls.append(None)
        raise ValueError("a bug, not a fault")

    with pytest.raises(ValueError):
        guard.retry_deterministic(wrong, torch.arange(4), retries=3,
                                  timeout_s=30.0)
    assert len(calls) == 1
