"""Failure detection around device steps — port of radx_tpu/utils/guard.py.

A peer that dies inside a collective leaves every other rank waiting, and a
CUDA stream cannot be cancelled.  So the contract is detect and relaunch:

  * ``watchdog`` runs a step on a worker thread, waits for its CUDA work to
    finish, and raises ``DeviceTimeout`` when the deadline passes (the
    thread is abandoned; the caller tears the process group down or
    restarts the process);
  * ``retry_deterministic`` runs a stateless step under the watchdog and
    runs it again, up to ``retries`` times, after a ``DeviceTimeout`` or a
    ``torch.distributed.DistError`` (a collective or a peer failed).  Every
    operator of the engine is a pure function of its inputs, so a retry
    gives the same bits.  A plain programming error is never retried.
"""

from __future__ import annotations

import threading
import time

import torch


class DeviceTimeout(RuntimeError):
    """A device step (usually a collective) missed its deadline."""


def _cuda_devices(out, found=None) -> set:
    """The CUDA devices of the tensors in a (nested) step result."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, found)
    return found


def watchdog(fn, *args, timeout_s: float = 120.0):
    """Run ``fn(*args)`` and wait until its CUDA work has finished; raise
    ``DeviceTimeout`` after ``timeout_s`` seconds.

    Both the call and the wait run on a daemon thread, so a step that hangs
    while it enqueues (a collective waiting for a peer) cannot hold the
    caller.  The current CUDA device is per thread: the worker takes the
    caller's before it runs the step, and synchronises every CUDA device
    the result lies on (and the caller's)."""
    device = torch.cuda.current_device() if torch.cuda.is_initialized() else None
    done = threading.Event()
    err: list[BaseException] = []
    res: list = []

    def work():
        try:
            if device is not None:
                torch.cuda.set_device(device)
            out = fn(*args)
            devices = _cuda_devices(out)
            if device is not None:
                devices.add(torch.device("cuda", device))
            for d in devices:
                torch.cuda.synchronize(d)
            res.append(out)
        except BaseException as e:  # raised again on the caller's thread
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=work, daemon=True).start()
    if not done.wait(timeout_s):
        raise DeviceTimeout(
            f"device step exceeded {timeout_s:.1f}s deadline — a peer or "
            "collective is likely hung; relaunch from host inputs")
    if err:
        raise err[0]
    return res[0]


def _retryable() -> tuple:
    import torch.distributed as dist

    return (DeviceTimeout, *((dist.DistError,) if dist.is_available() else ()))


def retry_deterministic(fn, *args, retries: int = 2, timeout_s: float = 120.0,
                        on_retry=None):
    """Run a stateless step under the watchdog, again up to ``retries``
    more times after a ``DeviceTimeout`` or a ``torch.distributed.DistError``.

    ``on_retry(attempt, exc)`` runs before each new attempt.  After a
    timeout of a hung collective it must rebuild the process group (or the
    process): the hung work cannot be cancelled, and a bare retry would
    queue behind it.  Without such an ``on_retry`` the helper is sound for
    transient failures only."""
    retryable = _retryable()
    attempt = 0
    while True:
        try:
            return watchdog(fn, *args, timeout_s=timeout_s)
        except retryable as e:
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(min(0.1 * attempt, 1.0))
