"""Debug utilities — the port of radx_tpu/utils/debug.py.

  * ``interpret_parity`` — run a pipeline twice, on the card (the
    hand-written CUDA kernels) and on the CPU (each kernel wrapper's plain
    PyTorch version, the port's counterpart of Pallas interpret mode), and
    compare the outputs bit for bit.  A mismatch isolates a kernel from
    the arithmetic it is meant to do: a race, a wrong load map, a tile
    edge.
  * ``checked`` — wrap a function so that an asynchronous kernel fault
    raises at its call, and a NaN it introduced raises
    ``FloatingPointError``.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(x):
    if isinstance(x, (tuple, list)):
        for y in x:
            yield from _leaves(y)
    else:
        yield x


def _to(x, device):
    """``x`` with every tensor or numpy array (nested in tuples / lists)
    copied to ``device``."""
    if isinstance(x, (tuple, list)):
        return type(x)(_to(y, device) for y in x)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def _int64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.uint32:  # numpy reads it; torch casts few ops
            return x.numpy().astype(np.int64)
        return x.to(torch.int64).numpy()
    return np.asarray(x).astype(np.int64)


def interpret_parity(build_fn, *args, atol=0, device=None):
    """``build_fn(interpret: bool) -> callable``: ``build_fn(False)`` runs
    on ``device`` (default CUDA: the kernels), ``build_fn(True)`` on CPU
    copies of the inputs (the plain versions).  Every output leaf of a
    nested tuple / list is compared as int64.  Returns ``(ok,
    max_abs_diff)``, ``ok`` when the difference is at most ``atol``.
    Raises without CUDA unless ``device`` says otherwise: the parity of a
    kernel is taken on the card, never against itself by default."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("interpret_parity runs the kernels on a CUDA "
                               "device; none is available (pass device=)")
        device = torch.device("cuda", torch.cuda.current_device())
    a = build_fn(False)(*_to(args, torch.device(device)))
    b = build_fn(True)(*_to(args, torch.device("cpu")))
    leaves_a, leaves_b = list(_leaves(a)), list(_leaves(b))
    if len(leaves_a) != len(leaves_b):
        raise ValueError("the two runs return different structures")
    worst = 0
    for x, y in zip(leaves_a, leaves_b):
        x, y = _int64(x), _int64(y)
        if x.shape != y.shape:
            raise ValueError(f"output shapes differ: {x.shape} and {y.shape}")
        if x.size:
            worst = max(worst, int(np.max(np.abs(x - y))))
    return worst <= atol, worst


def _has_nan(leaves) -> bool:
    for t in leaves:
        if isinstance(t, np.ndarray) and t.dtype.kind == "f":
            t = torch.from_numpy(t)
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and bool(torch.isnan(t).any())):
            return True
    return False


def checked(fn):
    """Wrap ``fn`` so that errors surface at its call.

    Where the JAX ``checked`` runs ``fn`` under ``checkify`` (user checks,
    NaNs and out-of-bounds indices inside ``jit``), this one checks at the
    function's boundary: after ``fn`` it synchronises the card (a kernel
    fault, such as an illegal address, then raises here and not at a later
    call), and raises ``FloatingPointError`` when a floating output holds a
    NaN while no floating input held one.  It does not see inside ``fn``:
    a NaN made and dropped there, or an index that stays in bounds but is
    wrong, passes; each kernel wrapper validates its own arguments."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if _has_nan(_leaves(out)) and not _has_nan(
                _leaves((args, tuple(kwargs.values())))):
            raise FloatingPointError(f"{getattr(fn, '__name__', fn)} "
                                     "returned a NaN that no input held")
        return out

    return wrapper
