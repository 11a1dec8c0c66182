"""ctypes binding to the host runtime (``csrc/host/runtime.cc``) — the port
of radx_tpu/runtime/native.py.

Multithreaded generation and validation at memory speed, so that host
arrays of 2^26 to 2^30 keys are not bound by NumPy.  The library is built
with g++ at first use into ``radx_tpu_torch/_build/``
(``kernels/_build.load_host``); a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from radx_tpu_torch.kernels import _build

SOURCE = _build.CSRC / "host" / "runtime.cc"
_U32P = ctypes.POINTER(ctypes.c_uint32)
_SIZE, _U64 = ctypes.c_size_t, ctypes.c_uint64
_SIGNATURES = {
    # out, n, seed
    "radx_rt_gen_uniform": ([_U32P, _SIZE, _U64], None),
    "radx_rt_gen_permutation": ([_U32P, _SIZE, _U64], None),
    # out, n, seed, hot_lo, hot_hi, hot_frac
    "radx_rt_gen_skewed": ([_U32P, _SIZE, _U64, ctypes.c_uint32,
                            ctypes.c_uint32, ctypes.c_double], None),
    # orig, sorted, n
    "radx_rt_validate_sort": ([_U32P, _U32P, _SIZE], ctypes.c_int),
}


def load() -> ctypes.CDLL:
    """The runtime library, built on first use and bound once."""
    return _build.load_host(SOURCE, _SIGNATURES)


def _p(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


def gen_uniform(n: int, seed: int = 0) -> np.ndarray:
    """n uniform uint32 keys (splitmix64, each thread's chunk seeded by its
    start: deterministic in ``seed`` for a given thread count)."""
    out = np.empty(n, np.uint32)
    load().radx_rt_gen_uniform(_p(out), n, seed)
    return out


def gen_permutation(n: int, seed: int = 0) -> np.ndarray:
    """A shuffled 0 .. n-1 (RadX's test fixture; one serial Fisher-Yates
    pass of ``std::mt19937_64``)."""
    out = np.empty(n, np.uint32)
    load().radx_rt_gen_permutation(_p(out), n, seed)
    return out


def gen_skewed(n: int, seed: int = 0, hot_lo: int = 0x12340000,
               hot_hi: int = 0x1234FFFF, hot_frac: float = 0.8) -> np.ndarray:
    """n keys, ``hot_frac`` of them uniform in [hot_lo, hot_hi], the rest
    uniform uint32 (digit skew for the splitters)."""
    out = np.empty(n, np.uint32)
    load().radx_rt_gen_skewed(_p(out), n, seed, hot_lo, hot_hi, hot_frac)
    return out


def validate_sort(orig, sorted_arr) -> int:
    """0: ``sorted_arr`` is ascending and a permutation of ``orig``; 1: not
    ascending; 2: not the same multiset (16-bit marginal counts and
    checksums: a strong check, not a proof; the bit-exact gate is the
    comparison with the oracle's sort)."""
    orig = np.ascontiguousarray(orig, np.uint32)
    sorted_arr = np.ascontiguousarray(sorted_arr, np.uint32)
    if orig.shape != sorted_arr.shape:
        return 2
    return load().radx_rt_validate_sort(_p(orig), _p(sorted_arr), orig.size)
