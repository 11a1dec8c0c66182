"""ctypes binding to the C++ oracle (``csrc/host/oracle.cc``) — the port of
radx_tpu/oracle/native.py.

The library is built with g++ at first use into ``radx_tpu_torch/_build/``,
named by a hash of the source (``kernels/_build.load_host``); a missing
compiler or a failed build raises.  Digit width and tile are plain
arguments, with ``oracle.cpu``'s defaults.
"""

from __future__ import annotations

import ctypes

import numpy as np

from radx_tpu_torch.kernels import _build
from radx_tpu_torch.oracle.cpu import BITS_PER_PASS, TILE_ELEMS, _check

SOURCE = _build.CSRC / "host" / "oracle.cc"
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U32, _SIZE = ctypes.c_uint32, ctypes.c_size_t
_SIGNATURES = {
    # keys, out, n, bits_per_pass, tile_elems
    "radx_oracle_sort_u32": ([_U32P, _U32P, _SIZE, _U32, _U32], None),
    # keys, payload, out keys, out payload, n, bits_per_pass, tile_elems
    "radx_oracle_sort_pairs": ([_U32P, _U32P, _U32P, _U32P, _SIZE, _U32,
                                _U32], None),
    # keys, out, n, shift, bits_per_pass, tile_elems, counts
    "radx_oracle_radix_pass": ([_U32P, _U32P, _SIZE, _U32, _U32, _U32,
                                ctypes.POINTER(ctypes.c_int64)], None),
}


def load() -> ctypes.CDLL:
    """The oracle library, built on first use and bound once."""
    return _build.load_host(SOURCE, _SIGNATURES)


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


def _u32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim != 1 or a.dtype.itemsize != 4:
        raise TypeError("the oracle takes 1-D arrays of 32-bit values")
    return np.ascontiguousarray(a.view(np.uint32))


def sort_u32(keys, *, bits_per_pass: int = BITS_PER_PASS,
             tile_elems: int = TILE_ELEMS) -> np.ndarray:
    _check(bits_per_pass, tile_elems)
    lib = load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    out = np.empty_like(keys)
    lib.radx_oracle_sort_u32(_u32p(keys), _u32p(out), keys.size,
                             bits_per_pass, tile_elems)
    return out


def sort_pairs(keys, payload, *, bits_per_pass: int = BITS_PER_PASS,
               tile_elems: int = TILE_ELEMS):
    """Stable key + payload sort; the payload's 32-bit patterns move with
    their keys and come back as uint32."""
    _check(bits_per_pass, tile_elems)
    lib = load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    payload = _u32(payload)
    if payload.shape != keys.shape:
        raise ValueError("keys and payload must have the same length")
    out_k = np.empty_like(keys)
    out_p = np.empty_like(payload)
    lib.radx_oracle_sort_pairs(_u32p(keys), _u32p(payload), _u32p(out_k),
                               _u32p(out_p), keys.size, bits_per_pass,
                               tile_elems)
    return out_k, out_p


def radix_pass(keys, shift: int, *, bits_per_pass: int = BITS_PER_PASS,
               tile_elems: int = TILE_ELEMS):
    """One pass: (keys out, the per-tile histogram, tiles x radix int64)."""
    _check(bits_per_pass, tile_elems)
    lib = load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    out = np.empty_like(keys)
    ntiles = -(-keys.size // tile_elems)
    counts = np.empty((ntiles, 1 << bits_per_pass), dtype=np.int64)
    lib.radx_oracle_radix_pass(
        _u32p(keys), _u32p(out), keys.size, shift, bits_per_pass, tile_elems,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, counts
