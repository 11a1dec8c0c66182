"""Single-device sort API over uint32 keys — port of radx_tpu/ops/sort.py
(keys-only path).

It owns buffer preparation — the sign bias that maps unsigned order onto
signed int32 order, and the sentinel pads up to a power of two — and
dispatches to a strategy:

  * ``"bitonic"`` (default) — the hand-written CUDA bitonic network
    (kernels/bitonic.py);
  * ``"lax"`` — ``torch.sort``, the counterpart of the JAX package's
    ``jax.lax.sort`` fallback.

Keys are uint32 tensors, or numpy arrays with an explicit ``device``.  A
tensor is sorted on the device it lies on and the result stays there.  Inside,
everything is sign-biased int32: PyTorch has no uint32 comparisons on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import bitonic

_SIGN = -(1 << 31)  # int32 bit pattern 0x80000000
_PAD_KEY = 0x7FFFFFFF  # sign-biased 0xFFFFFFFF: sorts to the end


def _as_tensor(keys, device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        want = torch.device(device) if device is not None else keys.device
        if want.type != keys.device.type or want.index not in (
            None, keys.device.index
        ):
            raise ValueError(
                f"keys lie on {keys.device}, not on the requested {device}"
            )
        return keys
    if isinstance(keys, np.ndarray):
        if device is None:
            raise ValueError("a numpy input needs an explicit device=")
        return torch.from_numpy(np.ascontiguousarray(keys)).to(device)
    raise TypeError(f"keys must be a torch.Tensor or numpy array, got {type(keys)}")


def _as_u32(keys, device=None) -> torch.Tensor:
    keys = _as_tensor(keys, device)
    if keys.dtype != torch.uint32:
        raise TypeError(f"keys must be uint32, got {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    return keys


def _pad_len(n: int, min_total: int = 1024) -> int:
    total = max(min_total, n)
    return 1 << (total - 1).bit_length()


def _key_plane(keys: torch.Tensor, total: int) -> torch.Tensor:
    """uint32 keys -> a new sign-biased int32 buffer of ``total`` keys."""
    plane = torch.full((total,), _PAD_KEY, dtype=torch.int32, device=keys.device)
    plane[: keys.numel()] = keys.view(torch.int32) ^ _SIGN
    return plane


def _unbias(plane: torch.Tensor, n: int) -> torch.Tensor:
    return (plane[:n] ^ _SIGN).view(torch.uint32)


def _engine(plane: torch.Tensor, cfg: SortConfig) -> torch.Tensor:
    """Sort the int32 buffer in place with the bitonic network."""
    return bitonic.sort_planes(plane, cfg.chunk_elems, cfg.finish_elems)


def _sort_keys(keys: torch.Tensor, cfg: SortConfig, n: int) -> torch.Tensor:
    plane = _key_plane(keys, _pad_len(n))
    if cfg.strategy == "lax":
        plane = torch.sort(plane).values
    else:
        _engine(plane, cfg)
    return _unbias(plane, n)


def _sort_rider(keys: torch.Tensor, payload: torch.Tensor, cfg: SortConfig,
                n: int, neutral: int):
    """Unstable (key, rider) sort over the whole padded array — the port of
    ``_sort_rider_jit`` (radx_tpu/ops/sort.py:145-176): two planes, one
    compare, for commutative consumers (aggregation) that need grouping but
    not stability.

    ``keys`` are uint32, ``payload`` int32 bit patterns of the same length.
    Pads carry key 0xFFFFFFFF and the rider ``neutral`` (an int32 bit
    pattern): they sort into the real 0xFFFFFFFF group, if there is one, so
    the consumer's neutral element keeps that group's aggregate exact.  All
    ``_pad_len(n)`` rows are real rows here.  Returns the full padded
    (uint32 keys, int32 riders); tied keys' riders come in no set order."""
    total = _pad_len(n)
    kp = _key_plane(keys, total)
    pp = torch.full((total,), neutral, dtype=torch.int32, device=keys.device)
    pp[:n] = payload
    if cfg.strategy == "lax":
        kp, order = torch.sort(kp)
        pp = pp[order]
    else:
        bitonic.sort_planes(kp, cfg.rider_chunk_elems, cfg.rider_finish_elems,
                            rider=pp)
    return _unbias(kp, total), pp


def _decompose_blocks(n: int, block_elems: int):
    """Binary piece decomposition for arbitrary N: blocks = ceil(n/C)
    rounded up to at most 5 significant bits (pad overhead <= 1/16 + C/n),
    so the piece count is <= 5.  Returns (blocks, piece block counts,
    largest first)."""
    blocks = -(-n // block_elems)
    t = blocks.bit_length()
    if t > 5:
        g = 1 << (t - 5)
        blocks = -(-blocks // g) * g
        t = blocks.bit_length()
    sizes = [1 << b for b in range(t) if (blocks >> b) & 1]
    return blocks, sizes[::-1]


def _sort_arbn_keys(keys: torch.Tensor, cfg: SortConfig, n: int) -> torch.Tensor:
    """Arbitrary-N sort without pow2 padding blowup.  Pieces of pow2 size
    (binary decomposition of ceil(n/C), <= 5 pieces) are sorted in place —
    all but the last descending (every direction bit flipped) — then folded
    smallest-first through valley merges on virtual-tail bitonic networks
    (kernels/bitonic.merge_valley_ascending).  Total pad <= n/32 + C.

    The pieces lie back to back in one buffer, so each fold's valley
    (descending piece ++ ascending merged suffix) is a suffix of it: every
    step works in place."""
    c = cfg.chunk_elems
    blocks, sizes = _decompose_blocks(n, c)
    plane = _key_plane(keys, blocks * c)
    offsets = []
    off = 0
    for idx, sz in enumerate(sizes):
        piece = plane[off: off + sz * c]
        if idx == len(sizes) - 1:
            _engine(piece, cfg)
        else:
            # sentinel pads that spill into these pieces are just large
            # keys: the valley merges push them to the global tail
            bitonic.sort_planes(piece, c, cfg.finish_elems, descending=True)
        offsets.append(off)
        off += sz * c
    for off in reversed(offsets[:-1]):
        bitonic.merge_valley_ascending(plane[off:], c, cfg.finish_elems)
    return _unbias(plane, n)


def _use_decomposition(n: int, cfg: SortConfig) -> bool:
    """Route to the piece-merge path when pow2 padding would waste >10%
    and the size is large enough for the extra passes to pay off."""
    if cfg.strategy == "lax" or n < (1 << 22):
        return False
    return _pad_len(n) * 10 > n * 11


def sort(keys, cfg: SortConfig | None = None, *, device=None) -> torch.Tensor:
    """Ascending sort of uint32 keys; returns a uint32 tensor on their device.

    Any N is supported: pow2-adjacent sizes pad to the next pow2; sizes
    where that would waste >10% route through the binary-decomposition +
    valley-merge path (pad bounded at ~3%)."""
    cfg = cfg or DEFAULT
    keys = _as_u32(keys, device)
    n = keys.numel()
    if n <= 1:
        return keys.clone()
    if _use_decomposition(n, cfg):
        return _sort_arbn_keys(keys, cfg, n)
    return _sort_keys(keys, cfg, n)


_KEY_DTYPES = (torch.uint32, torch.int32, torch.float32)


def _encode_keys(keys: torch.Tensor) -> torch.Tensor:
    """Order-preserving uint32 encoding: uint32 identity; int32 flips the
    sign bit; float32 maps sign-magnitude to lexicographic (non-negative ->
    set the sign bit, negative -> complement) — the total order
    -inf < ... < -0.0 < +0.0 < ... < +inf < nan."""
    if keys.dtype == torch.uint32:
        return keys
    bits = keys.view(torch.int32)
    if keys.dtype == torch.int32:
        return (bits ^ _SIGN).view(torch.uint32)
    return torch.where(bits < 0, ~bits, bits | _SIGN).view(torch.uint32)


def _decode_keys(enc: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return enc
    bits = enc.view(torch.int32)
    if dtype == torch.int32:
        return bits ^ _SIGN
    return torch.where(bits < 0, bits ^ _SIGN, ~bits).view(torch.float32)


def _flip(enc: torch.Tensor) -> torch.Tensor:
    """Bit-not of uint32 keys (reverses their order)."""
    return (~enc.view(torch.int32)).view(torch.uint32)


def sort_any(keys, descending: bool = False, cfg: SortConfig | None = None,
             *, device=None) -> torch.Tensor:
    """Sort uint32 / int32 / float32 keys, ascending or descending, through
    order-preserving uint32 encodings over ``sort``.  Returns a tensor of the
    keys' dtype on their device.  (64-bit keys wait for the two-plane
    ``sort_u64``.)"""
    keys = _as_tensor(keys, device)
    if keys.dtype not in _KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    enc = _encode_keys(keys)
    if descending:
        enc = _flip(enc)
    out = sort(enc, cfg)
    if descending:
        out = _flip(out)
    return _decode_keys(out, keys.dtype)
