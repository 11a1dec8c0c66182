"""Single-device sort API over uint32 keys — port of radx_tpu/ops/sort.py.

It owns buffer preparation — the sign bias that maps unsigned order onto
signed int32 order, the sentinel pads up to a power of two (or, for large
ragged sizes, to the whole pieces of the arbitrary-N paths), the index plane
that makes a sort stable — and dispatches to a strategy:

  * ``"bitonic"`` (default) — the hand-written CUDA bitonic network
    (kernels/bitonic.py): keys only, (key, rider), or lexicographic over
    (key, index) with payload planes riding along;
  * ``"radix"`` — the radix distribution sort (kernels/radix_sort.py)
    where its plan applies, the network where it does not or where a bucket
    overflows its slots;
  * ``"lax"`` — ``torch.sort`` (``stable=True`` where the JAX package calls
    ``jax.lax.sort(num_keys=2)`` over (key, index)), the counterpart of the
    JAX package's ``jax.lax.sort`` fallback.

The sorts that the JAX package sends through its ``_engine`` go through
``_engine`` here: ``sort``, ``argsort``, ``sort_pairs``, ``sort_u64``,
``sort_multi``, the last piece of the arbitrary-N paths, and (from other
modules) ``unique``, ``groupby``'s rider sort and ``join_inner``.  The rest
stay on the network under every strategy, as in the JAX package:
``LazyTable``, ``join_merge``, ``top_k`` and the descending arbitrary-N
pieces (``_lex_sort`` and ``bitonic`` directly).

Entry points: ``sort``, ``sort_any`` (uint32 / int32 / float32 tensors, and
uint64 / int64 / float64 numpy arrays), ``argsort``, ``sort_pairs`` (stable,
or ``assume_unique``), ``sort_pairs_any``, ``sort_multi`` and ``sort_u64``.
Keys are tensors, or numpy arrays, which go to ``device`` (by default the
CUDA device: without a card, torch's own error).  A tensor is sorted on the
device it lies on and the result stays there.  Inside, everything is
sign-biased int32: PyTorch has no uint32 comparisons on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import bitonic, radix_sort

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
        return torch.from_numpy(np.ascontiguousarray(keys)).to(
            torch.device("cuda") if device is None else device)
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


def _lex_groups(planes):
    """Plane lists of at most 8 planes that sort ``planes`` (2 compare
    planes, any number riding) lexicographically: each carries the next
    payloads behind copies of the two compare planes, the last the compare
    planes themselves.  The order is total, so every sort gives the same
    permutation."""
    head, rest = planes[:2], planes[2:]
    step = bitonic.MAX_PLANES - 2
    groups = [rest[i: i + step] for i in range(0, len(rest), step)] or [[]]
    for i, group in enumerate(groups):
        cmp = head if i == len(groups) - 1 else [p.clone() for p in head]
        yield [*cmp, *group]


def _engine(planes, cfg: SortConfig, num_cmp: int, n_valid: int):
    """Sort int32 planes in place by plane 0 (then plane 1 when num_cmp is
    2; the rest ride along) — the port of radx_tpu/ops/sort.py::_engine.

    Under ``"radix"``, where ``radix_sort.plan`` applies, the distribution
    sort runs; it reads its overflow flag on the host once and, when it is
    set, leaves the planes untouched, and the network sorts them.  Rows past
    ``n_valid`` are sentinel pads.  The network runs on the mode's tiles.
    (The JAX ``unique`` flag has no counterpart: every exchange here is
    tie-safe.)"""
    if num_cmp == 2 and len(planes) > bitonic.MAX_PLANES:
        for group in _lex_groups(planes):
            _engine(group, cfg, 2, n_valid)
        return planes
    chunk, fin = cfg.mode_tiles(len(planes), num_cmp)
    if cfg.strategy == "radix":
        total = planes[0].numel()
        r_chunk = radix_sort.pick_chunk(total, chunk)
        if radix_sort.plan(total, r_chunk) is not None:
            _, overflow = radix_sort.sort_radix(planes, r_chunk, num_cmp, cfg,
                                                n_valid)
            if not overflow:
                return planes
    k, rider, lex = bitonic._keywords(planes, num_cmp)
    bitonic.sort_planes(k, chunk, fin, rider=rider, lex=lex)
    return planes


def _sort_keys(keys: torch.Tensor, cfg: SortConfig, n: int) -> torch.Tensor:
    plane = _key_plane(keys, _pad_len(n))
    if cfg.strategy == "lax":
        plane = torch.sort(plane).values
    else:
        _engine([plane], cfg, 1, n)
    return _unbias(plane, n)


def _rider_planes(keys: torch.Tensor, payload: torch.Tensor, total: int,
                  neutral: int):
    """(sign-biased key plane, rider plane) of ``total`` rows: rows past the
    keys hold key 0xFFFFFFFF and the rider ``neutral``."""
    pp = torch.full((total,), neutral, dtype=torch.int32, device=keys.device)
    pp[: payload.numel()] = payload
    return _key_plane(keys, total), pp


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
    padded rows are real rows here (n_valid = total), so no pad rider is
    overwritten with a fill.  The padded length is ``_pad_len(n)``, or
    ``blocks * chunk`` where ``_use_decomposition`` routes to
    ``_sort_rider_arbn`` (the JAX package always pads to a power of two).
    Returns the full padded (uint32 keys, int32 riders); tied keys' riders
    come in no set order."""
    if _use_decomposition(n, cfg):
        return _sort_rider_arbn(keys, payload, cfg, n, neutral)
    total = _pad_len(n)
    kp, pp = _rider_planes(keys, payload, total, neutral)
    if cfg.strategy == "lax":
        kp, order = torch.sort(kp)
        pp = pp[order]
    else:
        _engine([kp, pp], cfg, 1, total)
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


def _sort_pieces(planes, sizes, chunk: int, fin: int, cfg: SortConfig,
                 num_cmp: int):
    """The arbitrary-N scheme, in place on ``planes`` (any mode): pieces of
    ``sizes`` blocks of ``chunk`` rows each (largest first) lie back to back;
    all but the last sort descending (every direction bit flipped) on the
    network, the last through ``_engine`` (the distribution sort under
    ``"radix"`` where it plans); then they fold smallest-first through
    valley merges on virtual-tail bitonic networks
    (kernels/bitonic.merge_valley_ascending).  Each fold's valley
    (descending piece ++ ascending merged suffix) is a suffix of the
    buffer, so every step works in place.  Sentinel pads that spill into
    the descending pieces are just large keys: the merges push them to the
    tail."""
    offsets, off = [], 0
    for sz in sizes:
        offsets.append(off)
        off += sz * chunk
    *heads, last = [[p[o: o + sz * chunk] for p in planes]
                    for o, sz in zip(offsets, sizes)]
    for piece in heads:
        k, rider, lex = bitonic._keywords(piece, num_cmp)
        bitonic.sort_planes(k, chunk, fin, True, rider=rider, lex=lex)
    _engine(last, cfg, num_cmp, last[0].numel())
    for o in reversed(offsets[:-1]):
        k, rider, lex = bitonic._keywords([p[o:] for p in planes], num_cmp)
        bitonic.merge_valley_ascending(k, chunk, fin, rider=rider, lex=lex)
    return planes


def _sort_arbn_keys(keys: torch.Tensor, cfg: SortConfig, n: int) -> torch.Tensor:
    """Arbitrary-N sort without pow2 padding blowup: pieces of pow2 size
    (binary decomposition of ceil(n/C), <= 5 pieces) through
    ``_sort_pieces``.  Total pad <= n/32 + C."""
    c = cfg.chunk_elems
    blocks, sizes = _decompose_blocks(n, c)
    plane = _key_plane(keys, blocks * c)
    _sort_pieces([plane], sizes, c, cfg.finish_elems, cfg, 1)
    return _unbias(plane, n)


def _sort_rider_arbn(keys: torch.Tensor, payload: torch.Tensor,
                     cfg: SortConfig, n: int, neutral: int):
    """Arbitrary-N (key, rider) sort: ``_sort_pieces`` on the two planes of
    ``_sort_rider``, on the rider tiles.  The pads past n (at most n/32 + C
    of them) are real rows, as there.  Every exchange, the valley merge's
    overhang included, swaps the two planes only where the keys are
    strictly out of order, so no rider leaves its key.  Returns the full
    (uint32 keys, int32 riders) of ``blocks * chunk`` rows."""
    chunk, fin = cfg.mode_tiles(2, 1)
    blocks, sizes = _decompose_blocks(n, chunk)
    total = blocks * chunk
    kp, pp = _rider_planes(keys, payload, total, neutral)
    _sort_pieces([kp, pp], sizes, chunk, fin, cfg, 1)
    return _unbias(kp, total), pp


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


_NP64 = (np.dtype(np.uint64), np.dtype(np.int64), np.dtype(np.float64))


def _numpy64(keys):
    """``keys`` as a 1-D numpy array when it is a uint64 / int64 / float64
    numpy array (the 64-bit branches), else None."""
    if isinstance(keys, np.ndarray) and keys.dtype in _NP64:
        if keys.ndim != 1:
            raise ValueError("keys must be 1-D")
        return keys
    return None


def sort_any(keys, descending: bool = False, cfg: SortConfig | None = None,
             *, device=None):
    """Sort uint32 / int32 / float32 keys, ascending or descending, through
    order-preserving uint32 encodings over ``sort``: returns a tensor of the
    keys' dtype on their device.  uint64 / int64 / float64 numpy keys (as in
    the JAX package) split into (hi, lo) uint32 halves sorted by the
    lexicographic ``sort_u64`` on ``device``: returns a numpy array."""
    np64 = _numpy64(keys)
    if np64 is not None:
        return _sort_any64(np64, descending, cfg, device)
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


# --- stable and lexicographic sorts (radx_tpu/ops/sort.py:110-141, 248-301,
# 329-621) ---------------------------------------------------------------------


def _iota(total: int, device) -> torch.Tensor:
    return torch.arange(total, dtype=torch.int32, device=device)


def _payload_plane(p: torch.Tensor, total: int) -> torch.Tensor:
    """32-bit payload -> a new int32 bit plane of ``total`` rows, zero pads."""
    plane = torch.zeros(total, dtype=torch.int32, device=p.device)
    plane[: p.numel()] = p.contiguous().view(torch.int32)
    return plane


def _lex_sort(planes, cfg: SortConfig, descending: bool = False) -> None:
    """Sort int32 planes in place by (planes[0], planes[1]), the rest riding
    along, on the bitonic network's lexicographic mode under every strategy
    (the callers the JAX package keeps off its engine); more than 8 planes
    run as several sorts (``_lex_groups``)."""
    for group in _lex_groups(planes):
        chunk, fin = cfg.lex_tiles(len(group))
        bitonic.sort_planes(group[0], chunk, fin, descending, lex=group[1:])


def _stable_planes(keys: torch.Tensor, payloads, cfg: SortConfig, total: int):
    """(key, index, payloads...) planes of ``total`` rows, sorted stably by
    key: ``torch.sort(stable=True)`` under ``"lax"``, else the engine."""
    planes = [_key_plane(keys, total), _iota(total, keys.device),
              *(_payload_plane(p, total) for p in payloads)]
    if cfg.strategy == "lax":
        order = torch.sort(planes[0], stable=True).indices
        return [p[order] for p in planes]
    _engine(planes, cfg, 2, keys.numel())
    return planes


def _sort_arbn_stable(keys: torch.Tensor, payloads, cfg: SortConfig, n: int):
    """Arbitrary-N stable sort (port of ``_sort_arbn_stable_jit``):
    ``_sort_pieces`` on (key, index, payloads) planes.  (key, original
    index) is a total order, so the result is the unique stable permutation
    however the input was cut.  Returns the sorted planes (``blocks *
    chunk`` rows)."""
    chunk, fin = cfg.lex_tiles(2 + len(payloads))
    blocks, sizes = _decompose_blocks(n, chunk)
    total = blocks * chunk
    planes = [_key_plane(keys, total), _iota(total, keys.device),
              *(_payload_plane(p, total) for p in payloads)]
    if len(planes) > bitonic.MAX_PLANES:
        raise ValueError(f"the arbitrary-N path takes at most "
                         f"{bitonic.MAX_PLANES - 2} payloads")
    return _sort_pieces(planes, sizes, chunk, fin, cfg, 2)


def _stable(keys: torch.Tensor, payloads, cfg: SortConfig, n: int):
    """Stably sorted (key, index, payloads...) planes of the n keys, by the
    arbitrary-N path where ``_use_decomposition`` routes there (at most one
    payload, as in the JAX package), else padded to a power of two."""
    if len(payloads) <= 1 and _use_decomposition(n, cfg):
        return _sort_arbn_stable(keys, payloads, cfg, n)
    return _stable_planes(keys, payloads, cfg, _pad_len(n))


def _check_payload(p: torch.Tensor, keys: torch.Tensor, what="payload"):
    if p.shape != keys.shape:
        raise ValueError(f"{what} must match keys shape")
    if p.element_size() != 4:
        raise TypeError(f"{what} must be a 32-bit dtype")


def argsort(keys, cfg: SortConfig | None = None, *, device=None):
    """Stable argsort of uint32 keys: an int32 permutation, ties in their
    original order."""
    cfg = cfg or DEFAULT
    keys = _as_u32(keys, device)
    n = keys.numel()
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=keys.device)
    return _stable(keys, [], cfg, n)[1][:n]


def sort_pairs(keys, payload, cfg: SortConfig | None = None,
               assume_unique: bool = False, *, device=None):
    """Stable key + payload sort of uint32 keys and a 32-bit payload;
    returns (sorted keys, payload in its dtype).

    ``assume_unique=True``: the caller asserts the keys are unique and none
    is 0xFFFFFFFF (the pad sentinel).  The index plane is then dropped: two
    planes in the one-compare rider mode instead of three lexicographic
    ones.  Violating the contract mis-attaches payloads among equal keys; it
    is an assertion, not a hint."""
    cfg = cfg or DEFAULT
    keys = _as_u32(keys, device)
    payload = _as_tensor(payload, device if device is not None else keys.device)
    _check_payload(payload, keys)
    n = keys.numel()
    if n <= 1:
        return keys.clone(), payload.clone()
    if assume_unique:
        total = _pad_len(n)
        kp, pp = _key_plane(keys, total), _payload_plane(payload, total)
        if cfg.strategy == "lax":
            kp, order = torch.sort(kp, stable=True)
            pp = pp[order]
        else:
            _engine([kp, pp], cfg, 1, n)
        return _unbias(kp, n), pp[:n].view(payload.dtype)
    planes = _stable(keys, [payload], cfg, n)
    return _unbias(planes[0], n), planes[2][:n].view(payload.dtype)


def sort_multi(keys, payloads, cfg: SortConfig | None = None, *, device=None):
    """Stable sort of uint32 keys carrying any number of 32-bit payload
    columns through the network (no gather).  Returns (sorted keys, list of
    payloads in their dtypes)."""
    cfg = cfg or DEFAULT
    keys = _as_u32(keys, device)
    payloads = [_as_tensor(p, device if device is not None else keys.device)
                for p in payloads]
    for p in payloads:
        _check_payload(p, keys, "payloads")
    n = keys.numel()
    if n <= 1:
        return keys.clone(), [p.clone() for p in payloads]
    planes = _stable_planes(keys, payloads, cfg, _pad_len(n))
    return _unbias(planes[0], n), [o[:n].view(p.dtype)
                                   for o, p in zip(planes[2:], payloads)]


def sort_u64(hi, lo, cfg: SortConfig | None = None, *, device=None):
    """Sort 64-bit keys given as (hi, lo) uint32 halves: one two-plane
    lexicographic sort.  Returns sorted (hi, lo)."""
    cfg = cfg or DEFAULT
    hi = _as_u32(hi, device)
    lo = _as_u32(lo, device if device is not None else hi.device)
    if hi.shape != lo.shape:
        raise ValueError("hi/lo must match")
    n = hi.numel()
    if n <= 1:
        return hi.clone(), lo.clone()
    total = _pad_len(n)
    hp, lp = _key_plane(hi, total), _key_plane(lo, total)
    _engine([hp, lp], cfg, 2, n)
    return _unbias(hp, n), _unbias(lp, n)


_SIGN64 = np.uint64(0x8000000000000000)


def _encode_keys64(keys: np.ndarray) -> np.ndarray:
    """Order-preserving uint64 encoding of 64-bit numpy keys: uint64
    identity, int64 sign-bit flip, float64 sign-magnitude to lexicographic
    (-inf < ... < -0.0 < +0.0 < ... < +inf < nan)."""
    if keys.dtype == np.uint64:
        return keys
    if keys.dtype == np.int64:
        return keys.view(np.uint64) ^ _SIGN64
    bits = keys.view(np.uint64)
    return np.where((bits & _SIGN64) != 0, ~bits, bits | _SIGN64)


def _decode_keys64(enc: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.uint64:
        return enc
    if dtype == np.int64:
        return (enc ^ _SIGN64).view(np.int64)
    bits = np.where((enc & _SIGN64) != 0, enc ^ _SIGN64, ~enc)
    return bits.view(np.float64)


def _halves(enc: np.ndarray):
    return ((enc >> np.uint64(32)).astype(np.uint32),
            (enc & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _join64(hi: torch.Tensor, lo: torch.Tensor) -> np.ndarray:
    return ((hi.cpu().numpy().astype(np.uint64) << np.uint64(32))
            | lo.cpu().numpy().astype(np.uint64))


def _sort_any64(keys: np.ndarray, descending: bool, cfg, device) -> np.ndarray:
    """64-bit sort: uint64 encoding, (hi, lo) halves, ``sort_u64``, joined
    and decoded.  Descending complements the encoding."""
    enc = _encode_keys64(keys)
    if descending:
        enc = ~enc
    out = _join64(*sort_u64(*_halves(enc), cfg, device=device))
    if descending:
        out = ~out
    return _decode_keys64(out, keys.dtype)


def _sort_pairs_any64(keys: np.ndarray, payload, descending: bool, cfg,
                      device):
    """Stable 64-bit-key pairs: a stable sort by the low half carrying (hi,
    payload), then a stable sort by the high half carrying (lo, payload) —
    the LSD composition of the JAX package."""
    enc = _encode_keys64(keys)
    if descending:
        enc = ~enc
    hi, lo = _halves(enc)
    lo_s, (hi_s, p_s) = sort_multi(lo, [hi, payload], cfg, device=device)
    hi_f, (lo_f, p_f) = sort_multi(hi_s, [lo_s, p_s], cfg)
    out = _join64(hi_f, lo_f)
    if descending:
        out = ~out
    return _decode_keys64(out, keys.dtype), p_f


def sort_pairs_any(keys, payload, descending: bool = False,
                   cfg: SortConfig | None = None, *, device=None):
    """Stable key + payload sort for uint32 / int32 / float32 keys (tensors
    back), plus uint64 / int64 / float64 numpy keys (numpy keys back, the
    payload a tensor on ``device``).  ±0.0 float keys order as -0.0 < +0.0."""
    np64 = _numpy64(keys)
    if np64 is not None:
        return _sort_pairs_any64(np64, payload, descending, cfg, device)
    keys = _as_tensor(keys, device)
    if keys.dtype not in _KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    enc = _encode_keys(keys)
    if descending:
        enc = _flip(enc)
    k, p = sort_pairs(enc, payload, cfg, device=device)
    if descending:
        k = _flip(k)
    return _decode_keys(k, keys.dtype), p
