"""Segmented inclusive scan over sorted keys on Hopper — port of
radx_tpu/kernels/segscan.py.

``segscan_planes(keys, vals, op, dtype, tile_elems, flags=None)`` combines
each value with every earlier value of its equal-key run (keys sorted, or at
least with equal keys contiguous), inclusive, so the last row of a run holds
the run's aggregate.  Keys and values are int32 bit planes; ``dtype``
(uint32 / int32 / float32) says how the value bits are combined:

  * ``"sum"`` — mod 2^32 for the integers, float32 addition;
  * ``"min"`` / ``"max"`` — unsigned compare for uint32; for float32 NaN
    propagates and -0.0 / +0.0 resolve as in ``jnp.minimum`` /
    ``jnp.maximum`` (min takes -0.0, max +0.0), whatever their order;
  * ``"fill"`` — ``vals`` and ``flags`` are lists of M <= 4 (value, 0/1 flag)
    planes filled in one pass: a flagged row keeps its value, an unflagged
    row takes the last flagged value before it in its run and its flag
    becomes 1; where no flagged row precedes it, the row keeps its own
    value and flag 0 (the reference leaves unspecified values there).

``segscan_flat(skeys, acc, op, tile_elems, has=None)`` is the typed
counterpart of the JAX wrapper of the same name.

On a CUDA tensor one kernel of ``radx_tpu_torch/csrc/segscan.cu`` runs,
``segscan``: a single pass in which each block scans its tile of
``tile_elems`` rows, publishes the tile's run summary, finds the prefix of
its leading run by a decoupled look-back that folds its predecessors'
summaries left (so float32 sums are bit-identical from run to run), and
writes the tile out once.  Its scratch (the tile counter and a 16-word
status record a tile) is zeroed by one ``torch.zeros``.  On a CPU tensor
the plain PyTorch version runs: a Hillis-Steele doubling scan over the
whole array, gated on key equality (the reference's in-chunk algorithm).
Integer results and float min/max are bit-equal between the two; float32
sums are added in another order (tolerance 1e-5 of the run's sum of
magnitudes).

``segscan_lookback`` is a pure-torch model of the kernel for the CPU tests:
the same in-tile arithmetic (per-thread serial scan, warp shuffle scan,
warp totals) and the same look-back (``lookback.lookback_stop`` with the
kernel's stopping rule, then the left fold) under a visibility of the
predecessors' status records drawn from a generator.  It is a plain call.
"""

from __future__ import annotations

import ctypes

import torch

from radx_tpu_torch.config import MAX_SMEM_BYTES
from radx_tpu_torch.kernels import _build
from radx_tpu_torch.kernels.lookback import PREFIX, lookback_stop

OPS = {"sum": 0, "min": 1, "max": 2, "fill": 3}
DTYPES = {torch.uint32: 0, torch.int32: 1, torch.float32: 2}
KERNELS = ("segscan",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = {"segscan_ref": 0, "segscan_lookback": 0}
MAX_FILL = 4
RECORD_WORDS = 16  # a tile's status record: flag, A and P summaries
THREADS = 256  # a block of the kernel (fewer on a smaller tile)
_SIGN = -(1 << 31)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


# --- plain PyTorch version ----------------------------------------------------


def _combine_ref(op, dtype, p, c):
    """prev (earlier) combined with cur (later), on int32 bit planes."""
    if op == "sum":
        if dtype == torch.float32:
            return (p.view(torch.float32) + c.view(torch.float32)).view(
                torch.int32)
        s = (p.to(torch.int64) + c.to(torch.int64)) & 0xFFFFFFFF
        return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)
    is_min = op == "min"
    if dtype == torch.float32:
        a, b = p.view(torch.float32), c.view(torch.float32)
        tie = (p | c) if is_min else (p & c)
        res = torch.where(b < a, c if is_min else p, tie)
        res = torch.where(a < b, p if is_min else c, res)
        res = torch.where(torch.isnan(b), c, res)
        return torch.where(torch.isnan(a), p, res)
    pa, pc = (p ^ _SIGN, c ^ _SIGN) if dtype == torch.uint32 else (p, c)
    take_c = pc < pa if is_min else pc > pa
    return torch.where(take_c, c, p)


def segscan_ref(keys, vals, op, dtype, flags=None):
    """Plain version of the scan (int32 planes in, new int32 planes out):
    one plane, or (values, flags) lists for ``"fill"``."""
    PLAIN_CALLS["segscan_ref"] += 1
    fill = op == "fill"
    vs = [v.clone() for v in (vals if fill else [vals])]
    hs = [h.ne(0).to(torch.int32) for h in flags] if fill else []
    n, s = keys.numel(), 1
    while s < n:
        same = keys[s:] == keys[:-s]
        for j in range(len(vs)):
            v = vs[j]
            if fill:
                h = hs[j]
                take = same & (h[s:] == 0) & (h[:-s] != 0)
                new_v = torch.where(take, v[:-s], v[s:])
                new_h = torch.where(same, h[s:] | h[:-s], h[s:])
                hs[j] = torch.cat((h[:s], new_h))
            else:
                new_v = torch.where(same, _combine_ref(op, dtype, v[:-s], v[s:]),
                                    v[s:])
            vs[j] = torch.cat((v[:s], new_v))
        s *= 2
    return (vs, hs) if fill else vs[0]


# --- kernel wrapper -------------------------------------------------------------


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _validate(keys, planes, op, dtype, tile_elems, m):
    if op not in OPS:
        raise ValueError(f"unknown segscan op {op!r}")
    if dtype not in DTYPES:
        raise TypeError(f"unsupported value dtype {dtype}")
    if not 1 <= m <= (MAX_FILL if op == "fill" else 1):
        raise ValueError(f"op {op!r} takes 1..{MAX_FILL if op == 'fill' else 1}"
                         " value planes")
    for x in (keys, *planes):
        if (x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous()
                or x.shape != keys.shape or x.device != keys.device):
            raise ValueError("keys and planes must be contiguous 1-D int32 "
                             "tensors of one shape on one device")
    if keys.numel() == 0:
        raise ValueError("segscan needs at least one row")
    if tile_elems < 256 or tile_elems & (tile_elems - 1):
        raise ValueError("tile_elems must be a power of two >= 256")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    smem = 4 * (1 + m + (op == "fill")) * (tile_elems + tile_elems // 32)
    if keys.device.type == "cuda" and smem > MAX_SMEM_BYTES:
        raise ValueError(f"tile {tile_elems} exceeds one block's shared memory")


def segscan_planes(keys, vals, op, dtype, tile_elems, flags=None):
    """Inclusive segmented ``op`` scan of int32 value planes within the
    equal-key runs of the int32 ``keys``.  Returns a new plane, or for
    ``"fill"`` (lists ``vals`` and ``flags`` of M planes) a pair of lists."""
    fill = op == "fill"
    vs = list(vals) if fill else [vals]
    hs = list(flags) if fill else []
    if fill and len(hs) != len(vs):
        raise ValueError("fill needs one flag plane per value plane")
    if not fill and flags is not None:
        raise ValueError("flags are for op='fill' only")
    _validate(keys, vs + hs, op, dtype, tile_elems, len(vs))
    if keys.device.type == "cpu":
        return segscan_ref(keys, vals, op, dtype, flags)
    n = keys.numel()
    outs = [torch.empty_like(v) for v in vs]
    houts = [torch.empty_like(h) for h in hs]
    scratch = torch.zeros(RECORD_WORDS * (-(-n // tile_elems) + 1),
                          dtype=torch.int32, device=keys.device)
    _build.launch(LAUNCHES, "segscan", "radx_segscan", keys.device,
                  keys.data_ptr(), n, tile_elems.bit_length() - 1, _ptrs(vs),
                  _ptrs(hs), _ptrs(outs), _ptrs(houts), scratch.data_ptr(),
                  OPS[op], DTYPES[dtype], len(vs))
    return (outs, houts) if fill else outs[0]


def segscan_flat(skeys, acc, op, tile_elems, has=None):
    """Typed wrapper (counterpart of the JAX ``segscan_flat``): ``skeys`` any
    32-bit tensor of sorted keys, ``acc`` a uint32 / int32 / float32 tensor
    (or, for ``"fill"``, a list of them with a list ``has`` of 0/1 or bool
    flags).  Returns the scanned values in ``acc``'s dtype, or for
    ``"fill"`` (values list, bool flags list)."""
    kp = skeys.contiguous().view(torch.int32)
    if op != "fill":
        out = segscan_planes(kp, acc.contiguous().view(torch.int32), op,
                             acc.dtype, tile_elems)
        return out.view(acc.dtype)
    accs, hass = list(acc), list(has)
    vals = [a.contiguous().view(torch.int32) for a in accs]
    flags = [h.ne(0).to(torch.int32) for h in hass]
    outs, houts = segscan_planes(kp, vals, op, accs[0].dtype, tile_elems,
                                 flags)
    return ([o.view(a.dtype) for o, a in zip(outs, accs)],
            [h != 0 for h in houts])


# --- CPU model of the single pass ---------------------------------------------


class _Runs:
    """Run summaries (the kernel's ``Run``), elementwise over one shape: the
    last key, whether the stretch is one run, and the value part (M int32
    value planes; for fill M bool flags)."""

    def __init__(self, key, whole, vs, hs):
        self.key, self.whole, self.vs, self.hs = key, whole, vs, hs

    def map(self, f):
        return _Runs(f(self.key), f(self.whole), [f(v) for v in self.vs],
                     [f(h) for h in self.hs])


def _select(cond, a, b):
    """a where cond, else b (fieldwise)."""
    w = torch.where
    return _Runs(w(cond, a.key, b.key), w(cond, a.whole, b.whole),
                 [w(cond, x, y) for x, y in zip(a.vs, b.vs)],
                 [w(cond, x, y) for x, y in zip(a.hs, b.hs)])


def _absorb(vs, hs, pvs, phs, where, op, dtype):
    """The kernel's ``Val::absorb`` where ``where``: the earlier value part
    (pvs, phs) combined with (vs, hs)."""
    if op != "fill":
        return [torch.where(where, _combine_ref(op, dtype, pvs[0], vs[0]),
                            vs[0])], []
    take = [where & ~h & ph for h, ph in zip(hs, phs)]
    return ([torch.where(t, pv, v) for t, pv, v in zip(take, pvs, vs)],
            [h | (where & ph) for h, ph in zip(hs, phs)])


def _stack(runs, dim):
    """Summaries of one shape stacked along a new dimension ``dim``."""
    return _Runs(*(torch.stack(f, dim) for f in ([r.key for r in runs],
                                                  [r.whole for r in runs])),
                 [torch.stack([r.vs[j] for r in runs], dim)
                  for j in range(len(runs[0].vs))],
                 [torch.stack([r.hs[j] for r in runs], dim)
                  for j in range(len(runs[0].hs))])


def _join(a, b, op, dtype):
    """The kernel's ``join``: stretch a followed by stretch b."""
    cond = b.whole & (a.key == b.key)
    vs, hs = _absorb(b.vs, b.hs, a.vs, a.hs, cond, op, dtype)
    return _Runs(b.key, cond & a.whole, vs, hs)


def _tile_scan(k, vs, hs, op, dtype, threads):
    """The kernel's in-tile scan on every tile at once: k (T, threads, items)
    keys, vs / hs lists of value planes / bool flags of that shape (scanned
    in place).  Returns the tiles' summaries A, shape (T,)."""
    n_tiles, _, items = k.shape
    acc = _Runs(k[..., 0], torch.ones_like(k[..., 0], dtype=torch.bool),
                [v[..., 0] for v in vs], [h[..., 0] for h in hs])
    for j in range(1, items):  # each thread scans its rows serially
        same = k[..., j] == acc.key
        xv, xh = _absorb([v[..., j] for v in vs], [h[..., j] for h in hs],
                         acc.vs, acc.hs, same, op, dtype)
        for v, x in zip(vs + hs, xv + xh):
            v[..., j] = x
        acc = _Runs(k[..., j], acc.whole & same, xv, xh)
    warps = threads // 32
    x = acc.map(lambda a: a.reshape(n_tiles, warps, 32))
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):  # the warp's shuffle scan
        up = x.map(lambda a, off=off: torch.roll(a, off, -1))
        x = _select(lane >= off, _join(up, x, op, dtype), x)
    up1 = x.map(lambda a: torch.roll(a, 1, -1))
    # the warp totals, folded left: wp[w] covers warps 0 .. w-1
    wt = [x.map(lambda a, w=w: a[:, w, 31]) for w in range(warps)]
    wps, cur = [wt[0]], wt[0]  # (warp 0 has none: a placeholder)
    for w in range(1, warps):
        wps.append(cur)
        cur = _join(cur, wt[w], op, dtype)
    wp = _stack(wps, 1).map(lambda a: a.unsqueeze(-1).expand(-1, -1, 32))
    later = (torch.arange(warps) > 0).unsqueeze(-1)
    prev = _select(lane > 0, _select(later, _join(wp, up1, op, dtype), up1),
                   wp)
    has_prev = ((lane > 0) | later).reshape(threads)
    x = _select(later, _join(wp, x, op, dtype), x)
    # each thread's leading rows of the run open before it
    prev = prev.map(lambda a: a.reshape(n_tiles, threads, 1))
    lead = has_prev.unsqueeze(-1) & torch.cumprod(
        (k == prev.key).to(torch.int32), -1).bool()
    nv, nh = _absorb(vs, hs, prev.vs, prev.hs, lead, op, dtype)
    for v, x_ in zip(vs + hs, nv + nh):
        v.copy_(x_)
    return x.map(lambda a: a[:, -1, -1])


def segscan_lookback(keys, vals, op, dtype, tile_elems, gen, flags=None):
    """Pure-torch model of the ``segscan`` kernel (a plain call), with the
    arguments of ``segscan_planes`` and a ``torch.Generator`` ``gen``: tiles
    claimed from a counter in order, the kernel's in-tile scan, each tile's
    summary A; a tile whose first key differs from the row before it
    publishes P(t) = A(t) at once (not one run with its predecessors); for
    any other tile t >= 1 the walk of ``lookback_stop`` (it stops at P, or
    at an A that is not one run or whose key is not tile t's first key)
    under the visibility drawn from ``gen``, the left fold from there to
    t - 1 (the prefix), P(t) = join(prefix, A(t)), and the prefix folded
    into t's leading run.  Tiles of at least 32 rows.  Returns what
    ``segscan_ref`` returns."""
    PLAIN_CALLS["segscan_lookback"] += 1
    fill = op == "fill"
    vs_in = list(vals) if fill else [vals]
    hs_in = [h != 0 for h in flags] if fill else []
    n = keys.numel()
    n_tiles = -(-n // tile_elems)
    threads = min(tile_elems, THREADS)
    shape = (n_tiles, threads, tile_elems // threads)

    def tiled(x, fillv):
        out = torch.full((n_tiles * tile_elems,), fillv, dtype=x.dtype)
        out[:n] = x
        return out.view(shape)

    k = tiled(keys, -1)  # past n: key -1, value 0, flag 0, as in the kernel
    vs = [tiled(v, 0) for v in vs_in]
    hs = [tiled(h, False) for h in hs_in]
    a = _tile_scan(k, vs, hs, op, dtype, threads)
    first = k[:, 0, 0]
    # a run crosses into tile t iff the row before it has t's first key;
    # where none does, P(t) is A(t) (not one run with what precedes it)
    carry = torch.zeros(n_tiles, dtype=torch.bool)
    carry[1:] = k[:-1, -1, -1] == first[1:]
    crossed = carry.tolist()
    a_key, a_whole = a.key.tolist(), a.whole.tolist()
    one = [a.map(lambda x, t=t: x[t: t + 1]) for t in range(n_tiles)]
    pre, fold = [one[0]], [one[0]]
    for t in range(1, n_tiles):
        if not crossed[t]:
            pre.append(_Runs(one[t].key, torch.zeros_like(one[t].whole),
                             one[t].vs, one[t].hs))
            fold.append(one[t])  # not read
            continue
        fk = int(first[t])
        u, flag = lookback_stop(
            t, lambda u: not a_whole[u] or a_key[u] != fk, gen,
            lambda u: not crossed[u])
        acc = pre[u] if flag == PREFIX else one[u]
        for v in range(u + 1, t):
            acc = _join(acc, one[v], op, dtype)
        fold.append(acc)
        pre.append(_join(acc, one[t], op, dtype))
    lb = _stack(fold, 0).map(lambda x: x.view(n_tiles))
    lb = lb.map(lambda x: x.view(n_tiles, 1, 1))
    where = carry.view(n_tiles, 1, 1) & (k == lb.key)
    vs, hs = _absorb(vs, hs, lb.vs, lb.hs, where, op, dtype)
    vs = [v.reshape(-1)[:n] for v in vs]
    if not fill:
        return vs[0]
    return vs, [h.reshape(-1)[:n].to(torch.int32) for h in hs]
