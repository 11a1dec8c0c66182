"""Bitonic merge sort on Hopper — port of radx_tpu/kernels/bitonic.py
(``num_cmp=1``: keys, or keys with one rider plane).

One flat int32 array of sign-biased keys, of power-of-two length, sorted in
place (the counterpart of the JAX pipeline's ``input_output_aliases``),
optionally with a second int32 array, the rider, that moves with its key
(the JAX ``unique=False`` mode).  One comparison per pair decides the swap of
both planes, and a pair swaps only when strictly out of order, so tied keys
keep their own riders; which of two tied keys' riders comes first is not
part of the contract, only that none is lost or duplicated.  The
network is the JAX package's: at merge level kk an element ascends iff bit kk
of its flat index is clear (``invert`` flips every direction), and its
partner at distance d is ``index ^ d``.  The TPU's (rows, 128) lane tiling,
FINISH_WIDTH / QUAD_FUSION and its VMEM width clamps are gone; the tiles are
sized by a block's shared memory (config.py).

Three kernels (CUDA C++ in ``radx_tpu_torch/csrc/bitonic.cu``):

  * ``chunk_sort``  — stages 1..log2(C) inside every chunk of C keys
    (``_chunk_sort_kernel``);
  * ``cross_stage`` — F = 1..4 consecutive distances >= the finish tile in
    one device-memory pass (``_cross_stage{,2,3,4}_kernel``);
  * ``finish``      — every distance of a level below the finish tile T,
    inside each tile of T keys (``_finishw_kernel``).

Each wrapper works in place on a contiguous 1-D int32 tensor (and its
``rider``, of the same shape and device).  On a CUDA tensor it launches its
kernel on the current stream, without synchronising, and raises if the
launch fails; on a CPU tensor it runs the kernel's plain PyTorch version,
which computes the same network one compare-exchange substage at a time.
``LAUNCHES`` counts kernel launches by name (``<name>/rider`` for the
two-plane mode) and ``PLAIN_CALLS`` counts calls of the plain versions.
"""

from __future__ import annotations

import torch

from radx_tpu_torch.config import MAX_TILE_ELEMS
from radx_tpu_torch.kernels import _build

CROSS_FUSION = (1, 2, 3, 4)  # distances fused per cross pass
KEY_KERNELS = ("chunk_sort", *(f"cross_stage<{f}>" for f in CROSS_FUSION),
               "finish")
RIDER_KERNELS = tuple(f"{k}/rider" for k in KEY_KERNELS)
KERNELS = KEY_KERNELS + RIDER_KERNELS
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(("chunk_sort_ref", "cross_stage_ref", "finish_ref"), 0)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _log2(x: int) -> int:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"{x} is not a power of two")
    return x.bit_length() - 1


# --- plain PyTorch versions --------------------------------------------------


def _pairs(x, d):
    v = x.reshape(-1, 2, d)
    return v[:, 0], v[:, 1]


def _cx_ref(x, dj, kk, invert, local_mask=None, rider=None):
    """One substage at distance d = 2^dj: view as (..., 2, d) and keep the
    min on the low side where bit kk of the pair's index (``& local_mask``
    when given) equals ``invert``, the max elsewhere.  With a rider, both
    planes swap where the pair is strictly out of order; returns
    ``(keys, rider)``."""
    d = 1 << dj
    lo, hi = _pairs(x, d)
    g = torch.arange(lo.shape[0], device=x.device, dtype=torch.int64) << (dj + 1)
    if local_mask is not None:
        g &= local_mask
    up = (((g >> kk) & 1) == int(invert))[:, None]
    if rider is None:
        mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
        return torch.stack(
            (torch.where(up, mn, mx), torch.where(up, mx, mn)), 1
        ).reshape(-1)
    swap = torch.where(up, lo > hi, lo < hi)
    out = []
    for plane in (x, rider):
        a, b = _pairs(plane, d)
        out.append(torch.stack(
            (torch.where(swap, b, a), torch.where(swap, a, b)), 1
        ).reshape(-1))
    return tuple(out)


def _substages_ref(x, rider, djs, kk, invert, local_mask=None):
    for dj in djs:
        if rider is None:
            x = _cx_ref(x, dj, kk, invert, local_mask)
        else:
            x, rider = _cx_ref(x, dj, kk, invert, local_mask, rider)
    return x if rider is None else (x, rider)


def chunk_sort_ref(x, chunk, kk_range=None, invert=False, ascending=False,
                   rider=None):
    """Plain version of ``chunk_sort`` (stages ``kk_range``, by default all
    of 1..log2(chunk)): returns the result (``(keys, rider)`` with a rider),
    the inputs untouched."""
    PLAIN_CALLS["chunk_sort_ref"] += 1
    log_c = _log2(chunk)
    mask = chunk - 1 if ascending else None
    if kk_range is None:
        kk_range = range(1, log_c + 1)
    for kk in kk_range:
        out = _substages_ref(x, rider, range(kk - 1, -1, -1), kk, invert, mask)
        x, rider = (out, None) if rider is None else out
    return x if rider is None else (x, rider)


def cross_stage_ref(x, j_low, f, kk, invert=False, rider=None):
    """Plain version of ``cross_stage``: distances 2^(j_low+f-1) .. 2^j_low."""
    PLAIN_CALLS["cross_stage_ref"] += 1
    return _substages_ref(x, rider, range(j_low + f - 1, j_low - 1, -1), kk,
                          invert)


def finish_ref(x, tile, kk, invert=False, rider=None):
    """Plain version of ``finish``: level kk's distances below ``tile``."""
    PLAIN_CALLS["finish_ref"] += 1
    return _substages_ref(x, rider, range(min(_log2(tile), kk) - 1, -1, -1),
                          kk, invert)


# --- kernel wrappers -----------------------------------------------------------


def _on_cuda(x, span, tile=False, rider=None):
    """Validate ``x`` (and ``rider``) for a pass over blocks of ``span``
    keys; True for CUDA tensors (launch the kernel), False for CPU ones (run
    the plain version).  ``tile``: the span of every plane is held in one
    block's shared memory."""
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("expected a contiguous 1-D int32 tensor")
    if rider is not None and (
        rider.dtype != torch.int32 or rider.shape != x.shape
        or not rider.is_contiguous() or rider.device != x.device
    ):
        raise ValueError("the rider must be a contiguous int32 tensor of the "
                         "keys' shape on their device")
    n = x.numel()
    _log2(n)
    if span < 2 or span > n:
        raise ValueError(f"span {span} outside [2, {n}]")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    max_tile = MAX_TILE_ELEMS if rider is None else MAX_TILE_ELEMS // 2
    if tile and span > max_tile:
        raise ValueError(
            f"tile {span} exceeds one block's shared memory "
            f"({max_tile} keys at {1 if rider is None else 2} planes)"
        )
    return True


def _plain(x, rider, out):
    if rider is None:
        x.copy_(out)
    else:
        x.copy_(out[0])
        rider.copy_(out[1])
    return x


def _launch(name, fn_name, x, rider, *args):
    lib = _build.load()
    if rider is not None:
        name += "/rider"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, fn_name)(
            x.data_ptr(), None if rider is None else rider.data_ptr(),
            x.numel(), *args, stream)
    _build.check(lib, code, name)
    LAUNCHES[name] += 1


def chunk_sort(x, chunk, invert=False, ascending=False, rider=None):
    """Bitonic stages 1..log2(chunk) inside every chunk of ``chunk`` keys, in
    place.  Directions follow the global index, so chunks alternate;
    ``ascending`` takes the index within the chunk."""
    log_c = _log2(chunk)
    if not _on_cuda(x, chunk, tile=True, rider=rider):
        return _plain(x, rider, chunk_sort_ref(
            x, chunk, invert=invert, ascending=ascending, rider=rider))
    _launch("chunk_sort", "radx_chunk_sort", x, rider, log_c, int(invert),
            int(ascending))
    return x


def cross_stage(x, j_low, f, kk, invert=False, rider=None):
    """Compare-exchange at the f consecutive distances 2^(j_low+f-1) ..
    2^j_low of level kk in one pass, in place."""
    if f not in CROSS_FUSION or j_low + f > kk:
        raise ValueError(f"bad cross pass f={f} j_low={j_low} kk={kk}")
    if not _on_cuda(x, 1 << (j_low + f), rider=rider):
        return _plain(x, rider, cross_stage_ref(x, j_low, f, kk, invert, rider))
    _launch(f"cross_stage<{f}>", "radx_cross_stage", x, rider, j_low, f, kk,
            int(invert))
    return x


def finish(x, tile, kk, invert=False, rider=None):
    """Every distance of level kk below ``tile``, inside each tile, in place."""
    log_t = _log2(tile)
    if not _on_cuda(x, tile, tile=True, rider=rider):
        return _plain(x, rider, finish_ref(x, tile, kk, invert, rider))
    _launch("finish", "radx_finish", x, rider, log_t, kk, int(invert))
    return x


# --- orchestration (radx_tpu/kernels/bitonic.py::_sort_pipeline) ------------


def _cross_schedule(kk, log_t):
    """(j_low, f) passes covering level kk's distances 2^(kk-1) .. 2^log_t,
    greedily 4, 3, 2, 1 consecutive distances per pass."""
    djs = list(range(kk - 1, log_t - 1, -1))
    i = 0
    while i < len(djs):
        f = min(max(CROSS_FUSION), len(djs) - i)
        yield djs[i + f - 1], f
        i += f


def _sort_pipeline(x, chunk_elems, finish_elems, presorted,
                   presorted_log=None, invert=False, rider=None):
    n = x.numel()
    log_n = _log2(n)
    if n == 1:
        return x
    c = min(chunk_elems, n)
    t = min(max(finish_elems, c), n)
    log_c, log_t = _log2(c), _log2(t)
    if presorted_log is None:
        presorted_log = log_c
    if not presorted:
        chunk_sort(x, c, invert=invert, rider=rider)
    start_kk = (presorted_log if presorted else log_c) + 1
    for kk in range(start_kk, log_n + 1):
        for j_low, f in _cross_schedule(kk, log_t):
            cross_stage(x, j_low, f, kk, invert, rider)
        finish(x, t, kk, invert, rider)
    return x


def sort_planes(x, chunk_elems, finish_elems, descending=False, rider=None):
    """Sort the keys of ``x`` in place, ascending (or descending: every
    direction bit flipped, the same passes), moving ``rider`` with them.
    ``x.numel()`` is a power of two; the tiles are clamped to it."""
    return _sort_pipeline(x, chunk_elems, finish_elems, presorted=False,
                          invert=descending, rider=rider)


def sort_chunks_ascending(x, chunk_elems):
    """Sort every chunk of ``chunk_elems`` keys ascending, independently."""
    return chunk_sort(x, min(chunk_elems, x.numel()), ascending=True)


def merge_sorted_runs(x, log_run, chunk_elems, finish_elems, descending=False,
                      rider=None):
    """Merge runs of 2^log_run keys, run r sorted ascending for even r and
    descending for odd r, into one sorted sequence: only the merge levels
    above ``log_run`` run.  ``descending`` inverts every direction."""
    return _sort_pipeline(
        x, min(chunk_elems, 1 << log_run), finish_elems, presorted=True,
        presorted_log=log_run, invert=descending, rider=rider,
    )


def merge_bitonic_ascending(x, chunk_elems, finish_elems, descending=False,
                            rider=None):
    """Sort ONE bitonic sequence of power-of-two length: the top merge level
    with every direction forced ascending (or all inverted)."""
    return _sort_pipeline(
        x, chunk_elems, finish_elems, presorted=True,
        presorted_log=_log2(x.numel()) - 1, invert=descending, rider=rider,
    )


def _cx_directed(lo, hi, descending, rlo=None, rhi=None):
    """Elementwise compare-exchange of two equal-length views, in place:
    ascending keeps the min on the low side, descending the max.  Riders
    ``rlo``/``rhi`` swap with their keys where the pair is strictly out of
    order."""
    if rlo is None:
        mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
        if descending:
            mn, mx = mx, mn
        lo.copy_(mn)
        hi.copy_(mx)
        return
    swap = lo < hi if descending else lo > hi
    for a, b in ((lo, hi), (rlo, rhi)):
        a_new, b_new = torch.where(swap, b, a), torch.where(swap, a, b)
        a.copy_(a_new)
        b.copy_(b_new)


def merge_valley_ascending(x, chunk_elems, finish_elems, descending=False,
                           rider=None):
    """Sort a bitonic sequence of any length in place — the arbitrary-N
    primitive.  The sequence is merged on a virtual 2^ceil(log2 L)-wire
    network whose tail wires hold +inf (ascending; -inf descending), so an
    exchange with a virtual high wire is a no-op and the tail never exists.
    Per halving level: the top half-cleaner touches only the physical
    overhang, the low half is then a full pow2 bitonic merge, and the high
    remainder is bitonic again; iterate on it."""
    cur, cur_r = x, rider
    while cur.numel() > 1:
        r = cur.numel()
        v = 1 << (r - 1).bit_length()  # tight virtual size
        if r == v:
            merge_bitonic_ascending(cur, chunk_elems, finish_elems, descending,
                                    cur_r)
            break
        half = v // 2
        if cur_r is None:
            _cx_directed(cur[: r - half], cur[half:], descending)
        else:
            _cx_directed(cur[: r - half], cur[half:], descending,
                         cur_r[: r - half], cur_r[half:])
        merge_bitonic_ascending(cur[:half], chunk_elems, finish_elems,
                                descending,
                                None if cur_r is None else cur_r[:half])
        cur = cur[half:]
        cur_r = None if cur_r is None else cur_r[half:]
    return x
