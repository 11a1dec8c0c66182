"""Rank, pack and concatenation kernels of the radix distribution sort — the
parts of radx_tpu/kernels/msd.py that ``strategy="radix"`` uses
(``sort_msd`` itself is not ported: only a JAX test calls it).

  * ``splitter_ranks_ref(keys, splitters, chunk)`` — ranks[c, j] = the
    number of keys of sorted chunk c (plane 0) below splitter j: the plain
    version of the ranks of K11 (``_rank_kernel``), whose launch,
    ``radix_rank``, is ``radix_sort.rank_runs`` (splitters, ranks, run
    bounds and segment tables in one kernel; its launches are counted
    here);
  * ``pack(planes, bounds, chunk, slot, nb_pad, ncmp)`` — the run
    [bounds[c, b], bounds[c, b+1]) of every sorted chunk c copied to slot
    (b, c) of a bucket-major buffer of nb_pad x n_chunks slots, padded with
    the per-plane fill ``_fill`` and cut at the slot (K12, ``_pack_kernel``);
  * ``concat(merged, sorted_, out, start, src, n_merged, ncmp)`` — the
    output as a list of segments: rows [start[s], start[s+1]) come from
    offset src[s] of the merged buckets (s < n_merged) or of the sorted
    chunks, rows from start[-1] (the valid count) on get the fill (K13,
    ``_concat_kernel``); with ``key_out`` its unbiasing form, the radix
    sort's last launch: plane 0 goes XORed with 0x80000000 to the caller's
    keys (``radix_concat/unbias<mode>``, keys, rider and lex2).

On a CUDA tensor pack and concat run their kernels of
``radx_tpu_torch/csrc/radix.cu`` (``radix_pack<mode>``,
``radix_concat<mode>``; the mode suffixes are those of kernels/bitonic.py);
on a CPU tensor their plain PyTorch versions.  Planes are contiguous 1-D
int32 tensors; bounds are int32, segment tables int64.
"""

from __future__ import annotations

import ctypes

import torch

from radx_tpu_torch.kernels import _build, bitonic

_PAD = 0x7FFFFFFF  # i32 sentinel: sign-biased uint32 max — sorts last
_PAD_IDX = 0x7FFFFFFF  # tiebreak-plane fill: pads lose every tiebreak
_K = 8  # the JAX concat window (buckets per output block): plan rounding
_U = 8  # the JAX pack-kernel bucket unroll: plan rounding


def _fill(i: int, num_cmp: int) -> int:
    if i == 0:
        return _PAD
    if i == 1 and num_cmp == 2:
        return _PAD_IDX
    return 0


def mode_kernels(ncmp: int, planes: int) -> tuple[str, ...]:
    """Launch names of the pack and concat kernels in one mode."""
    sfx = bitonic._suffix(ncmp, planes)
    return f"radix_pack{sfx}", f"radix_concat{sfx}"


def unbias_kernel(ncmp: int, planes: int) -> str:
    """Launch name of concat's unbiasing form in one mode
    (``bitonic.SOURCE_MODES``)."""
    return f"radix_concat/unbias{bitonic._suffix(ncmp, planes)}"


UNBIAS_KERNELS = tuple(unbias_kernel(*m) for m in bitonic.SOURCE_MODES)
KERNELS = ("radix_rank",) + tuple(k for m in bitonic.MODES
                                  for k in mode_kernels(*m)) + UNBIAS_KERNELS
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(("radix_rank_ref", "radix_rank_model",
                             "radix_pack_ref", "radix_concat_ref"), 0)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _on_cuda(tensors) -> bool:
    x = tensors[0]
    for t in tensors:
        if t.dim() != 1 or not t.is_contiguous() or t.device != x.device:
            raise ValueError("expected contiguous 1-D tensors on one device")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def _planes_of(planes, ncmp):
    bitonic._mode(planes, ncmp)
    for p in planes:
        if p.dtype != torch.int32 or p.shape != planes[0].shape:
            raise ValueError("planes must be int32 tensors of one shape")


def _call(name, fn_name, x, *args):
    _build.launch(LAUNCHES, name, fn_name, x.device, *args)


def _ptrs(planes):
    return (ctypes.c_void_p * len(planes))(*[p.data_ptr() for p in planes])


# --- K11: splitter ranks -------------------------------------------------------


def splitter_ranks_ref(keys, splitters, chunk):
    """Per splitter, a count of the keys below it in every chunk of
    ``chunk`` keys of the int32 plane ``keys``: (n_chunks, m) int32."""
    PLAIN_CALLS["radix_rank_ref"] += 1
    x = keys.view(-1, chunk)
    ranks = torch.zeros(x.shape[0], splitters.numel(), dtype=torch.int32,
                        device=keys.device)
    for j, s in enumerate(splitters):
        ranks[:, j] = (x < s).sum(1)
    return ranks


# --- K12: pack -------------------------------------------------------------------


def pack_ref(planes, bounds, chunk, slot, nb_pad, ncmp):
    """Plain version of ``pack``: the new packed planes."""
    PLAIN_CALLS["radix_pack_ref"] += 1
    n_chunks = planes[0].numel() // chunk
    b = bounds.to(torch.int64)
    lo = b[:, :-1]
    cnt = (b[:, 1:] - lo).clamp(0, slot)
    i = torch.arange(slot, device=lo.device)
    valid = i < cnt[..., None]  # (n_chunks, nb_pad, slot)
    base = torch.arange(n_chunks, device=lo.device)[:, None] * chunk + lo
    src = torch.where(valid, base[..., None] + i, 0)
    return [torch.where(valid, p[src], _fill(j, ncmp)).transpose(0, 1)
            .reshape(-1) for j, p in enumerate(planes)]


def pack(planes, bounds, chunk, slot, nb_pad, ncmp):
    """Pack the runs of the sorted chunks into bucket-major slots: returns new
    planes of nb_pad * n_chunks * slot rows, slot (b, c) at (b * n_chunks +
    c) * slot.  ``bounds`` is (n_chunks, nb_pad + 1) int32."""
    _planes_of(planes, ncmp)
    n_chunks = planes[0].numel() // chunk
    if (planes[0].numel() != n_chunks * chunk or chunk != n_chunks * slot
            or slot & (slot - 1) or chunk & (chunk - 1)):
        raise ValueError(f"chunk {chunk} / slot {slot} / {n_chunks} chunks")
    if (bounds.dtype != torch.int32 or bounds.shape != (n_chunks, nb_pad + 1)
            or not bounds.is_contiguous()):
        raise ValueError("bounds must be contiguous int32 (n_chunks, nb_pad+1)")
    if not _on_cuda([*planes, bounds.view(-1)]):
        return pack_ref(planes, bounds, chunk, slot, nb_pad, ncmp)
    out = [torch.empty(nb_pad * chunk, dtype=torch.int32, device=p.device)
           for p in planes]
    _call(mode_kernels(ncmp, len(planes))[0], "radx_radix_pack", planes[0],
          _ptrs(planes), _ptrs(out), len(planes), ncmp, n_chunks,
          chunk.bit_length() - 1, bounds.data_ptr(), nb_pad,
          slot.bit_length() - 1)
    return out


# --- K13: concat -----------------------------------------------------------------


def concat_ref(merged, sorted_, start, src, n_merged, total, ncmp):
    """Plain version of ``concat``: the new output planes of ``total``
    rows."""
    PLAIN_CALLS["radix_concat_ref"] += 1
    dev = start.device
    i = torch.arange(total, device=dev)
    n_seg = src.numel()
    seg = torch.searchsorted(start[1:], i, right=True).clamp(max=n_seg - 1)
    k = src[seg] + i - start[seg]
    valid = i < start[-1]
    from_merged = seg < n_merged
    outs = []
    for j, m in enumerate(merged):
        v = m[k.clamp(0, m.numel() - 1)]
        if sorted_ is not None:
            s = sorted_[j]
            v = torch.where(from_merged, v, s[k.clamp(0, s.numel() - 1)])
        outs.append(torch.where(valid, v, _fill(j, ncmp)))
    return outs


def concat(merged, sorted_, out, start, src, n_merged, ncmp, key_out=None):
    """Write the output planes ``out`` (in place) from the segments:
    rows [start[s], start[s+1]) read from offset src[s] of ``merged`` for
    s < n_merged, else of ``sorted_`` (None when there are no such
    segments); rows from start[-1] on get the fill.  ``key_out`` = (keys,
    row), the unbiasing form (keys, rider, lex2: the radix sort's last
    launch): plane 0 goes XORed with 0x80000000 to keys[row:], the rows
    that fit (``keys`` may be out[0] itself), and out[0] is not written;
    it may be None where the mode has other planes (they give the rows)."""
    _planes_of(merged, ncmp)
    planes = out
    if key_out is not None:
        bitonic._edge_mode(out, ncmp)
        keys = key_out[0]
        if keys.dtype != torch.int32:
            raise ValueError("the keys' output is an int32 tensor")
        if out[0] is None:
            if len(out) < 2:
                raise ValueError("one plane: out[0] gives the rows")
            planes = out[1:]
    for p in planes:
        if p.dtype != torch.int32 or p.shape != planes[0].shape:
            raise ValueError("planes must be int32 tensors of one shape")
    bitonic._mode(out, ncmp)
    n_seg = src.numel()
    if (start.dtype != torch.int64 or src.dtype != torch.int64
            or start.numel() != n_seg + 1 or not 0 < n_merged <= n_seg):
        raise ValueError("start / src must be int64 segment tables")
    if sorted_ is None:
        if n_merged != n_seg:
            raise ValueError("segments past n_merged need the sorted planes")
    else:
        _planes_of(sorted_, ncmp)
    total = planes[0].numel()
    tensors = [*merged, *planes, start, src, *(sorted_ or ())]
    if not _on_cuda(tensors + ([] if key_out is None else [key_out[0]])):
        res = concat_ref(merged, sorted_, start, src, n_merged, total, ncmp)
        stored = 0 if key_out is None else 1
        for o, r in zip(out[stored:], res[stored:]):
            o.copy_(r)
        if key_out is not None:
            bitonic._store_key(key_out, res[0])
        return out
    if key_out is None:
        _call(mode_kernels(ncmp, len(out))[1], "radx_radix_concat", out[0],
              _ptrs(merged), _ptrs(sorted_ or merged), _ptrs(out), len(out),
              ncmp, start.data_ptr(), src.data_ptr(), n_seg, n_merged, total)
        return out
    key, rows, xor = bitonic._key_out_args(key_out, [planes[0]],
                                           bitonic.SIGN)
    _call(unbias_kernel(ncmp, len(out)), "radx_radix_concat_out", planes[0],
          _ptrs(merged), _ptrs(sorted_ or merged),
          _ptrs([key_out[0] if o is None else o for o in out]), len(out),
          ncmp, start.data_ptr(), src.data_ptr(), n_seg, n_merged, total,
          key, rows, xor)
    return out
