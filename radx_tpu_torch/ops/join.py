"""Joins on uint32 / int32 / float32 keys — port of radx_tpu/ops/join.py
(the BASELINE's "hash join", config 4).

``join_merge`` and ``join_merge_multi`` sort one tagged union of both sides
by the two-plane lexicographic mode of the bitonic network — (key, tie),
where the tie is the build row's index or 2^30 plus the probe row's index,
so build rows come first within a key; from 2^22 rows, where a power of two
would pad by more than 10%, as the pieces and valley merges of the
arbitrary-N sorts (the JAX package pads to a power of two) — then gather
its build-value and probe-value planes by the sorted tie (kernels/gather,
tagged mode; the JAX package sorts those two planes through the network as
well, four planes in all), then run segmented scans over the sorted keys
(kernels/segscan: ``fill`` carries a build value forward through its key's
run, ``sum`` ranks build rows), then stable compaction (kernels/compact).
``join_inner`` sorts the build side stably and probes it with
``torch.searchsorted`` (the JAX package's ``jnp.searchsorted``).

Row caps: each side of a join holds at most 2^30 - 1 rows, as in the JAX
package, because the probe tiebreak starts at 2^30 (ROADMAP F3: the cap is
kept).  A left join keeps the build values' bit patterns (ROADMAP F1: the
JAX package converts non-int32 build values numerically there).
"""

from __future__ import annotations

import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import bitonic, gather, segscan
from radx_tpu_torch.ops import sort as sort_ops
from radx_tpu_torch.ops.filter import _compact

PROBE_TIE = gather.PROBE_TIE  # probe row i carries tie 2^30 + i
MAX_SIDE_ROWS = PROBE_TIE - 1
_I32_MAX = 0x7FFFFFFF


def _keys_of(build_keys, probe_keys, device):
    build_keys = sort_ops._as_tensor(build_keys, device)
    probe_keys = sort_ops._as_tensor(probe_keys, device if device is not None
                                     else build_keys.device)
    if build_keys.dtype != probe_keys.dtype:
        raise TypeError("join key dtypes must match on both sides")
    if build_keys.dtype not in sort_ops._KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {build_keys.dtype}")
    if build_keys.dim() != 1 or probe_keys.dim() != 1:
        raise ValueError("join keys must be 1-D")
    return build_keys, probe_keys


def _values_of(vals, keys, what):
    vals = sort_ops._as_tensor(vals, keys.device)
    if vals.shape != keys.shape:
        raise ValueError(f"{what} must match its keys")
    if vals.element_size() != 4:
        raise TypeError(f"{what} must be a 32-bit dtype")
    return vals


def _check_cap(nb, np_):
    if nb > MAX_SIDE_ROWS or np_ > MAX_SIDE_ROWS:
        raise ValueError("join supports up to 2^30-1 rows per side")


def union_sources(enc_b, enc_p):
    """The tagged union's (key, tie) sources: build keys then probe keys
    (uint32, biased at load), and the tie made from the row: the build row's
    index, 2^30 plus the probe row's, 0x7FFFFFFF for a pad."""
    nb, n = enc_b.numel(), enc_b.numel() + enc_p.numel()
    return [bitonic.key_source(enc_b.contiguous(), enc_p.contiguous()),
            bitonic.index_source(n, nb, (0, PROBE_TIE - nb), _I32_MAX)]


def tagged_union(enc_b, build_vals, enc_p, probe_vals, cfg: SortConfig):
    """The sorted tagged union of both sides: (key, tie, build value, probe
    value) int32 planes of the union's rows (nb + np), sorted by (key, tie);
    a build row's probe value and a probe row's build value are 0.  Only
    (key, tie) go through the network, on the lex2 tiles and under every
    strategy.  Where ``sort_ops._worth_decomposing`` holds they are padded
    to ``blocks * chunk`` rows and sorted as the arbitrary-N pieces and
    valley merges of ``sort_ops._sort_pieces`` (the JAX package pads to a
    power of two); elsewhere to a power of two.  Pads (key and tie
    0x7FFFFFFF) follow every row, since a real tie is below 2^31 - 1, so
    the first nb + np rows are the same either way.  The network's first
    launches make the two planes (``sort_ops._source_load`` with
    ``network``: the union sorts on the network under every strategy): the
    build keys then the probe keys biased as they are read, the tie made
    from the row (row, or row - nb + 2^30 for a probe row), the pads
    written there; the planes come from ``torch.empty``.  The value planes
    are gathered by their sorted tie (``gather.gather_planes``, tagged)."""
    nb, np_ = enc_b.numel(), enc_p.numel()
    n = nb + np_
    chunk, fin = cfg.lex_tiles(2)
    sizes = None
    if sort_ops._worth_decomposing(n):
        blocks, sizes = sort_ops._decompose_blocks(n, chunk)
        total = blocks * chunk
    else:
        total = sort_ops._pad_len(n)
    key = sort_ops._empty(total, enc_b.device)
    tie = sort_ops._empty(total, enc_b.device)
    sources = union_sources(enc_b, enc_p)
    if sizes is None:
        bitonic.sort_sources(sources, [key, tie], 2, chunk, fin)
    else:
        sort_ops._sort_pieces([key, tie], sizes, chunk, fin, cfg, 2,
                              network=True, sources=sources)
    bval, pval = gather.gather_planes(
        tie[:n], [build_vals.contiguous().view(torch.int32),
                  probe_vals.contiguous().view(torch.int32)], "tagged")
    return [key[:n], tie[:n], bval, pval]


def _fill(skey, vals, flags, cfg: SortConfig):
    """Segmented forward fill of value planes by their 0/1 flag planes, at
    most ``segscan.MAX_FILL`` pairs per pass.  Returns (values, bool flags)
    lists."""
    outs, houts = [], []
    for i in range(0, len(vals), segscan.MAX_FILL):
        v, h = segscan.segscan_planes(
            skey, vals[i: i + segscan.MAX_FILL],
            "fill", torch.int32, cfg.scan_elems,
            [f.to(torch.int32) for f in flags[i: i + segscan.MAX_FILL]])
        outs += v
        houts += [x != 0 for x in h]
    return outs, houts


def merge_core(skey, sbval, spval, is_build, is_probe, cfg, missing_bits=None):
    """Single-match join over the sorted union: the last build value of
    each key's run filled into its probe rows, then the kept probe rows
    compacted.  ``missing_bits`` (a left join): every probe row is kept, the
    unmatched ones carry these int32 bits as their build value.  Returns
    ([key bits, build bits, probe bits], count)."""
    (filled,), (has,) = _fill(skey, [sbval], [is_build], cfg)
    if missing_bits is None:
        keep = has & is_probe
    else:
        keep = is_probe
        filled = torch.where(has, filled, missing_bits)
    return _compact(keep, [skey ^ sort_ops._SIGN, filled, spval], cfg)


def multi_core(skey, sbval, is_build, is_probe, cfg, max_matches):
    """Bounded multi-match join over the sorted union: each build row's
    rank within its key's run (a segmented count), then one fill plane per
    rank.  Returns (build value planes (M), valid flags (M), truncated)."""
    ib = is_build.to(torch.int32)
    rank = segscan.segscan_planes(skey, ib, "sum", torch.int32,
                                  cfg.scan_elems) - ib  # exclusive
    hjs = [is_build & (rank == j) for j in range(max_matches)]
    fjs = [torch.where(h, sbval, 0) for h in hjs]
    fills, hass = _fill(skey, fjs, hjs, cfg)
    valid = [is_probe & (j < rank) & hass[j] for j in range(max_matches)]
    truncated = (is_build & (rank >= max_matches)).any()
    return fills, valid, truncated


def _missing_bits(missing, dtype, device):
    """int32 bit pattern of ``missing`` in the build values' dtype."""
    m = torch.zeros((), dtype=dtype, device=device) if missing is None else \
        torch.as_tensor(missing, dtype=dtype).to(device)
    return m.view(torch.int32)


def join_merge(build_keys, build_vals, probe_keys, probe_vals,
               cfg: SortConfig | None = None, how: str = "inner",
               missing=None, *, device=None):
    """Inner or left join, one match per probe row (duplicate build keys
    resolve to the last build row).

    how="left" keeps every probe row; unmatched ones carry ``missing``
    (default zero of the build values' dtype) as their build value, bit for
    bit.  Returns (keys, build_vals, probe_vals, count): the first ``count``
    rows are the result, in key order (probe order within a key)."""
    cfg = cfg or DEFAULT
    bk, pk = _keys_of(build_keys, probe_keys, device)
    bv = _values_of(build_vals, bk, "build_vals")
    pv = _values_of(probe_vals, pk, "probe_vals")
    _check_cap(bk.numel(), pk.numel())
    if how not in ("inner", "left"):
        raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
    skey, stie, sbval, spval = tagged_union(
        sort_ops._encode_keys(bk), bv, sort_ops._encode_keys(pk), pv, cfg)
    is_build = stie < PROBE_TIE
    missing_bits = (_missing_bits(missing, bv.dtype, bk.device)
                    if how == "left" else None)
    (k, b, p), count = merge_core(skey, sbval, spval, is_build, ~is_build,
                                  cfg, missing_bits)
    return (sort_ops._decode_keys(k.view(torch.uint32), bk.dtype),
            b.view(bv.dtype), p.view(pv.dtype), count)


def join_merge_multi(build_keys, build_vals, probe_keys, probe_vals,
                     max_matches: int = 4, cfg: SortConfig | None = None, *,
                     device=None):
    """Inner join keeping up to ``max_matches`` build rows per probe row.

    Returns (keys, build_vals, probe_vals, valid, truncated): keys and
    probe_vals over the key-sorted union rows (n = nb + np); build_vals
    (max_matches, n), row j the rank-j build match; valid (max_matches, n)
    bool marking real (probe row, rank j) pairs; truncated a 0-d bool tensor,
    True when some key has more than max_matches build rows."""
    cfg = cfg or DEFAULT
    bk, pk = _keys_of(build_keys, probe_keys, device)
    bv = _values_of(build_vals, bk, "build_vals")
    pv = _values_of(probe_vals, pk, "probe_vals")
    _check_cap(bk.numel(), pk.numel())
    if max_matches < 1:
        raise ValueError("max_matches must be >= 1")
    skey, stie, sbval, spval = tagged_union(
        sort_ops._encode_keys(bk), bv, sort_ops._encode_keys(pk), pv, cfg)
    is_build = stie < PROBE_TIE
    is_probe = ~is_build & (stie != _I32_MAX)
    fills, valid, truncated = multi_core(skey, sbval, is_build, is_probe, cfg,
                                         max_matches)
    keys = sort_ops._decode_keys((skey ^ sort_ops._SIGN).view(torch.uint32),
                                 bk.dtype)
    return (keys, torch.stack(fills).view(bv.dtype), spval.view(pv.dtype),
            torch.stack(valid), truncated)


def join_inner(build_keys, build_vals, probe_keys, probe_vals,
               max_matches: int = 4, cfg: SortConfig | None = None, *,
               device=None):
    """Inner join: rows (probe i, build j) with probe_keys[i] ==
    build_keys[j], by a stable sort of the build side and
    ``torch.searchsorted``.

    Returns (key, build_val, probe_val, valid, truncated): (n_probe,
    max_matches) tables; ``valid`` marks real matches; ``truncated`` (0-d
    bool) is True if a probe key had more than max_matches build matches."""
    cfg = cfg or DEFAULT
    bk, pk = _keys_of(build_keys, probe_keys, device)
    bv = _values_of(build_vals, bk, "build_vals")
    pv = _values_of(probe_vals, pk, "probe_vals")
    if max_matches < 1:
        raise ValueError("max_matches must be >= 1")
    nb = bk.numel()
    if nb == 0:
        raise ValueError("join_inner needs at least one build row")
    # the stable (key, index, value) sort, biased int32 keys (sorted signed)
    planes = sort_ops._stable_planes(sort_ops._encode_keys(bk), [bv], cfg,
                                     sort_ops._pad_len(nb))
    sk, sv = planes[0][:nb], planes[2][:nb]
    pb = sort_ops._encode_keys(pk).view(torch.int32) ^ sort_ops._SIGN
    lo = torch.searchsorted(sk, pb, side="left")
    hi = torch.searchsorted(sk, pb, side="right")
    counts = hi - lo
    j = torch.arange(max_matches, device=bk.device)
    idx = (lo[:, None] + j).clamp(0, nb - 1)
    valid = j < counts.clamp(max=max_matches)[:, None]
    out_bk = torch.where(valid, sk[idx] ^ sort_ops._SIGN, 0)
    out_bv = torch.where(valid, sv[idx], 0)
    out_pv = torch.where(valid, pv.contiguous().view(torch.int32)[:, None], 0)
    truncated = (counts > max_matches).any()
    return (sort_ops._decode_keys(out_bk.view(torch.uint32), bk.dtype),
            out_bv.view(bv.dtype), out_pv.view(pv.dtype), valid, truncated)
