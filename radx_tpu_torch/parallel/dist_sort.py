"""Distributed sample-splitter sort over a mesh — port of
radx_tpu/parallel/dist_sort.py (BASELINE config 5).

Per shard (``_shard_body``):

  1. sort the shard locally: sign-biased keys, a global-index plane when
     the sort is stable, the payload planes (the bitonic network of
     kernels/bitonic.py, keys-only or lexicographic);
  2. take OVERSAMPLE * D regular samples of the sorted valid prefix, gather
     every shard's samples, sort them (``torch.sort``: a small array, where
     the JAX package calls ``jnp.sort``) and pick D - 1 splitter keys at
     regular ranks.  Each shard then receives at most n/D + n/OVERSAMPLE
     keys under any key distribution;
  3. rank the splitters in the sorted shard (``torch.searchsorted``,
     clipped to the valid prefix) and pack the D runs into sentinel-padded
     slots of a fixed size;
  4. exchange the slots in D - 1 waves, merging the runs that have arrived
     between waves (``overlap=True``) or all of them at the end, with the
     network's run merge (``kernels/bitonic.merge_sorted_runs``): the
     source flips the runs bound for odd arrival positions, so every merge
     finds its runs in alternating directions.  ``exchange="hier"`` routes
     in two phases over a Dr x Dc factorisation of D: (Dr - 1) + (Dc - 1)
     waves instead of D - 1, each key moving twice.

Row d's valid prefix, then row d + 1's, ... is the globally sorted
sequence.  Slots are the power-of-two round-up of ``capacity`` x
ceil(n / D^2) keys (at least 128); a shard pair that needs more sets the
overflow flag, which stays on the device: the caller reads it (the
``_auto`` wrappers read it once an attempt and double the capacity).

The body is written once against a transport of three operations: gather
the samples, one wave of slots and their counts within a subgroup, and the
global max of the overflow.  ``mesh.InProcess`` runs every shard in this
process, phase by phase; ``multihost.Group`` runs one shard per rank of a
``torch.distributed`` group.  With an in-process ``Mesh`` the functions
take the whole array and return (D, L) rows, gathered on the mesh's first
device; with a group mesh they take this rank's shard and return its (1, L)
row, (1,) valid count and (1,) global flag.

Payload sorts always thread the global-index plane (``internal_stable``):
a real key 0xFFFFFFFF ties with the pads otherwise, and a pad's payload
could take its place in the valid prefix.  The index plane is int32, so
D * ceil(n / D) stays below 2^31 (``MAX_KEYS``).
"""

from __future__ import annotations

import numpy as np
import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import bitonic

_SIGN = -(1 << 31)  # int32 bit pattern 0x80000000
_PAD_KEY = 0x7FFFFFFF  # sign-biased 0xFFFFFFFF
OVERSAMPLE = 64  # samples per shard per splitter
MIN_SLOT = 128  # the JAX slots' floor (one 128-lane row)
# The global-index plane is int32 and must stay below the pads' 0x7FFFFFFF
# tiebreak; the JAX package computes its valid counts in int32 too.
MAX_KEYS = (1 << 31) - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_pad(n: int, min_total: int = 1024) -> int:
    return 1 << (max(n, min_total) - 1).bit_length()


def _log2(x: int) -> int:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"{x} is not a power of two")
    return x.bit_length() - 1


def _plane_fill(i: int, num_cmp: int) -> int:
    """Pad of plane i: the sentinel key, and the largest tiebreak, so that
    pads lose every comparison to a real key 0xFFFFFFFF."""
    if i == 0:
        return _PAD_KEY
    if i == 1 and num_cmp == 2:
        return 0x7FFFFFFF
    return 0


def _network(planes, num_cmp, cfg: SortConfig):
    """(keys plane, lex planes, chunk tile, finish tile) of a sort of
    ``planes``: keys only, or lexicographic over planes 0 and 1."""
    chunk, fin = cfg.mode_tiles(len(planes), num_cmp)
    if num_cmp == 1 and len(planes) != 1:
        raise ValueError("a keys-only sort takes one plane")
    return planes[0], (planes[1:] if num_cmp == 2 else None), chunk, fin


def _local_sort_planes(planes, m: int, cfg: SortConfig, num_cmp: int):
    """Pad int32 planes of length m to a power of two and sort them; the
    sorted first m rows (views)."""
    total = _pow2_pad(m)
    padded = []
    for i, p in enumerate(planes):
        buf = torch.full((total,), _plane_fill(i, num_cmp), dtype=torch.int32,
                         device=p.device)
        buf[:m] = p
        padded.append(buf)
    keys, lex, chunk, fin = _network(padded, num_cmp, cfg)
    bitonic.sort_planes(keys, chunk, fin, lex=lex)
    return [b[:m] for b in padded]


def _merge_runs(planes, log_run: int, num_cmp: int, cfg: SortConfig,
                descending: bool = False):
    """Merge alternating-direction runs of 2^log_run rows in place."""
    keys, lex, chunk, fin = _network(planes, num_cmp, cfg)
    bitonic.merge_sorted_runs(keys, log_run, chunk, fin, descending=descending,
                              lex=lex)
    return planes


def _merge_pair(a_planes, b_planes, log_run, num_cmp, cfg, descending):
    """Merge run a (ascending) and run b (descending) into one new run of
    twice the length, ascending unless ``descending``.  The concatenation
    copies, so neither input is written."""
    planes = [torch.cat([a, b]) for a, b in zip(a_planes, b_planes)]
    return _merge_runs(planes, log_run, num_cmp, cfg, descending)


def _pack_slots(planes, bounds, counts, group_size: int, slot: int,
                num_cmp: int):
    """Rows [bounds[g], bounds[g + 1]) of the sorted planes into fixed
    sentinel-padded slots: a (G, P, slot) int32 tensor.  A run longer than
    the slot keeps its first ``slot`` rows (the overflow flag says so)."""
    dev = planes[0].device
    j = torch.arange(slot, device=dev)
    idx = (bounds[:-1, None] + j).clamp_(max=planes[0].numel() - 1)
    in_slot = j < counts[:, None]
    send = torch.empty((group_size, len(planes), slot), dtype=torch.int32,
                       device=dev)
    for i, p in enumerate(planes):
        send[:, i] = torch.where(in_slot, p[idx], _plane_fill(i, num_cmp))
    return send


def _bounds(ranks, valid):
    """[0, ranks..., valid] as int64 on the ranks' device (valid: an int or
    a 0-d tensor)."""
    b = torch.zeros(ranks.numel() + 2, dtype=torch.int64, device=ranks.device)
    b[1:-1] = ranks
    b[-1] = valid
    return b


def _split_ranks(sorted_key, valid, split_vals):
    """Rank of each splitter in the ascending key plane, clipped to the
    valid prefix (a splitter equal to the pad sentinel must not count the
    pads into its run)."""
    ranks = torch.searchsorted(sorted_key, split_vals)
    if isinstance(valid, torch.Tensor):
        return torch.minimum(ranks, valid)
    return ranks.clamp_(max=valid)


def _group_exchange_merge(tr, sends, counts, me_g, group_size, group_sel, slot,
                          num_cmp, cfg, overlap):
    """Exchange fixed slots within subgroups and merge the arrivals.

    Per local shard k: ``sends[k]`` (G, P, slot), run g bound for the
    group's g-th member; ``counts[k]`` (G,) int32 valid lengths;
    ``me_g[k]`` its coordinate in its group.  ``group_sel[i] = (g,
    flat_of)`` maps flat shard i to its coordinate and its group's flat
    indices.  Returns per local shard the merged ascending planes
    (n_runs * slot rows, sentinel runs completing a non-power-of-two group)
    and the valid total (0-d int32).  ``sends`` is emptied."""
    n_local = len(tr.local)
    log_slot = _log2(slot)
    n_runs = 1 << (group_size - 1).bit_length()
    for k in range(n_local):
        odd = [g for g in range(group_size) if (g - me_g[k]) % group_size & 1]
        if odd:  # the source flips the runs bound for odd arrival positions
            sends[k][odd] = sends[k][odd].flip(-1)

    def wave(shift):
        msgs = []
        for k, i in enumerate(tr.local):
            g, flat_of = group_sel[i]
            dest = (g + shift) % group_size
            msgs.append((flat_of[dest], flat_of[(g - shift) % group_size],
                         sends[k][dest], counts[k][dest: dest + 1]))
        return tr.wave(msgs)

    def sentinel_run(dev, n_planes):
        return [torch.full((slot,), _plane_fill(i, num_cmp), dtype=torch.int32,
                           device=dev) for i in range(n_planes)]

    own = [sends[k][me_g[k]] for k in range(n_local)]
    rcounts = [[counts[k][me_g[k]: me_g[k] + 1]] for k in range(n_local)]
    n_planes = own[0].shape[0]
    if overlap:
        stacks = [[] for _ in range(n_local)]  # (level, position, planes)

        def push(k, run_planes, a):
            stack = stacks[k]
            stack.append((0, a, run_planes))
            while len(stack) >= 2 and stack[-1][0] == stack[-2][0]:
                lvl, _, b = stack.pop()
                _, pos1, a_pl = stack.pop()
                parent = pos1 >> 1
                stack.append((lvl + 1, parent, _merge_pair(
                    a_pl, b, log_slot + lvl, num_cmp, cfg,
                    descending=(parent & 1) == 1)))

        for k in range(n_local):
            push(k, list(own[k].unbind(0)), 0)
        for shift in range(1, group_size):
            for k, (r, rc) in enumerate(wave(shift)):
                rcounts[k].append(rc)
                push(k, list(r.unbind(0)), shift)
        for k in range(n_local):
            for a in range(group_size, n_runs):
                push(k, sentinel_run(own[k].device, n_planes), a)
        if any(len(s) != 1 for s in stacks):
            raise RuntimeError("the run merge tree did not close")
        merged = [s[0][2] for s in stacks]
    else:
        runs = [[o] for o in own]
        for shift in range(1, group_size):
            for k, (r, rc) in enumerate(wave(shift)):
                rcounts[k].append(rc)
                runs[k].append(r)
        merged = []
        for k in range(n_local):
            runs[k] += [torch.stack(sentinel_run(own[k].device, n_planes))
                        for _ in range(n_runs - group_size)]
            flat = torch.cat(runs[k], dim=-1)  # (P, n_runs * slot), a copy
            runs[k] = None
            merged.append(_merge_runs(list(flat.unbind(0)), log_slot, num_cmp,
                                      cfg))
    sends[:] = [None] * n_local
    valid = [torch.cat(rc).sum().to(torch.int32) for rc in rcounts]
    return merged, valid


def _shard_body(tr, shards, payloads, n, m, slot, cfg, stable, overlap,
                hier=None):
    """The shards' body (the JAX ``_shard_body`` under ``shard_map``), run
    for the transport's local shards together, phase by phase.

    shards[k]: shard ``tr.local[k]``'s (m,) uint32 keys, payloads[k] its
    32-bit payload tensors.  ``n`` is the global valid count: pads sit at
    the global tail, so shard ``me`` holds clip(n - me * m, 0, m) real keys
    first, and pads never enter the samples, the counts or the exchange.
    hier=None: the flat exchange (slot an int); hier=(Dr, Dc): the two-phase
    exchange (slot = (slot1, slot2)).  Returns per local shard
    ([uint32 keys, other planes...], valid 0-d int32, overflow 0-d bool)."""
    n_dev = tr.size
    num_cmp = 2 if stable else 1
    ns = OVERSAMPLE * n_dev
    planes_k, valid_k, samples = [], [], []
    for k, me in enumerate(tr.local):
        dev = shards[k].device
        planes = [shards[k].view(torch.int32) ^ _SIGN]
        if stable:
            planes.append(torch.arange(me * m, me * m + m, dtype=torch.int32,
                                       device=dev))
        planes += [p.contiguous().view(torch.int32) for p in payloads[k]]
        planes = _local_sort_planes(planes, m, cfg, num_cmp)
        m_valid = min(max(n - me * m, 0), m)
        # the JAX positions jj*q + (jj*r)//(ns+1), m_valid = q*(ns+1) + r,
        # are floor(jj * m_valid / (ns+1)): exact here in int64
        jj = torch.arange(1, ns + 1, dtype=torch.int64, device=dev)
        samples.append(planes[0][jj * m_valid // (ns + 1)])
        planes_k.append(planes)
        valid_k.append(m_valid)
    spos = torch.arange(1, n_dev) * ns  # = j * (ns * D) // D exactly
    splitters = [torch.sort(g).values[spos.to(g.device)]
                 for g in tr.all_gather(samples)]  # (D-1,): shard s gets
    # [split[s-1], split[s])
    flat_sel = {i: (i, list(range(n_dev))) for i in range(n_dev)}

    if hier is None:
        sends, counts, ovf = [], [], []
        for k in range(len(tr.local)):
            ranks = _split_ranks(planes_k[k][0], valid_k[k], splitters[k])
            b = _bounds(ranks, valid_k[k])
            c = (b[1:] - b[:-1]).to(torch.int32)
            ovf.append((c - slot).max())
            sends.append(_pack_slots(planes_k[k], b, c, n_dev, slot, num_cmp))
            counts.append(c)
            planes_k[k] = None
        merged, valid = _group_exchange_merge(
            tr, sends, counts, list(tr.local), n_dev, flat_sel, slot, num_cmp,
            cfg, overlap)
    else:
        # Phase 1 routes by destination block r' (final shards
        # [r'*Dc, (r'+1)*Dc): one contiguous slice of the sorted shard)
        # along the column peers {(*, c)}; phase 2 slices the merged block
        # run at the block's internal splitters and routes along the row
        # peers {(r', *)}.
        d_r, d_c = hier
        col_sel = {i: (i // d_c, [g * d_c + i % d_c for g in range(d_r)])
                   for i in range(n_dev)}
        row_sel = {i: (i % d_c, [(i // d_c) * d_c + g for g in range(d_c)])
                   for i in range(n_dev)}
        slot1, slot2 = slot
        sends, counts, ovf = [], [], []
        for k in range(len(tr.local)):
            block_splits = splitters[k][[b * d_c - 1 for b in range(1, d_r)]]
            ranks = _split_ranks(planes_k[k][0], valid_k[k], block_splits)
            b = _bounds(ranks, valid_k[k])
            c = (b[1:] - b[:-1]).to(torch.int32)
            ovf.append((c - slot1).max())
            sends.append(_pack_slots(planes_k[k], b, c, d_r, slot1, num_cmp))
            counts.append(c)
            planes_k[k] = None
        merged1, valid1 = _group_exchange_merge(
            tr, sends, counts, [me // d_c for me in tr.local], d_r, col_sel,
            slot1, num_cmp, cfg, overlap)
        sends, counts = [], []
        for k, me in enumerate(tr.local):
            r_me = me // d_c
            inner = splitters[k][r_me * d_c: r_me * d_c + d_c - 1]
            ranks = _split_ranks(merged1[k][0], valid1[k], inner)
            b = _bounds(ranks, valid1[k])
            c = (b[1:] - b[:-1]).to(torch.int32)
            ovf[k] = torch.maximum(ovf[k], (c - slot2).max())
            sends.append(_pack_slots(merged1[k], b, c, d_c, slot2, num_cmp))
            counts.append(c)
            merged1[k] = None
        merged, valid = _group_exchange_merge(
            tr, sends, counts, [me % d_c for me in tr.local], d_c, row_sel,
            slot2, num_cmp, cfg, overlap)
    overflow = [o > 0 for o in tr.max(ovf)]
    return [([(p[0] ^ _SIGN).view(torch.uint32), *p[1:]], v, o)
            for p, v, o in zip(merged, valid, overflow)]


def _hier_factor(n_dev: int) -> tuple[int, int] | None:
    """Near-square power-of-two factorisation Dr x Dc of a power-of-two D
    (None when D is not a power of two >= 4: hier runs the flat exchange)."""
    if n_dev < 4 or n_dev & (n_dev - 1):
        return None
    k = _log2(n_dev)
    return 1 << (k - k // 2), 1 << (k // 2)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    raise TypeError(f"expected a torch.Tensor or numpy array, got {type(x)}")


def _pad_tail(x: torch.Tensor, total: int, fill: int) -> torch.Tensor:
    if x.numel() == total:
        return x
    tail = torch.full((total - x.numel(),), fill, dtype=torch.int32,
                      device=x.device).view(x.dtype)
    return torch.cat([x, tail])


def _shard_len(n: int, n_dev: int) -> int:
    """Keys a shard, ceil(n / D).  Raises unless 1 <= D * ceil(n / D) <=
    MAX_KEYS: the index plane of a stable sort and the valid counts are
    int32."""
    if n < 1:
        raise ValueError("dist_sort needs at least one key")
    m = _cdiv(n, n_dev)
    if m * n_dev > MAX_KEYS:
        raise ValueError(f"dist_sort takes at most {MAX_KEYS} keys "
                         f"(D * ceil(n / D) = {m * n_dev})")
    return m


def _run_sharded(keys, payloads, mesh, axis, capacity, cfg, stable, overlap,
                 exchange="flat"):
    """Shard, run the body, assemble: (planes, valid, overflow)."""
    cfg = cfg or DEFAULT
    if axis != mesh.axis:
        raise ValueError(f"the mesh has axis {mesh.axis!r}, not {axis!r}")
    if exchange not in ("flat", "hier"):
        raise ValueError(f"unknown exchange {exchange!r}")
    keys = _tensor(keys)
    payloads = [_tensor(p) for p in payloads]
    if keys.dtype != torch.uint32:
        # int32 keys would bias and compare wrong
        raise TypeError(f"keys must be uint32, got {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    for p in payloads:
        if p.shape != keys.shape or p.element_size() != 4:
            raise TypeError(f"payloads must be 32-bit arrays of shape "
                            f"{tuple(keys.shape)}")
    tr = mesh.transport()
    n_dev = tr.size
    n = keys.numel() * (1 if tr.whole else n_dev)
    m = _shard_len(n, n_dev)
    if tr.whole:
        # ragged n: sentinel keys (zero payloads) at the global tail
        keys = _pad_tail(keys, m * n_dev, -1)
        payloads = [_pad_tail(p, m * n_dev, 0) for p in payloads]
        shards = [keys[i * m: (i + 1) * m].to(tr.device(i)) for i in tr.local]
        pay = [[p[i * m: (i + 1) * m].to(tr.device(i)) for p in payloads]
               for i in tr.local]
    else:
        shards = [keys.to(tr.device(tr.local[0]))]
        pay = [[p.to(shards[0].device) for p in payloads]]
    hier = _hier_factor(n_dev) if exchange == "hier" else None
    if hier is not None:
        d_r, d_c = hier
        slot = (_pow2_pad(capacity * _cdiv(m, d_r), min_total=MIN_SLOT),
                _pow2_pad(capacity * _cdiv(m, d_c), min_total=MIN_SLOT))
    else:
        slot = _pow2_pad(capacity * _cdiv(n, n_dev * n_dev),
                         min_total=MIN_SLOT)
    internal_stable = stable or bool(payloads)
    outs = _shard_body(tr, shards, pay, n, m, slot, cfg, internal_stable,
                       overlap, hier)
    del shards, pay
    home = tr.device(tr.local[0])
    planes = [torch.stack([o[0][i].to(home) for o in outs])
              for i in range(len(outs[0][0]))]
    valid = torch.stack([o[1].to(home) for o in outs])
    overflow = torch.stack([o[2].to(home) for o in outs])
    return planes, valid, overflow


def sort_sharded(keys, mesh, axis: str = "d", capacity: int = 4,
                 cfg: SortConfig | None = None, overlap: bool = True,
                 exchange: str = "flat"):
    """Distributed sort of uint32 keys over ``mesh``.

    Returns (sorted_padded, valid, overflow): (D, L) uint32 rows, row d
    shard d's sorted keys padded with sentinels past ``valid[d]``; (D,)
    int32 valid counts; (D,) bool, True anywhere when a slot overflowed and
    the result must not be trusted (run again with a larger capacity).  On
    a group mesh: this rank's (1, L) row, (1,) count and (1,) flag."""
    planes, valid, overflow = _run_sharded(
        keys, (), mesh, axis, capacity, cfg, stable=False, overlap=overlap,
        exchange=exchange)
    return planes[0], valid, overflow


def sort_pairs_sharded(keys, values, mesh, axis: str = "d", capacity: int = 4,
                       cfg: SortConfig | None = None, stable: bool = False,
                       overlap: bool = True, exchange: str = "flat"):
    """Distributed key + payload sort; values: any 32-bit dtype, the keys'
    shape.  Returns (sorted_keys, sorted_values, valid, overflow) with the
    rows of ``sort_sharded``.  ``stable=True`` keeps the original order of
    equal keys across the mesh; the index plane that does so runs inside
    every payload sort, so the order is the same either way."""
    planes, valid, overflow = _run_sharded(
        keys, (values,), mesh, axis, capacity, cfg, stable=stable,
        overlap=overlap, exchange=exchange)
    return planes[0], planes[-1].view(_tensor(values).dtype), valid, overflow


def argsort_sharded(keys, mesh, axis: str = "d", capacity: int = 4,
                    cfg: SortConfig | None = None, overlap: bool = True):
    """Distributed stable argsort: (sorted_keys, global_indices, valid,
    overflow); global_indices[d, i] (int32) is the original flat position
    of sorted_keys[d, i]."""
    planes, valid, overflow = _run_sharded(
        keys, (), mesh, axis, capacity, cfg, stable=True, overlap=overlap)
    return planes[0], planes[1], valid, overflow


def _escalate(run, start_capacity: int, max_capacity: int):
    """Run at start_capacity, doubling while the overflow flag is set (one
    host read an attempt); (outputs, capacity used)."""
    c = start_capacity
    while True:
        *out, overflow = run(c)
        if not bool(overflow.any()):
            return out, c
        if c >= max_capacity:
            raise RuntimeError(f"dist_sort slot overflow persists at "
                               f"capacity={c}")
        c *= 2


def sort_sharded_auto(keys, mesh, axis: str = "d",
                      cfg: SortConfig | None = None, overlap: bool = True,
                      exchange: str = "flat", start_capacity: int = 2,
                      max_capacity: int = 64):
    """``sort_sharded`` with the smallest capacity that does not overflow:
    2, doubled as the data's (source, destination) skew demands (a
    presorted input escalates to about D).  Returns (sorted_padded, valid,
    capacity_used); RuntimeError if ``max_capacity`` still overflows."""
    (out, valid), c = _escalate(
        lambda c: sort_sharded(keys, mesh, axis=axis, capacity=c, cfg=cfg,
                               overlap=overlap, exchange=exchange),
        start_capacity, max_capacity)
    return out, valid, c


def sort_pairs_sharded_auto(keys, values, mesh, axis: str = "d",
                            cfg: SortConfig | None = None,
                            stable: bool = False, overlap: bool = True,
                            exchange: str = "flat", start_capacity: int = 2,
                            max_capacity: int = 64):
    """``sort_sharded_auto`` for key + payload shards: (sorted_keys,
    sorted_values, valid, capacity_used)."""
    (k, v, valid), c = _escalate(
        lambda c: sort_pairs_sharded(keys, values, mesh, axis=axis, capacity=c,
                                     cfg=cfg, stable=stable, overlap=overlap,
                                     exchange=exchange),
        start_capacity, max_capacity)
    return k, v, valid, c


def collect(sorted_padded, valid) -> np.ndarray:
    """On the host: the rows' valid prefixes, concatenated (one sorted numpy
    array)."""
    rows = (sorted_padded.cpu().numpy() if isinstance(sorted_padded,
                                                      torch.Tensor)
            else np.asarray(sorted_padded))
    counts = (valid.cpu().numpy() if isinstance(valid, torch.Tensor)
              else np.asarray(valid))
    return np.concatenate([rows[d, : counts[d]] for d in range(rows.shape[0])])
