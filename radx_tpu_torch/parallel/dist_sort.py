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
     clipped to the valid prefix): run g of the shard is the contiguous
     slice [bounds[g], bounds[g + 1]) of its sorted planes;
  4. gather every shard's run bounds (``all_gather``) and read them on the
     host, once a phase (two host reads with ``exchange="hier"``).  That
     read replaces the JAX package's static shapes: each run travels and
     is merged at its own length, min(count, slot) rows;
  5. exchange the runs in D - 1 waves, then merge a shard's arrivals
     pairwise with the merge-path kernel (``kernels/merge.merge_runs``),
     in arrival order; the last merge writes the output row's prefix, and
     the rest of the row is each plane's pad.  ``exchange="hier"`` routes
     in two phases over a Dr x Dc factorisation of D: (Dr - 1) + (Dc - 1)
     waves instead of D - 1, each key moving twice.  The entry points take
     the JAX package's ``overlap`` for compatibility; it has no effect: a
     merge between waves only delayed the next wave on the card.

Row d's valid prefix, then row d + 1's, ... is the globally sorted
sequence.  The outputs are the JAX package's bit for bit: (D, L) rows of
L = n_runs x slot (n_runs the power-of-two round-up of the group), slots
the power-of-two round-up of ``capacity`` x ceil(n / D^2) keys (at least
128), the sentinel pads past the real rows, ``valid`` the sum of the raw
run counts.  A run longer than its slot keeps its first ``slot`` rows and
sets the overflow flag, which stays on the device: the caller reads it
(the ``_auto`` wrappers read it once an attempt and double the
capacity).  The JAX package sends and merges whole padded slots (XLA's
static shapes); the port moves and merges the real rows only.

The body is written once against a transport of three operations: an
all-gather (the samples, the run bounds), one wave of runs within a
subgroup, and the global max of the overflow.  ``mesh.InProcess`` runs
every shard in this process, phase by phase; ``multihost.Group`` runs one
shard per rank of a ``torch.distributed`` group.  With an in-process
``Mesh`` the functions take the whole array and return (D, L) rows, on the
mesh's first device; with a group mesh they take this rank's shard and
return its (1, L) row, (1,) valid count and (1,) global flag.

Payload sorts always thread the global-index plane (``internal_stable``):
a real key 0xFFFFFFFF ties with the pads otherwise, and a pad's payload
could take its place in the valid prefix.  The index plane is int32, so
D * ceil(n / D) stays below 2^31 (``MAX_KEYS``).
"""

from __future__ import annotations

import numpy as np
import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import bitonic, merge
from radx_tpu_torch.ops import sort as sort_ops

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
    sort_ops.count_prep("_local_sort_planes", planes[0])
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


def _local_sort_sources(sources, m: int, device, cfg: SortConfig,
                        num_cmp: int):
    """``_local_sort_planes`` with the planes made by the network's first
    launch (``bitonic.sort_sources``): the shard's keys biased as they are
    read, the stable sort's global index made from the row, the pads of
    ``_plane_fill`` past m; the planes come from ``torch.empty``.  The
    sorted first m rows (views)."""
    planes = [torch.empty(_pow2_pad(m), dtype=torch.int32, device=device)
              for _ in sources]
    _, _, chunk, fin = _network(planes, num_cmp, cfg)
    bitonic.sort_sources(sources, planes, num_cmp, chunk, fin)
    return [p[:m] for p in planes]


def _bounds(ranks, valid: int):
    """[0, ranks..., valid] as int64 on the ranks' device."""
    b = torch.zeros(ranks.numel() + 2, dtype=torch.int64, device=ranks.device)
    b[1:-1] = ranks
    b[-1] = valid
    return b


def _split_ranks(sorted_key, valid, split_vals):
    """Rank of each splitter in the ascending key plane, clipped to the
    valid prefix (a splitter equal to the pad sentinel must not count the
    pads into its run)."""
    return torch.searchsorted(sorted_key, split_vals).clamp_(max=valid)


def _run_table(tr, bounds, planes_k):
    """Every shard's run bounds and source rows on the host: row i of the
    (D, G + 2) int64 array is shard i's [0, ranks..., valid, rows of its
    source planes].  One ``all_gather`` and one host read: the lengths that
    XLA's static shapes fixed in advance."""
    parts = [torch.cat([b, b.new_tensor([p[0].numel()])])
             for b, p in zip(bounds, planes_k)]
    return tr.all_gather(parts)[0].cpu().numpy().reshape(tr.size, -1)


class _Merger:
    """A shard's arrivals, pushed after the last wave, merged pairwise in
    arrival order (a stack: two runs of one level merge into one of the
    next, so it holds at most one merged run a level), the rest pairwise
    from the top once the last run has come.  The last merge
    writes ``out`` (the output's prefix; XORing ``key_xor`` into the keys),
    or new planes when ``out`` is None.  A merge before the last one with
    an empty run keeps the other run as it is."""

    def __init__(self, n_runs, num_cmp, out, key_xor):
        self.left, self.num_cmp = n_runs, num_cmp
        self.out, self.key_xor = out, key_xor
        self.stack = []  # (level, planes)
        self.result = None

    def _merge(self, a, b, last):
        if not last:
            if b[0].numel() == 0:
                return a
            if a[0].numel() == 0:
                return b
        return merge.merge_runs(a, b, self.num_cmp,
                                out=self.out if last else None,
                                key_xor=self.key_xor if last else 0)

    def push(self, run):
        self.left -= 1
        stack = self.stack
        stack.append((0, run))
        while len(stack) >= 2 and (not self.left
                                   or stack[-1][0] == stack[-2][0]):
            (lb, b), (la, a) = stack.pop(), stack.pop()
            stack.append((max(la, lb) + 1,
                          self._merge(a, b, not self.left and not stack)))
        if not self.left:
            (level, planes), = stack
            if level == 0:  # a group of one: the run itself is the output
                planes = self._merge(planes, [p[:0] for p in planes], True)
            self.result = planes


def _exchange_merge(tr, planes_k, bounds, group_sel, slot, num_cmp,
                    out_rows=None):
    """Exchange the runs within subgroups at their own length and merge the
    arrivals.

    Per local shard k: ``planes_k[k]`` its sorted planes, ``bounds[k]``
    (G + 1,) int64 the run bounds [0, ranks..., valid] in them, run g bound
    for the group's g-th member.  ``group_sel[i] = (g, flat_of)`` maps flat
    shard i to its coordinate and its group's flat indices.  A source sends
    run g's first min(count, slot) rows (those within its planes), the
    JAX slots' truncation.  ``out_rows(k)``: the (P, L) output of shard k,
    its prefix the merged rows (keys un-biased), the rest each plane's pad;
    None: the merged rows alone, keys biased.  Returns per local shard the merged planes and the valid
    total (int: the raw counts, as the JAX package sums them).
    ``planes_k`` is emptied once the last wave has left."""
    table = _run_table(tr, bounds, planes_k)
    starts, src_rows = table[:, :-2], table[:, -1]
    counts = np.diff(table[:, :-1], axis=1)
    sends = np.clip(np.minimum(counts, slot), 0, src_rows[:, None] - starts)
    group_size = counts.shape[1]
    key_xor = 0 if out_rows is None else _SIGN
    mergers, valid, fulls = [], [], []
    for k, i in enumerate(tr.local):
        g, flat_of = group_sel[i]
        rows = int(sends[flat_of, g].sum())
        out = None
        if out_rows is not None:
            full = out_rows(k)
            for p, o in enumerate(full):
                o[rows:].fill_(_plane_fill(p, num_cmp)
                               ^ (key_xor if p == 0 else 0))
            out = [o[:rows] for o in full]
            fulls.append(full)
        mergers.append(_Merger(group_size, num_cmp, out, key_xor))
        valid.append(int(counts[flat_of, g].sum()))

    def run(k, dest):
        i = tr.local[k]
        b, s = int(starts[i, dest]), int(sends[i, dest])
        return [p[b: b + s] for p in planes_k[k]]

    def wave(shift):
        msgs = []
        for k, i in enumerate(tr.local):
            g, flat_of = group_sel[i]
            dest, src = (g + shift) % group_size, (g - shift) % group_size
            msgs.append((flat_of[dest], flat_of[src], run(k, dest),
                         int(sends[flat_of[src], g])))
        return tr.wave(msgs)

    arrivals = [[run(k, group_sel[i][0])] for k, i in enumerate(tr.local)]
    for shift in range(1, group_size):
        for k, got in enumerate(wave(shift)):
            arrivals[k].append(got)
    if not tr.whole:
        # a rank's sorted planes now serve only its own run: copied out,
        # they go before the merges (in one process the other shards'
        # arrivals are views of them, so copying there frees nothing)
        for a in arrivals:
            a[0] = [p.clone() for p in a[0]]
    planes_k[:] = [None] * len(planes_k)  # the runs hold what they need
    for k in range(len(tr.local)):
        runs = arrivals[k][::-1]
        arrivals[k] = None
        while runs:  # a run is freed once the merger has taken it
            mergers[k].push(runs.pop())
    return fulls or [m.result for m in mergers], valid


def _shard_body(tr, shards, payloads, n, m, slot, cfg, stable, hier=None,
                out_rows=None):
    """The shards' body (the JAX ``_shard_body`` under ``shard_map``), run
    for the transport's local shards together, phase by phase.

    shards[k]: shard ``tr.local[k]``'s (m,) uint32 keys, payloads[k] its
    32-bit payload tensors.  ``n`` is the global valid count: pads sit at
    the global tail, so shard ``me`` holds clip(n - me * m, 0, m) real keys
    first, and pads never enter the samples, the counts or the exchange.
    hier=None: the flat exchange (slot an int); hier=(Dr, Dc): the two-phase
    exchange (slot = (slot1, slot2)).  ``out_rows(k)``: shard k's (P, L)
    int32 output.  Returns per local shard ([uint32 keys, other
    planes...], valid 0-d int32, overflow 0-d bool)."""
    n_dev = tr.size
    num_cmp = 2 if stable else 1
    ns = OVERSAMPLE * n_dev
    planes_k, valid_k, samples = [], [], []
    for k, me in enumerate(tr.local):
        dev = shards[k].device
        n_planes = 1 + stable + len(payloads[k])
        if sort_ops._source_load(cfg, n_planes, num_cmp, network=True):
            sources = [bitonic.key_source(shards[k].contiguous())]
            if stable:
                sources.append(bitonic.index_source(
                    m, add=(me * m, me * m), pad=_plane_fill(1, num_cmp)))
            planes = _local_sort_sources(sources, m, dev, cfg, num_cmp)
        else:
            planes = [shards[k].view(torch.int32) ^ _SIGN]
            if stable:
                planes.append(torch.arange(me * m, me * m + m,
                                           dtype=torch.int32, device=dev))
            planes += [p.contiguous().view(torch.int32) for p in payloads[k]]
            planes = _local_sort_planes(planes, m, cfg, num_cmp)
        m_valid = min(max(n - me * m, 0), m)
        # the JAX positions jj*q + (jj*r)//(ns+1), m_valid = q*(ns+1) + r,
        # are floor(jj * m_valid / (ns+1)): exact here in int64
        jj = torch.arange(1, ns + 1, dtype=torch.int64, device=dev)
        samples.append(planes[0][jj * m_valid // (ns + 1)])
        planes_k.append(planes)
        valid_k.append(m_valid)
    del planes
    spos = torch.arange(1, n_dev) * ns  # = j * (ns * D) // D exactly
    splitters = [torch.sort(g).values[spos.to(g.device)]
                 for g in tr.all_gather(samples)]  # (D-1,): shard s gets
    # [split[s-1], split[s])
    flat_sel = {i: (i, list(range(n_dev))) for i in range(n_dev)}

    def cut(planes, valid, split_vals, slot_):
        """The run bounds at the splitters, and the overflow of the slot."""
        b = _bounds(_split_ranks(planes[0], valid, split_vals), valid)
        return b, (b[1:] - b[:-1] - slot_).max()

    if hier is None:
        bounds, ovf = zip(*(cut(planes_k[k], valid_k[k], splitters[k], slot)
                            for k in range(len(tr.local))))
        merged, valid = _exchange_merge(tr, planes_k, bounds, flat_sel, slot,
                                        num_cmp, out_rows)
    else:
        # Phase 1 routes by destination block r' (final shards
        # [r'*Dc, (r'+1)*Dc): one contiguous slice of the sorted shard)
        # along the column peers {(*, c)}; phase 2 cuts the merged block
        # at the block's internal splitters and routes along the row
        # peers {(r', *)}.
        d_r, d_c = hier
        col_sel = {i: (i // d_c, [g * d_c + i % d_c for g in range(d_r)])
                   for i in range(n_dev)}
        row_sel = {i: (i % d_c, [(i // d_c) * d_c + g for g in range(d_c)])
                   for i in range(n_dev)}
        slot1, slot2 = slot
        bounds, ovf1 = zip(*(cut(planes_k[k], valid_k[k],
                                 splitters[k][[b * d_c - 1
                                               for b in range(1, d_r)]],
                                 slot1)
                             for k in range(len(tr.local))))
        merged1, valid1 = _exchange_merge(tr, planes_k, bounds, col_sel,
                                          slot1, num_cmp)
        bounds, ovf2 = zip(*(cut(merged1[k], valid1[k],
                                 splitters[k][me // d_c * d_c:
                                              me // d_c * d_c + d_c - 1],
                                 slot2)
                             for k, me in enumerate(tr.local)))
        merged, valid = _exchange_merge(tr, merged1, bounds, row_sel, slot2,
                                        num_cmp, out_rows)
        ovf = [torch.maximum(a, b) for a, b in zip(ovf1, ovf2)]
    overflow = [o > 0 for o in tr.max(list(ovf))]
    return [([p[0].view(torch.uint32), *p[1:]],
             torch.tensor(v, dtype=torch.int32, device=p[0].device), o)
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


def _run_sharded(keys, payloads, mesh, axis, capacity, cfg, stable,
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
    # the output rows: n_runs x slot of the last phase, a (P, L) block a
    # shard, rows of one (P, D, L) tensor where every shard is on ``home``
    last_group, last_slot = (n_dev, slot) if hier is None else (hier[1],
                                                                slot[1])
    shape = (1 + internal_stable + len(payloads),
             (1 << (last_group - 1).bit_length()) * last_slot)
    home = tr.device(tr.local[0])
    rows = None
    if all(tr.device(i) == home for i in tr.local):
        rows = torch.empty((shape[0], len(tr.local), shape[1]),
                           dtype=torch.int32, device=home)

    def out_rows(k):
        if rows is not None:
            return rows[:, k]
        return torch.empty(shape, dtype=torch.int32,
                           device=tr.device(tr.local[k]))

    outs = _shard_body(tr, shards, pay, n, m, slot, cfg, internal_stable,
                       hier, out_rows)
    del shards, pay
    if rows is not None:
        planes = [rows[0].view(torch.uint32), *rows[1:]]
    else:
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
    a group mesh: this rank's (1, L) row, (1,) count and (1,) flag.
    ``overlap`` (here and in every entry point of this module) is accepted
    for compatibility with the JAX package's API and has no effect: the
    arrivals are merged after the last wave."""
    planes, valid, overflow = _run_sharded(
        keys, (), mesh, axis, capacity, cfg, stable=False, exchange=exchange)
    return planes[0], valid, overflow


def sort_pairs_sharded(keys, values, mesh, axis: str = "d", capacity: int = 4,
                       cfg: SortConfig | None = None, stable: bool = False,
                       overlap: bool = True, exchange: str = "flat"):
    """Distributed key + payload sort; values: any 32-bit dtype, the keys'
    shape.  Returns (sorted_keys, sorted_values, valid, overflow) with the
    rows of ``sort_sharded``.  ``stable=True`` keeps the original order of
    equal keys across the mesh; the index plane that does so runs inside
    every payload sort, so the order is the same either way.  ``overlap``
    has no effect (``sort_sharded``)."""
    planes, valid, overflow = _run_sharded(
        keys, (values,), mesh, axis, capacity, cfg, stable=stable,
        exchange=exchange)
    return planes[0], planes[-1].view(_tensor(values).dtype), valid, overflow


def argsort_sharded(keys, mesh, axis: str = "d", capacity: int = 4,
                    cfg: SortConfig | None = None, overlap: bool = True):
    """Distributed stable argsort: (sorted_keys, global_indices, valid,
    overflow); global_indices[d, i] (int32) is the original flat position
    of sorted_keys[d, i].  ``overlap`` has no effect (``sort_sharded``)."""
    planes, valid, overflow = _run_sharded(
        keys, (), mesh, axis, capacity, cfg, stable=True)
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
    capacity_used); RuntimeError if ``max_capacity`` still overflows.
    ``overlap`` has no effect (``sort_sharded``)."""
    (out, valid), c = _escalate(
        lambda c: sort_sharded(keys, mesh, axis=axis, capacity=c, cfg=cfg,
                               exchange=exchange),
        start_capacity, max_capacity)
    return out, valid, c


def sort_pairs_sharded_auto(keys, values, mesh, axis: str = "d",
                            cfg: SortConfig | None = None,
                            stable: bool = False, overlap: bool = True,
                            exchange: str = "flat", start_capacity: int = 2,
                            max_capacity: int = 64):
    """``sort_sharded_auto`` for key + payload shards: (sorted_keys,
    sorted_values, valid, capacity_used).  ``overlap`` has no effect
    (``sort_sharded``)."""
    (k, v, valid), c = _escalate(
        lambda c: sort_pairs_sharded(keys, values, mesh, axis=axis, capacity=c,
                                     cfg=cfg, stable=stable,
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
