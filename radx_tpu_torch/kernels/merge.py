"""Merge of two ascending runs of int32 planes on Hopper (no Pallas
counterpart).

The JAX package's distributed sort merges the runs a shard receives with
the bitonic network's run merge over sentinel-padded slots of a fixed size
(``radx_tpu/parallel/dist_sort.py:112-126``): XLA needs static shapes.  The
port sends each run at its own length and merges two runs of any lengths
with ``merge_runs(a, b, num_cmp, out=None, key_xor=0)``:

  * ``a`` / ``b``: lists of the same number (1..4) of 1-D int32 planes, the
    planes of one run of equal length, plane 0 the sign-biased key;
  * the order is plane 0's (``num_cmp`` = 1) or (plane 0, plane 1)'s
    (``num_cmp`` = 2), both as signed int32; A's row comes first on a tie;
  * ``out``: the planes to write, |a| + |b| rows each (new ones when None),
    no overlap with a or b; ``key_xor`` is XORed into plane 0 as it is
    stored.  Returns the output planes.

On a CUDA tensor radx_tpu_torch/csrc/merge.cu runs in one launch: a
persistent grid whose blocks own contiguous ranges of output tiles
(``THREADS`` x ``ITEMS[planes]`` rows), find the splits of
their ranges' ends by a block-wide search, and stream both runs through a
ring in shared memory with 16-byte asynchronous loads (``merge_runs_model``
is that partition on the CPU); a launch that fails raises.  On a CPU tensor
the plain PyTorch version runs: each row's output position by
``searchsorted`` on an int64 composite of its compare planes, then one
scatter a plane.  ``LAUNCHES`` / ``PLAIN_CALLS`` count the launches and the
plain calls.
"""

from __future__ import annotations

import ctypes

import torch

from radx_tpu_torch.kernels import _build

MAX_PLANES = 4
THREADS = 256  # threads a block (csrc/merge.cu kThreads)
PROBES = THREADS // 2  # probes a block-range boundary search a round
ITEMS = {1: 15, 2: 7, 3: 7, 4: 7}  # output rows a thread, by plane count
TILE = THREADS * ITEMS[1]  # output rows a tile of one plane
KERNELS = ("merge_runs",)
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(("merge_runs_ref", "merge_path_ref"), 0)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def ring_rows(tile):
    """Rows of a run's ring (csrc/merge.cu ``ring_rows``): the power of two
    that holds two tiles' windows and the 16-byte groups' rounding."""
    ring = 4
    while ring < 2 * tile + 8:
        ring *= 2
    return ring


def _items(planes, items):
    """The model's rows a thread: the kernel's (``ITEMS``) unless given; 7
    or 15, 15 for at most 3 planes (4 planes' ring of 15-row tiles exceeds
    shared memory)."""
    items = ITEMS[planes] if items is None else items
    if items not in (7, 15) or (items == 15 and planes > 3):
        raise ValueError(f"items must be 7 or 15 (15 for at most 3 planes), "
                         f"got {items} for {planes} planes")
    return items


def _validate(a, b, num_cmp, out):
    def ok(x, dev):
        return (x.dim() == 1 and x.is_contiguous() and x.dtype == torch.int32
                and x.device == dev)

    if num_cmp not in (1, 2):
        raise ValueError(f"num_cmp must be 1 or 2, got {num_cmp}")
    if not num_cmp <= len(a) == len(b) <= MAX_PLANES:
        raise ValueError(f"merge_runs takes {num_cmp}..{MAX_PLANES} planes a "
                         f"run, the same number for both, got {len(a)} and "
                         f"{len(b)}")
    dev = a[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    na, nb = a[0].numel(), b[0].numel()
    for run, rows in ((a, na), (b, nb)):
        if not all(ok(p, dev) and p.numel() == rows for p in run):
            raise ValueError("every plane must be a contiguous 1-D int32 "
                             "tensor on one device, a run's planes of one "
                             "length")
    if out is not None and (len(out) != len(a) or not all(
            ok(o, dev) and o.numel() == na + nb for o in out)):
        raise ValueError(f"out must be {len(a)} contiguous 1-D int32 planes "
                         f"of {na + nb} rows on {dev}")


def _composite(planes, num_cmp):
    """int64 whose order is the rows' compare order."""
    key = planes[0].long()
    if num_cmp == 1:
        return key
    return (key << 32) + (planes[1].long() + (1 << 31))


def _positions(a, b, num_cmp):
    """Each row's output position: A's before B's on a tie."""
    ca, cb = _composite(a, num_cmp), _composite(b, num_cmp)
    pos_a = torch.arange(ca.numel(), device=ca.device) + torch.searchsorted(
        cb, ca, side="left")
    pos_b = torch.arange(cb.numel(), device=cb.device) + torch.searchsorted(
        ca, cb, side="right")
    return pos_a, pos_b


def _tiles(n, tile=TILE):
    return (n + tile - 1) // tile


def merge_path_ref(a, b, num_cmp=1):
    """For each tile boundary d = t * TILE (and the end), the rows of A
    among the first d output rows (int64, tiles + 1 of them): the splits
    that ``merge_runs``' blocks find at the ends of their ranges."""
    PLAIN_CALLS["merge_path_ref"] += 1
    n = a[0].numel() + b[0].numel()
    pos_a, _ = _positions(a, b, num_cmp)
    d = (torch.arange(_tiles(n) + 1, device=pos_a.device) * TILE).clamp_(
        max=n)
    return torch.searchsorted(pos_a, d)


def merge_runs_ref(a, b, num_cmp=1, out=None, key_xor=0):
    """Plain version of ``merge_runs``."""
    PLAIN_CALLS["merge_runs_ref"] += 1
    a, b = list(a), list(b)
    _validate(a, b, num_cmp, out)
    n = a[0].numel() + b[0].numel()
    if out is None:
        out = [torch.empty(n, dtype=torch.int32, device=a[0].device)
               for _ in a]
    pos_a, pos_b = _positions(a, b, num_cmp)
    for o, pa, pb in zip(out, a, b):
        o[pos_a] = pa
        o[pos_b] = pb
    if key_xor:
        out[0].bitwise_xor_(key_xor)
    return out


def merge_path(a, b, num_cmp=1):
    """``merge_path_ref`` of CPU planes.  The card has no path launch:
    ``merge_runs``' blocks search their own splits, so CUDA planes raise."""
    a, b = list(a), list(b)
    _validate(a, b, num_cmp, None)
    if a[0].device.type != "cpu":
        raise ValueError("merge_path runs on CPU planes only: on the card "
                         "merge_runs finds its own splits")
    return merge_path_ref(a, b, num_cmp)


def _ptrs(planes):
    return (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))


def merge_runs(a, b, num_cmp=1, out=None, key_xor=0):
    """The sorted union of two ascending runs (module docstring)."""
    a, b = list(a), list(b)
    _validate(a, b, num_cmp, out)
    if a[0].device.type == "cpu":
        return merge_runs_ref(a, b, num_cmp, out, key_xor)
    n = a[0].numel() + b[0].numel()
    if out is None:
        out = [torch.empty(n, dtype=torch.int32, device=a[0].device)
               for _ in a]
    if n:
        _build.launch(LAUNCHES, "merge_runs", "radx_merge_runs", a[0].device,
                      _ptrs(a), a[0].numel(), _ptrs(b), b[0].numel(),
                      _ptrs(out), len(a), num_cmp, key_xor)
    return out


# --- the kernel's partition on the CPU -------------------------------------


def _misalign(t):
    """Rows past the last 16-byte boundary of a plane's first row."""
    return (t.data_ptr() >> 2) & 3


def block_splits_model(ca, cb, d):
    """The kernel's search for the split of diagonal ``d`` (A's rows among
    the first d output rows) over compare values ``ca`` / ``cb`` (lists
    whose order is the rows'): ``PROBES`` evenly spaced probes a round,
    keeping the gap after the last one that takes A's row.  Returns
    (split, rounds)."""
    lo, hi = max(0, d - len(cb)), min(d, len(ca))
    rounds = 0
    while lo < hi:
        rounds += 1
        step = -(-(hi - lo) // PROBES)
        probes = range(lo, hi, step)
        c = sum(1 for p in probes if ca[p] <= cb[d - 1 - p])
        assert all(ca[p] <= cb[d - 1 - p] for p in probes[:c])  # a prefix
        if c == 0:
            hi = lo
        else:
            last = lo + (c - 1) * step
            lo, hi = last + 1, min(hi, last + step)
    return lo, rounds


class _Ring:
    """One run's ring of ``ring`` slots a plane, as the kernel fills it: a
    plane's row x lies in slot (x + m) mod ring, m its misalignment; each
    slot remembers the row and the cp.async group of its last fill, so
    that a read of a row that is not there, or whose group has not
    landed, fails."""

    def __init__(self, planes, ring, stats):
        self.rows = [p.tolist() for p in planes]
        self.m = [_misalign(p) for p in planes]
        self.n, self.ring, self.stats = planes[0].numel(), ring, stats
        self.slot = [[None] * ring for _ in planes]  # (row, group)
        self.val = [[0] * ring for _ in planes]

    def fill(self, frm, to, first, group):
        """Rows [frm, to): the 16-byte groups of their aligned-down
        superset (``first``: also the one holding row ``frm``)."""
        for p, m in enumerate(self.m):
            u0 = (frm + m + (0 if first else 3)) & ~3
            u1 = (to + m + 3) & ~3
            for u in range(u0, u1, 4):
                x = u - m
                whole = x >= 0 and x + 4 <= self.n
                self.stats["cp16" if whole else "cp4"] += (
                    1 if whole else sum(0 <= x + e < self.n
                                        for e in range(4)))
                for e in range(4):
                    if 0 <= x + e < self.n:
                        s = (u + e) % self.ring
                        self.slot[p][s] = (x + e, group)
                        self.val[p][s] = self.rows[p][x + e]
                        self.stats["rows_loaded"] += 1

    def read(self, p, x, landed):
        """Row x of plane p; every group up to ``landed`` has landed."""
        s = (x + self.m[p]) % self.ring
        row, group = self.slot[p][s] or (None, None)
        assert row == x and group <= landed, (p, x, row, group, landed)
        return self.val[p][s]


def merge_runs_model(a, b, num_cmp=1, key_xor=0, *, blocks, items=None,
                     out=None):
    """``merge_runs`` as csrc/merge.cu partitions it, in plain Python over
    CPU planes: ``blocks`` blocks own contiguous ranges of output tiles
    (``THREADS`` x ``items`` rows; ``items``: the kernel's ``ITEMS`` unless
    given, 7 or 15), find the splits of their ends by
    ``block_splits_model``, stream both runs through their rings
    (``_Ring``: the first tile's windows, then two tiles ahead, the
    next-but-one group in flight), and each thread merges ``items`` rows
    from its own split of the tile, serially; the stage is stored in
    16-byte groups where the output's address allows.  Returns (out,
    stats): stats counts the search rounds, cp.async instructions, rows
    loaded and 16-byte and scalar stores."""
    a, b = list(a), list(b)
    _validate(a, b, num_cmp, out)
    P = len(a)
    vt = _items(P, items)
    tile = THREADS * vt
    ring = ring_rows(tile)
    na, nb = a[0].numel(), b[0].numel()
    n = na + nb
    if out is None:
        out = [torch.empty(n, dtype=torch.int32) for _ in a]
    stats = dict.fromkeys(("rounds", "cp16", "cp4", "rows_loaded",
                           "store16", "store4"), 0)

    ca, cb = (_composite(r, num_cmp).tolist() for r in (a, b))
    res = [o.tolist() for o in out]
    mo = [_misalign(o) for o in out]
    written = [0] * n
    tiles = _tiles(n, tile)
    if not 1 <= blocks <= max(tiles, 1):
        raise ValueError(f"blocks must be 1..{max(tiles, 1)}, got {blocks}")
    for blk in range(blocks if n else 0):
        t0, t1 = blk * tiles // blocks, (blk + 1) * tiles // blocks
        d_begin, d_end = t0 * tile, min(t1 * tile, n)
        (ia, r0), (ia_end, r1) = (block_splits_model(ca, cb, d_begin),
                                  block_splits_model(ca, cb, d_end))
        stats["rounds"] = max(stats["rounds"], r0, r1)
        jb, jb_end = d_begin - ia, d_end - ia_end
        ra, rb = _Ring(a, ring, stats), _Ring(b, ring, stats)
        group = 0
        fa, fb = min(ia + tile, ia_end), min(jb + tile, jb_end)
        ra.fill(ia, fa, True, group)
        rb.fill(jb, fb, True, group)
        group += 1
        ta, tb = min(ia + 2 * tile, ia_end), min(jb + 2 * tile, jb_end)
        ra.fill(fa, ta, False, group)
        rb.fill(fb, tb, False, group)
        fa, fb = ta, tb
        for d0 in range(d_begin, d_end, tile):
            landed = group - 1  # cp.async.wait_group 1
            length = min(tile, d_end - d0)
            na_av, nb_av = min(tile, ia_end - ia), min(tile, jb_end - jb)

            def ka(x):
                return _row_key(ra, ia + x, num_cmp, landed)

            def kb(x):
                return _row_key(rb, jb + x, num_cmp, landed)

            took = None
            for t in range(THREADS):
                dt = min(t * vt, length)
                lo, hi = max(0, dt - nb_av), min(dt, na_av)
                while lo < hi:
                    mid = (lo + hi) >> 1
                    if ka(mid) <= kb(dt - 1 - mid):
                        lo = mid + 1
                    else:
                        hi = mid
                i, j = lo, dt - lo
                for k in range(vt):
                    if dt + k >= length:
                        break
                    take_a = j >= nb_av or (i < na_av and ka(i) <= kb(j))
                    run, x = (ra, ia + i) if take_a else (rb, jb + j)
                    row = d0 + dt + k
                    for p in range(P):
                        v = run.read(p, x, landed)
                        res[p][row] = _i32(v ^ key_xor if p == 0 else v)
                    written[row] += 1
                    i, j = i + take_a, j + (not take_a)
                if dt < length <= dt + vt:
                    took = i
            ia, jb = ia + took, jb + length - took
            group += 1
            ta, tb = min(ia + 2 * tile, ia_end), min(jb + 2 * tile, jb_end)
            ra.fill(fa, ta, False, group)
            rb.fill(fb, tb, False, group)
            fa, fb = ta, tb
            for m in mo:
                sh = (d0 + m) % 4
                for g in range((length + sh + 3) >> 2):
                    x = 4 * g - sh
                    whole = x >= 0 and x + 4 <= length
                    assert not whole or (d0 + x + m) % 4 == 0
                    stats["store16" if whole else "store4"] += (
                        1 if whole else sum(0 <= x + e < length
                                            for e in range(4)))
        assert (ia, jb) == (ia_end, jb_end)
    assert written == [1] * n
    for o, r in zip(out, res):
        o.copy_(torch.tensor(r, dtype=torch.int32))
    return out, stats


def _row_key(ring, x, num_cmp, landed):
    """The compare value (``_composite``'s) of a ring's row x."""
    key = ring.read(0, x, landed)
    if num_cmp == 1:
        return key
    return (key << 32) + ring.read(1, x, landed) + (1 << 31)


def _i32(v):
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)
