"""Gather of int32 value planes by an index plane on Hopper (no Pallas
counterpart).

The JAX package pushes every value plane through its sort network beside
the compare planes, because a gather is slow on a TPU.  The port sorts only
the two compare planes — (key, tie) for the join's tagged union, (key,
index) for the stable sorts — and then fetches the value planes with
``gather_planes(index, sources, mode)``, which returns new int32 planes of
the index's length:

  * ``"index"``: ``out[g][i] = sources[g][index[i]]`` for 1..4 sources;
  * ``"tagged"``: sources (build values, probe values) and the join's tie
    plane: a tie t < 2^30 gives (build[t], 0), 2^30 <= t < 0x7FFFFFFF gives
    (0, probe[t - 2^30]), the pad tie 0x7FFFFFFF gives (0, 0).

An index outside its source's rows gives 0.  On a CPU tensor the plain
PyTorch version runs.  On a CUDA tensor one of two routes of
radx_tpu_torch/csrc/gather.cu runs, chosen by the sources' size alone:

  * direct (sources of at most ``WINDOW_BYTES`` in all): one launch of
    ``gather_planes`` (``/tagged``): 16-byte index loads, many random reads
    in flight a thread, coalesced stores.  The reads hit L2;
  * partitioned (larger sources): the index is partitioned by the source
    window of ``WINDOW_BYTES`` that each row reads, so that the random
    reads reach the card one L2-sized window at a time.  Five launches
    (``gather_planes/count``, ``/scan``, ``/part``, ``/window``, ``/place``;
    ``gather_planes/tagged/...`` in tagged mode), the last two once a source
    in index mode.  Scratch: the partition P (4 bytes a row: the last
    window's values overwrite it, the others' go into the next source's
    output before it is written) and two tables of 8 bytes a (window,
    tile), the counts and their prefixes (the counts freed before part).

Each step has a plain version (``count_ref`` .. ``place_ref``) that the
wrappers run on CPU tensors and that the card checks hold each kernel
against; ``gather_planes_model`` composes them (the route's position
arithmetic in PyTorch, for the tests).  ``LAUNCHES`` / ``PLAIN_CALLS`` count
the kernels' launches and the plain calls.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from radx_tpu_torch.kernels import _build

MAX_PLANES = 4
PROBE_TIE = 1 << 30
PAD_TIE = 0x7FFFFFFF
# the partitioned route's constants, chosen by a sweep on the H100
# (python -m radx_tpu_torch.bench sweep_gather; PERF.md)
WINDOW_BYTES = 16 << 20  # bytes of one source a window holds
TILE = 1 << 12  # index rows a block of count / part / place takes
MAX_WINDOWS = 1024  # windows of a call, build and probe together
STEPS = ("count", "scan", "part", "window", "place")
KERNELS = ("gather_planes", "gather_planes/tagged",
           *(f"gather_planes/{s}" for s in STEPS),
           *(f"gather_planes/tagged/{s}" for s in STEPS))
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(("gather_planes_ref", "gather_planes_model",
                             *(f"{s}_ref" for s in STEPS)), 0)
_KERNEL = {"index": "gather_planes", "tagged": "gather_planes/tagged"}
_MODE = {"index": 0, "tagged": 1, "side": 2}  # radx_gather_planes's modes


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _take(src, index):
    """src[index] where 0 <= index < len(src), else 0."""
    ok = (index >= 0) & (index < src.numel())
    if src.numel() == 0:
        return torch.zeros_like(index)
    return torch.where(ok, src[index.clamp(0, src.numel() - 1).long()], 0)


def gather_planes_ref(index, sources, mode="index"):
    """Plain version of ``gather_planes``."""
    PLAIN_CALLS["gather_planes_ref"] += 1
    if mode == "index":
        return [_take(s, index) for s in sources]
    build, probe = sources
    is_probe = index >= PROBE_TIE
    return [torch.where(is_probe, 0, _take(build, index)),
            torch.where(is_probe & (index != PAD_TIE),
                        _take(probe, index - PROBE_TIE), 0)]


def _validate(index, sources, mode):
    def ok(x):
        return x.dim() == 1 and x.is_contiguous() and x.dtype == torch.int32

    if mode not in _KERNEL:
        raise ValueError(f"mode must be 'index' or 'tagged', got {mode!r}")
    if not ok(index):
        raise ValueError("the index must be a contiguous 1-D int32 tensor")
    if mode == "tagged" and len(sources) != 2:
        raise ValueError("tagged mode takes two sources (build, probe)")
    if not 1 <= len(sources) <= MAX_PLANES:
        raise ValueError(f"gather_planes takes 1..{MAX_PLANES} sources")
    for s in sources:
        if not ok(s) or s.device != index.device:
            raise ValueError("every source must be a contiguous 1-D int32 "
                             "tensor on the index's device")
    if index.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {index.device}")


def _ptrs(kind, xs):
    return (kind * len(xs))(*xs)


def _empty(n, like):
    return torch.empty(n, dtype=torch.int32, device=like.device)


def direct(index, sources, mode="index"):
    """The direct route: one launch of ``gather_planes`` (``/tagged``) on
    CUDA tensors, the plain version on CPU ones."""
    sources = list(sources)
    _validate(index, sources, mode)
    if index.device.type == "cpu":
        return gather_planes_ref(index, sources, mode)
    outs = [_empty(index.numel(), index) for _ in sources]
    if index.numel():
        _direct_launch(_KERNEL[mode], index, sources, outs, mode)
    return outs


def _direct_launch(name, index, sources, outs, mode):
    _build.launch(LAUNCHES, name, "radx_gather_planes", index.device,
                  index.data_ptr(), index.numel(),
                  _ptrs(ctypes.c_void_p, [s.data_ptr() for s in sources]),
                  _ptrs(ctypes.c_int64, [s.numel() for s in sources]),
                  _ptrs(ctypes.c_void_p, [o.data_ptr() for o in outs]),
                  len(sources), _MODE[mode])


def takes_partitioned(sources) -> bool:
    """The route by size alone: partitioned when the sources hold more than
    one window's bytes."""
    return 4 * sum(s.numel() for s in sources) > WINDOW_BYTES


def gather_planes(index, sources, mode="index"):
    """Int32 planes of ``index``'s length gathered from int32 ``sources``
    by ``index`` (see the module docstring for the two modes and routes)."""
    sources = list(sources)
    _validate(index, sources, mode)
    if index.device.type == "cpu":
        return gather_planes_ref(index, sources, mode)
    route = partitioned if takes_partitioned(sources) else direct
    return route(index, sources, mode)


# --- the partitioned route -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The partitioned route's shape: n index rows in tiles of 2^log_tile,
    sources cut into windows of 2^log_w rows.  Index mode: ``rows0`` is the
    largest source's rows (``rows1`` 0); tagged: the build and probe rows,
    the probe windows numbered after the build ones.  Bucket ``nb`` is the
    null one (an index outside the sources, the pad tie)."""

    n: int
    tagged: bool
    rows0: int
    rows1: int
    log_w: int
    log_tile: int

    def _windows(self, rows):
        return (rows + (1 << self.log_w) - 1) >> self.log_w

    @property
    def nbw(self) -> int:
        return self._windows(self.rows0)

    @property
    def nb(self) -> int:
        return self.nbw + self._windows(self.rows1)

    @property
    def tiles(self) -> int:
        return (self.n + (1 << self.log_tile) - 1) >> self.log_tile

    def name(self, step) -> str:
        return f"gather_planes/{'tagged/' if self.tagged else ''}{step}"

    def args(self):
        return (self.n, self.rows0, self.rows1, self.tagged, self.log_w,
                self.log_tile)


def _log2(x, what, lo, hi):
    if x < lo or x > hi or x & (x - 1):
        raise ValueError(f"{what} must be a power of two in [{lo}, {hi}], "
                         f"got {x}")
    return x.bit_length() - 1


def geometry(index, sources, mode, window_rows=WINDOW_BYTES // 4,
             tile=TILE) -> Geometry:
    """The route's geometry for this call (``window_rows``: a window's rows
    of one source; ``tile``: 2^8..2^13 index rows)."""
    tagged = mode == "tagged"
    geo = Geometry(index.numel(), tagged,
                   sources[0].numel() if tagged else max(s.numel()
                                                         for s in sources),
                   sources[1].numel() if tagged else 0,
                   _log2(window_rows, "window_rows", 1, 1 << 30),
                   _log2(tile, "tile", 1 << 8, 1 << 13))
    if geo.nb > MAX_WINDOWS:
        raise ValueError(f"{geo.nb} windows of {window_rows} rows: at most "
                         f"{MAX_WINDOWS}")
    return geo


def _buckets(index, geo):
    """Each row's bucket: the window its index names, else ``geo.nb``."""
    t = index.long()
    d = torch.full_like(t, geo.nb)
    build = (t >= 0) & (t < geo.rows0)
    if geo.tagged:
        build &= t < PROBE_TIE
        probe = (t >= PROBE_TIE) & (t != PAD_TIE) & (t - PROBE_TIE < geo.rows1)
        d = torch.where(probe, geo.nbw + ((t - PROBE_TIE) >> geo.log_w), d)
    return torch.where(build, t >> geo.log_w, d)


def _tiles(geo, device):
    return torch.arange(geo.n, device=device) >> geo.log_tile


def count_ref(index, geo):
    """Plain ``count``: the rows of bucket d in tile j at [d, j] (int64)."""
    PLAIN_CALLS["count_ref"] += 1
    cells = (geo.nb + 1) * geo.tiles
    key = _buckets(index, geo) * geo.tiles + _tiles(geo, index.device)
    return torch.bincount(key, minlength=cells).view(geo.nb + 1, geo.tiles)


def scan_ref(counts, geo):
    """Plain ``scan``: (each bucket's exclusive prefix of its counts over
    the tiles, the buckets' totals)."""
    PLAIN_CALLS["scan_ref"] += 1
    return counts.cumsum(1) - counts, counts.sum(1)


def _positions(index, geo, offsets, totals):
    """Each row's place in P: its bucket's start (the totals' exclusive
    prefix), its tile's start within the bucket, and its stable rank among
    the tile's rows of that bucket."""
    d = _buckets(index, geo)
    tile = _tiles(geo, index.device)
    cell = tile * (geo.nb + 1) + d  # (tile, bucket) groups
    order = torch.sort(cell, stable=True).indices
    sizes = torch.bincount(cell, minlength=geo.tiles * (geo.nb + 1))
    first = sizes.cumsum(0) - sizes
    rank = torch.empty_like(cell)
    rank[order] = (torch.arange(geo.n, device=index.device)
                   - first[cell[order]])
    base = totals.cumsum(0) - totals
    return base[d] + offsets[d, tile] + rank


def part_ref(index, geo, offsets, totals):
    """Plain ``part``: P, the index rows partitioned by bucket, stably."""
    PLAIN_CALLS["part_ref"] += 1
    p = torch.empty_like(index)
    p[_positions(index, geo, offsets, totals)] = index
    return p


def window_ref(p, sources, geo, out):
    """Plain ``window``: out[k] = the value P[k] names (index mode: of the
    one source given; tagged: of the side the tie names, 0 for the pad)."""
    PLAIN_CALLS["window_ref"] += 1
    if not geo.tagged:
        return out.copy_(_take(sources[0], p))
    build, probe = sources
    is_probe = p >= PROBE_TIE
    return out.copy_(torch.where(
        is_probe, torch.where(p != PAD_TIE, _take(probe, p - PROBE_TIE), 0),
        _take(build, p)))


def place_ref(index, geo, offsets, totals, v, outs):
    """Plain ``place``: each row's value from V at its place in P, into
    ``outs``; tagged: (value, 0) for a build tie, (0, value) for a probe or
    pad tie."""
    PLAIN_CALLS["place_ref"] += 1
    got = v[_positions(index, geo, offsets, totals)]
    if not geo.tagged:
        outs[0].copy_(got)
        return outs
    probe = index >= PROBE_TIE
    outs[0].copy_(torch.where(probe, 0, got))
    outs[1].copy_(torch.where(probe, got, 0))
    return outs


def count(index, geo):
    """(windows + 1, tiles) int64: the rows of each bucket in each tile."""
    if index.device.type == "cpu":
        return count_ref(index, geo)
    counts = torch.empty((geo.nb + 1, geo.tiles), dtype=torch.int64,
                         device=index.device)
    _build.launch(LAUNCHES, geo.name("count"), "radx_gather_count",
                  index.device, index.data_ptr(), *geo.args(),
                  counts.data_ptr())
    return counts


def scan(counts, geo):
    """(offsets, totals) from ``count``'s table: each bucket's exclusive
    prefix of its counts over the tiles, and the buckets' totals (int64)."""
    if counts.device.type == "cpu":
        return scan_ref(counts, geo)
    offsets = torch.empty_like(counts)
    totals = torch.empty(geo.nb + 1, dtype=torch.int64, device=counts.device)
    _build.launch(LAUNCHES, geo.name("scan"), "radx_gather_scan",
                  counts.device, counts.data_ptr(), geo.nb + 1, geo.tiles,
                  offsets.data_ptr(), totals.data_ptr())
    return offsets, totals


def part(index, geo, offsets, totals):
    """P: the index rows partitioned by bucket, stably."""
    if index.device.type == "cpu":
        return part_ref(index, geo, offsets, totals)
    p = torch.empty_like(index)
    _build.launch(LAUNCHES, geo.name("part"), "radx_gather_part",
                  index.device, index.data_ptr(), *geo.args(),
                  offsets.data_ptr(), totals.data_ptr(), p.data_ptr())
    return p


def window(p, sources, geo, out):
    """V (into ``out``, which may be P itself): the values P's rows name,
    in P's order: of ``sources[0]`` in index mode, of the side the tie
    names in tagged mode (sources (build, probe))."""
    if p.device.type == "cpu":
        return window_ref(p, sources, geo, out)
    _direct_launch(geo.name("window"), p, sources, [out],
                   "side" if geo.tagged else "index")
    return out


def place(index, geo, offsets, totals, v, outs):
    """The output planes (one; two when tagged) from V, into ``outs``."""
    if index.device.type == "cpu":
        return place_ref(index, geo, offsets, totals, v, outs)
    _build.launch(LAUNCHES, geo.name("place"), "radx_gather_place",
                  index.device, index.data_ptr(), *geo.args(),
                  offsets.data_ptr(), totals.data_ptr(), v.data_ptr(),
                  outs[0].data_ptr(), outs[-1].data_ptr())
    return outs


_KERNEL_STEPS = (count, scan, part, window, place)
_REF_STEPS = (count_ref, scan_ref, part_ref, window_ref, place_ref)


def _route(index, sources, geo, steps):
    """count, scan, part, then window and place once a value plane (the
    tagged mode's two planes come from one window and one place).  The
    only scratch plane is P: source g's V goes into the output of source
    g + 1, not yet written, and the last source's V over P."""
    count_, scan_, part_, window_, place_ = steps
    offsets, totals = scan_(count_(index, geo), geo)
    p = part_(index, geo, offsets, totals)
    outs = [_empty(geo.n, index) for _ in sources]
    if geo.tagged:
        return place_(index, geo, offsets, totals,
                      window_(p, sources, geo, p), outs)
    for g, s in enumerate(sources):
        v = outs[g + 1] if g + 1 < len(sources) else p
        place_(index, geo, offsets, totals, window_(p, [s], geo, v),
               outs[g: g + 1])
    return outs


def partitioned(index, sources, mode="index", window_rows=WINDOW_BYTES // 4,
                tile=TILE):
    """The partitioned route (kernels on CUDA tensors, their plain versions
    on CPU ones); ``window_rows`` and ``tile`` for sweeps and checks."""
    sources = list(sources)
    _validate(index, sources, mode)
    if index.numel() == 0:
        return [_empty(0, index) for _ in sources]
    geo = geometry(index, sources, mode, window_rows, tile)
    return _route(index, sources, geo, _KERNEL_STEPS)


def gather_planes_model(index, sources, mode, window_rows, tile):
    """The partitioned route's position arithmetic in PyTorch (the plain
    steps composed): bucket counts, their prefixes, stable in-tile ranks,
    P, V, place.  For tests; equals ``gather_planes_ref`` bit for bit."""
    PLAIN_CALLS["gather_planes_model"] += 1
    sources = list(sources)
    _validate(index, sources, mode)
    if index.numel() == 0:
        return [_empty(0, index) for _ in sources]
    geo = geometry(index, sources, mode, window_rows, tile)
    return _route(index, sources, geo, _REF_STEPS)
