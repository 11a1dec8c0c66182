"""Radix distribution sort — port of radx_tpu/kernels/radix_sort.py, the
``strategy="radix"`` engine.

The reference's counting -> partition -> scattering pipeline at chunk
granularity, on the port's kernels:

  1. **phase 1** — every radix chunk of C keys, made of the 1024-key tiles
     {g * n_chunks + c}, sorted ascending (``bitonic.
     sort_chunks_ascending_cyclic``: K4 in shared memory, then cross / finish
     passes with a span of C);
  2. **counting / partition** — the top-byte histograms of the pre-sort
     plane (K10; in a sort from sources, of the caller's key column) give
     the exact digit totals; one launch of K11
     (``rank_runs``) turns them and the sorted regular samples of the
     sorted chunks into the nb - 1 splitters (each sample quantile clamped
     into the digit interval its bucket's target falls in:
     ``clamp_splitters``), their ranks in every sorted chunk, the run
     bounds, the overflow flag and the concatenation's segment tables
     (``run_bounds``);
  3. **scattering** — K12 copies every (chunk, bucket) run into its slot of
     S = C / n_chunks keys, bucket-major, so every bucket is a region of C
     keys made of n_chunks ascending slots;
  4. **merge and concatenation** — K5 (then cross / finish passes with a span
     of C) merges each bucket's slots into one ascending run; K13 puts every
     bucket's valid prefix at its global offset and the fill past n_valid.

The overflow flag (a run longer than its slot: duplicate-heavy keys) is
known after the ranks.  The JAX package computes it on the device and picks
the bitonic result under ``lax.cond``; here it is read on the host once,
after K11, and the pack, merge and concatenation are skipped when it is set:
``sort_radix`` then returns the planes untouched and the caller sorts them
on the bitonic network (ops/sort._engine).  The JAX flag's second part, the
K-window test of its block-spec concatenation, has no counterpart: K13 takes
any number of buckets per output block.

With one compare plane and a rider (group-by's rider sort, which passes
n_valid = total so that the pads keep their neutral riders), rows whose key
is the pad sentinel 0x7FFFFFFF would tie with the slots' fill rows in the
merge, and the valid prefix of the last bucket could take a fill row's rider
in place of a real one.  So in that mode a splitter equal to the sentinel
ends the last bucket, and the sentinel-key rows of every sorted chunk are
copied by K13 straight from the chunk, after the buckets: they never enter a
slot, and the splitter targets do not count them.

A sort from sources (``sort_radix(..., sources=)``, what ``ops/sort.py``
runs in keys, rider and lex2) makes its planes in its own first and last
launches, as the network's sorts do: K4's source form reads the caller's
columns (biased, padded and numbered at load), the counting step reads
the key column itself (``source_counts``: K10 with bias 0 over its rows,
the pads added to digit 255), and K13's unbiasing form writes the keys
back; the output planes are allocated after K12 (``Outputs``), and the
sorted chunks are dropped there where no tail reads them.

Geometry (``plan``) is the JAX package's, field for field, in keys instead
of (rows, 128) tiles: C grows from the mode's chunk tile until C^2 >= 2048 n
(at most 2^19, or 2^20 where even the slot floor needs it), so every padded
bucket region is exactly C keys and a slot holds >= 1024 keys.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radx_tpu_torch.kernels import _build, bitonic, msd, radix

TILE = bitonic.CYCLIC_TILE  # keys per block-cyclic tile (JAX t_rows = 8)
SAMPLE_STRIDE = 128  # keys between splitter samples at the densest rate
# Bucket capacity over the mean load, by slot size in keys (the JAX table by
# slot rows of 128): narrow slots need more room for the per-(chunk,
# bucket) run fluctuation.
HEADROOM = {1024: 1.40, 2048: 1.32}  # >= 4096 keys: _HEADROOM_WIDE
_HEADROOM_WIDE = 1.25
_NS = 2048  # max splitter samples per chunk
MAX_CHUNK = 4096 * 128  # the JAX max_rows, in keys
_SAMPLE_SORT_MIN = 1 << 17  # samples sorted on the bitonic network from here
_SIGN_U32 = 0x80000000


class Plan(NamedTuple):
    C: int  # keys per radix chunk and per padded bucket region
    n_chunks: int
    slot: int  # keys per (bucket, chunk) slot: C / n_chunks
    nb: int  # buckets holding keys
    nb_pad: int  # buckets allocated (JAX rounding)
    s_pad: int  # the JAX splitter table length
    tile: int  # keys per block-cyclic tile


def pick_chunk(n: int, base: int, max_elems: int = MAX_CHUNK) -> int:
    """Smallest power-of-two chunk >= base whose geometry keeps slots of >=
    2048 keys (C^2 >= 2048 n), falling back to the 1024-key slot floor when
    that is unreachable within max_elems (the JAX ``pick_chunk_rows``)."""
    c = base
    while c < max_elems and c * c < 2048 * n:
        c *= 2
    if c * c < 1024 * n:  # not even the slot floor is reachable
        c *= 2
    return c


def plan(n: int, chunk: int) -> Plan | None:
    """Geometry of a radix sort of n keys (a power of two) in chunks of
    ``chunk`` keys, or None where it does not apply (callers use the
    bitonic network)."""
    if chunk <= 0 or n % chunk or n < 4 * chunk:
        return None
    n_chunks = n // chunk
    if chunk % n_chunks:
        return None
    slot = chunk // n_chunks
    if slot < 1024 or slot & (slot - 1):
        return None
    h = HEADROOM.get(slot, _HEADROOM_WIDE)
    nb = int(h * n_chunks) + 1
    nb_pad = max(2 * msd._K, -(-nb // msd._U) * msd._U)
    s_pad = -(-(nb - 1) // 8) * 8
    return Plan(chunk, n_chunks, slot, nb, nb_pad, s_pad, TILE)


def sample_stride(p: Plan) -> tuple[int, int]:
    """(stride, first): the splitter samples of a sorted chunk are its keys
    first + k * stride, ns = min(2048, C / 128) of them."""
    stride = p.C // min(_NS, p.C // SAMPLE_STRIDE)
    return stride, stride // SAMPLE_STRIDE // 2 * SAMPLE_STRIDE


def sample_heads(keys, p: Plan):
    """(n_chunks, ns) int32: the regular samples of each sorted chunk of
    ``keys`` (plane 0), every ``stride``-th key from ``first``
    (``sample_stride``), a contiguous copy: K11 stages them as its heads."""
    stride, first = sample_stride(p)
    return keys.view(p.n_chunks, p.C)[:, first::stride].contiguous()


def sort_samples(heads, sample_tiles):
    """The samples ``heads`` flat and sorted, in a copy: on the keys-only
    network (``sample_tiles``: its (chunk, finish) tiles) from 2^17 of
    them."""
    samples = heads.view(-1)
    if samples.numel() < _SAMPLE_SORT_MIN:
        return torch.sort(samples).values
    samples = samples.clone()
    bitonic.sort_planes(samples, *sample_tiles)
    return samples


def clamp_splitters(samples, totals, p: Plan, n_keys):
    """nb - 1 ascending int32 cut values: the sample quantiles of the sorted
    ``samples`` (those below the sentinel), clamped into the top-byte
    interval that the exact digit CDF (``totals``: keys per top byte)
    assigns each bucket's target j * n_keys / nb.  The plain version of
    ``rank_runs``' prologue."""
    totals = totals.to(torch.int64)
    cdf = torch.cumsum(totals, 0) - totals  # keys with a smaller digit
    nvs = (samples < msd._PAD).sum()
    j = torch.arange(1, p.nb, dtype=torch.int64, device=samples.device)
    spos = (j * nvs // p.nb).clamp(0, samples.numel() - 1)
    sval = samples[spos].to(torch.int64)
    t = j * n_keys // p.nb  # exact bucket targets (int64)
    d = (cdf[None, 1:] <= t[:, None]).sum(1)  # target's top byte, [0, 255]
    lo = (d ^ 128) << 24  # first biased key of that byte
    lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo)
    return torch.minimum(torch.maximum(sval, lo), lo + 0x00FFFFFF).to(
        torch.int32)


def digit_totals(flat_input, p: Plan, n_valid: int):
    """The radix sort's counting step (K10): the top-byte histograms of the
    pre-sort plane's valid prefix per radix chunk, with the digit totals as
    their last row (original uint32 order: pads never count)."""
    return radix.chunk_histograms(flat_input, 24, p.C, n=n_valid,
                                  bias=_SIGN_U32, totals=True)


def sentinel_keys(flat_input, n_valid: int):
    """0-d int64: the sentinel keys among the first n_valid (a PyTorch
    reduction): in the rider mode they skip the buckets."""
    return (flat_input[:n_valid] == msd._PAD).sum()


def choose_splitters(keys, flat_input, p: Plan, n_valid: int, sample_tiles,
                     skip_sentinel: bool = False):
    """nb - 1 ascending int32 cut values: sample quantiles of the sorted
    chunks ``keys`` (plane 0), clamped into the top-byte interval that the
    exact digit CDF of ``flat_input`` (the pre-sort plane, valid prefix
    n_valid: pads never count) assigns each bucket's target.
    ``sample_tiles``: (chunk, finish) tiles of the keys-only network that
    sorts >= 2^17 samples.  ``skip_sentinel``: the sentinel-key rows skip
    the buckets, so the targets count only the other rows, as the samples
    do (else the targets run ahead of the samples and the clamp pins every
    cut to a digit boundary)."""
    totals = digit_totals(flat_input, p, n_valid)[-1]
    n_keys = n_valid
    if skip_sentinel:
        n_keys = n_valid - sentinel_keys(flat_input, n_valid)
    return clamp_splitters(sort_samples(sample_heads(keys, p), sample_tiles),
                           totals, p, n_keys)


def source_counts(s: bitonic.Source, p: Plan, n_valid: int, row0: int,
                  tail: bool):
    """(digit totals, sentinel keys or None) of the pre-sort plane's first
    n_valid rows in a sort whose planes its first launch makes from
    sources: read from the key source ``s`` over its own rows [row0, row0 +
    n_valid), equal bit for bit to ``digit_totals`` and ``sentinel_keys``
    of the plane it makes.  The columns' rows are counted by K10 with the
    bias that gives the plane's digits (0 for the caller's uint32 keys:
    their own top byte); the rows past the source hold its pad (the
    biased 0xFFFFFFFF: digit 255, a sentinel key), added to its digit and,
    with ``tail``, to the sentinel keys (a PyTorch reduction over the
    columns' rows)."""
    dev = bitonic.source_device([s])
    bias = (s.xor ^ _SIGN_U32) & 0xFFFFFFFF
    totals = torch.zeros(256, dtype=torch.int32, device=dev)
    pads = torch.zeros((), dtype=torch.int64, device=dev) if tail else None
    off = 0
    for col in s.cols:  # the column's rows in [row0, row0 + n_valid)
        a, b = max(off, row0), min(off + col.numel(), row0 + n_valid)
        if a < b:
            rows = col[a - off: b - off]
            totals += radix.histograms(rows, p.C, 24, bias, totals=True)[-1]
            if tail:
                pads += (rows == (msd._PAD ^ s.xor)).sum()
        off += col.numel()
    fill = max(row0 + n_valid - s.n, 0)
    if fill:
        totals[((s.pad ^ _SIGN_U32) >> 24) & 255] += fill
        if tail and s.pad == msd._PAD:
            pads += fill
    return totals, pads


def rank_args(keys, flat_input, p: Plan, n_valid: int, sample_tiles,
              tail: bool, row0: int = 0) -> tuple:
    """The arguments of ``rank_runs`` in a radix sort: the sorted chunks
    ``keys``, their samples (heads, and sorted on the network of
    ``sample_tiles``), the digit totals of the pre-sort plane
    ``flat_input`` (K10), and with ``tail`` its sentinel keys.  In a sort
    from sources ``flat_input`` is the key ``bitonic.Source`` and the
    counts come from its rows from ``row0`` (``source_counts``)."""
    if isinstance(flat_input, bitonic.Source):
        totals, pads = source_counts(flat_input, p, n_valid, row0, tail)
    else:
        totals = digit_totals(flat_input, p, n_valid)[-1]
        pads = sentinel_keys(flat_input, n_valid) if tail else None
    heads = sample_heads(keys, p)
    return (keys, heads, sort_samples(heads, sample_tiles), totals, p,
            n_valid, pads, tail)


class Bounds(NamedTuple):
    bounds: torch.Tensor  # (n_chunks, nb_pad + 1) int32 run bounds
    overflow: torch.Tensor  # 0-d bool: a run longer than its slot
    start: torch.Tensor  # int64 segment starts of the concatenation
    src: torch.Tensor  # int64 segment sources (merged, then sorted chunks)


def run_bounds(ranks, p: Plan, n_valid: int, tail: bool) -> Bounds:
    """Run bounds, overflow flag and concatenation segments from the ranks
    (n_chunks, nb - 1; with ``tail``, one more column: the rank of the
    sentinel, whose rows skip the buckets)."""
    dev = ranks.device
    r = ranks.to(torch.int64)
    g = (torch.arange(p.C // p.tile, device=dev)[:, None] * p.n_chunks
         + torch.arange(p.n_chunks, device=dev)[None, :])
    valid = (n_valid - g * p.tile).clamp(0, p.tile).sum(0)  # per chunk
    top = r[:, p.nb - 1] if tail else valid
    bounds = torch.cat((torch.zeros(p.n_chunks, 1, dtype=torch.int64,
                                    device=dev),
                        r[:, : p.nb - 1],
                        top[:, None].expand(p.n_chunks, p.nb_pad + 1 - p.nb)),
                       1)
    counts = bounds[:, 1:] - bounds[:, :-1]
    overflow = counts.max() > p.slot
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    start = torch.cat((zero, torch.cumsum(counts.sum(0), 0)))
    src = torch.arange(p.nb_pad, device=dev) * p.C
    if tail:
        start = torch.cat((start, start[-1] + torch.cumsum(valid - top, 0)))
        src = torch.cat((src, torch.arange(p.n_chunks, device=dev) * p.C
                         + top))
    return Bounds(bounds.to(torch.int32).contiguous(), overflow, start, src)


# --- K11: from the samples to the run bounds, one launch -----------------------

# the kernel's geometry (csrc/radix.cu): threads a block (one block a
# chunk), keys a window part (a 16-byte load a lane)
RANK_THREADS, RANK_PART = 1024, 128


class Ranked(NamedTuple):
    splitters: torch.Tensor  # (m,) int32: nb - 1 cuts (+ the sentinel: tail)
    bounds: torch.Tensor  # (n_chunks, nb_pad + 1) int32 run bounds
    overflow: torch.Tensor  # 0-d int64: 1 where a run outgrows its slot
    start: torch.Tensor  # int64 segment starts of the concatenation
    src: torch.Tensor  # int64 segment sources (merged, then sorted chunks)

    @property
    def ranks(self):
        """(n_chunks, m) int32: the keys below each splitter in each chunk,
        columns 1..m of the bounds."""
        return self.bounds[:, 1: 1 + self.splitters.numel()]


def rank_runs_ref(keys, heads, samples, totals, p, n_valid, pads,
                  tail) -> Ranked:
    """Plain version of ``rank_runs``: ``clamp_splitters`` (the sentinel
    appended with ``tail``) -> ``msd.splitter_ranks_ref`` ->
    ``run_bounds`` (``heads`` unused)."""
    n_keys = n_valid if pads is None else n_valid - pads
    spl = clamp_splitters(samples, totals, p, n_keys)
    if tail:
        spl = torch.cat((spl, spl.new_full((1,), msd._PAD)))
    b = run_bounds(msd.splitter_ranks_ref(keys, spl, p.C), p, n_valid, tail)
    return Ranked(spl, b.bounds, b.overflow.to(torch.int64), b.start, b.src)


def rank_runs(keys, heads, samples, totals, p: Plan, n_valid: int, pads=None,
              tail: bool = False) -> Ranked:
    """K11 ``radix_rank``: from the sorted chunks ``keys`` (plane 0), their
    regular samples (``sample_heads``) and those sorted (``sort_samples``),
    and the 256 digit totals (the last row of ``digit_totals``) to the
    splitters (``clamp_splitters`` with targets over n_valid keys, less
    ``pads``, a 0-d int64 of sentinel keys, where given; with ``tail``, the
    sentinel appended), their ranks in every chunk, and ``run_bounds``'
    outputs.  On a CUDA tensor one launch (and one ``torch.zeros`` of its
    buffer); on a CPU tensor the plain composition ``rank_runs_ref``."""
    stride, first = sample_stride(p)
    if (keys.dtype != torch.int32 or samples.dtype != torch.int32
            or totals.dtype != torch.int32 or totals.shape != (256,)
            or heads.dtype != torch.int32
            or heads.shape != (p.n_chunks, p.C // stride)
            or keys.numel() != p.n_chunks * p.C or samples.dim() != 1
            or not (keys.is_contiguous() and samples.is_contiguous()
                    and totals.is_contiguous() and heads.is_contiguous())
            or (pads is not None and (pads.dtype != torch.int64
                                      or pads.numel() != 1))):
        raise ValueError("expected int32 chunks, heads, samples and 256 "
                         "totals (pads: one int64)")
    dev = keys.device
    if (samples.device != dev or totals.device != dev or heads.device != dev
            or (pads is not None and pads.device != dev)):
        raise ValueError("expected tensors on one device")
    if dev.type == "cpu":
        return rank_runs_ref(keys, heads, samples, totals, p, n_valid, pads,
                             tail)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if keys.data_ptr() % 16:
        raise ValueError("the sorted chunks must be 16-byte aligned")
    m = p.nb - 1 + tail
    n_seg = p.nb_pad + (p.n_chunks if tail else 0)
    cells = p.n_chunks * (p.nb_pad + 1)
    # one zeroed int64 buffer: the scratch (ticket, bucket sums, tail
    # counts), the flag, start, src, then the int32 bounds and splitters
    flag = 1 + p.nb_pad + p.n_chunks
    start = flag + 1
    src = start + n_seg + 1
    ints = src + n_seg
    buf = torch.zeros(ints + (cells + m + 1) // 2, dtype=torch.int64,
                      device=dev)
    at = buf.data_ptr()
    _build.launch(msd.LAUNCHES, "radix_rank", "radx_radix_rank", dev,
                  keys.data_ptr(), p.n_chunks, p.C.bit_length() - 1,
                  heads.data_ptr(), stride.bit_length() - 1, first,
                  samples.data_ptr(), samples.numel(), totals.data_ptr(),
                  None if pads is None else pads.data_ptr(), n_valid,
                  p.tile.bit_length() - 1, p.slot.bit_length() - 1, p.nb,
                  p.nb_pad, int(tail), at + 8 * ints + 4 * cells,
                  at + 8 * ints, at + 8 * start, at + 8 * src, at + 8 * flag,
                  at)
    i32 = buf[ints:].view(torch.int32)
    bounds = i32[:cells].view(p.n_chunks, p.nb_pad + 1)
    return Ranked(i32[cells: cells + m], bounds, buf[flag], buf[start:src],
                  buf[src:ints])


def _samples_below_pad(samples, threads=RANK_THREADS):
    """The kernel's count of the sorted samples below the sentinel: a probe
    every w = ceil(S / threads) samples, then the w - 1 samples after the
    last probe below it."""
    n = samples.numel()
    w = -(-n // threads)
    below = int((samples[::w] < msd._PAD).sum())
    if below == 0:
        return 0
    base = (below - 1) * w + 1
    return base + int((samples[base: min(base + w - 1, n)] < msd._PAD).sum())


def _chunk_valid(n_valid, c, p: Plan):
    """The kernel's rows below n_valid in chunk c: its block-cyclic tiles
    g * n_chunks + c, the first n_valid // tile of all tiles whole."""
    tiles = p.C // p.tile
    full, rem = divmod(n_valid, p.tile)
    whole = min(-(-(full - c) // p.n_chunks), tiles) if full > c else 0
    part = rem and full % p.n_chunks == c and full // p.n_chunks < tiles
    return whole * p.tile + (rem if part else 0)


def rank_runs_model(keys, heads, samples, totals, p: Plan, n_valid: int,
                    pads=None, tail: bool = False) -> Ranked:
    """Pure-torch model of the ``radix_rank`` kernel, for the CPU tests:
    the prologue (the digit CDF, ``_samples_below_pad``, each splitter's
    target and its top byte by a binary search of the CDF, the clamp), the
    two-level search (i of the chunk's ``heads``, its keys first + k *
    stride, below the splitter leave the window of stride keys from first +
    (i - 1) * stride, or from 0, or to C; the keys below the splitter there,
    in parts of 128), and the epilogue (each chunk's bounds row, bucket
    sizes, overflow and tail count; the last block's scan of the bucket
    sums, then of the tail counts, into the starts)."""
    msd.PLAIN_CALLS["radix_rank_model"] += 1
    m = p.nb - 1 + tail
    n = samples.numel()
    tot = totals.to(torch.int64)
    cdf = (torch.cumsum(tot, 0) - tot).tolist()
    nvs = _samples_below_pad(samples)
    n_keys = n_valid if pads is None else n_valid - int(pads)
    spl = []
    for j in range(1, m + 1):
        if j >= p.nb:  # the tail's sentinel
            spl.append(msd._PAD)
            continue
        sval = int(samples[min(j * nvs // p.nb, n - 1)])
        t = j * n_keys // p.nb
        lo, hi = 1, 256
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (mid + 1, hi) if cdf[mid] <= t else (lo, mid)
        dlo = ((lo - 1) ^ 128) << 24
        dlo -= (dlo >= 1 << 31) << 32
        spl.append(min(max(sval, dlo), dlo + 0x00FFFFFF))
    splitters = torch.tensor(spl, dtype=torch.int32)

    stride, first = sample_stride(p)
    x = keys.view(p.n_chunks, p.C)
    s = splitters.expand(p.n_chunks, m).contiguous()
    i = torch.searchsorted(heads, s)
    w0 = torch.where(i == 0, 0, first + (i - 1) * stride).clamp(
        max=p.C - stride)
    ranks = w0.clone()
    for part in range(0, stride, RANK_PART):
        idx = (w0 + part)[..., None] + torch.arange(RANK_PART)
        window = x.gather(1, idx.view(p.n_chunks, -1)).view(p.n_chunks, m, -1)
        ranks += (window < s[..., None]).sum(2)

    bounds = torch.empty(p.n_chunks, p.nb_pad + 1, dtype=torch.int64)
    scratch = torch.zeros(1 + p.nb_pad + p.n_chunks, dtype=torch.int64)
    src = torch.empty(p.nb_pad + (p.n_chunks if tail else 0),
                      dtype=torch.int64)
    overflow = False
    for c in range(p.n_chunks):
        valid = _chunk_valid(n_valid, c, p)
        top = int(ranks[c, p.nb - 1]) if tail else valid
        bounds[c] = torch.cat((torch.zeros(1, dtype=torch.int64),
                               ranks[c, : p.nb - 1],
                               torch.full((p.nb_pad + 1 - p.nb,), top)))
        sizes = bounds[c, 1: p.nb + 1] - bounds[c, : p.nb]
        overflow |= bool((sizes > p.slot).any())
        scratch[1: 1 + p.nb] += sizes
        if tail:
            scratch[1 + p.nb_pad + c] = valid - top
            src[p.nb_pad + c] = c * p.C + top
    src[: p.nb_pad] = torch.arange(p.nb_pad) * p.C
    start = torch.cat((torch.zeros(1, dtype=torch.int64),
                       torch.cumsum(scratch[1: 1 + src.numel()], 0)))
    return Ranked(splitters, bounds.to(torch.int32),
                  torch.tensor(int(overflow), dtype=torch.int64), start, src)


class Outputs(NamedTuple):
    """The output planes that a sort from sources allocates itself, of
    ``total`` rows each: the radix sort after K12's pack, when its largest
    buffers are gone, the network before its first launch.  With
    ``key_rows``, the last launch stores plane 0 as its first key_rows keys
    unbiased: in place where they are the whole plane, else into a tensor
    of key_rows rows, which takes plane 0's place in the result (the radix
    sort then allocates no plane 0)."""

    total: int
    key_rows: int | None = None

    def make(self, planes: int, device, whole_key: bool):
        """(planes, key_out): the new planes and the keys' store
        (``bitonic.sort_sources``' / ``msd.concat``'s).  Where the keys go
        to a tensor of their own and ``whole_key`` is false (the radix
        sort's K13 needs no plane 0), plane 0 is None, or with one plane
        the keys' tensor itself."""
        def new(rows):
            return torch.empty(rows, dtype=torch.int32, device=device)

        own = self.key_rows not in (None, self.total)
        keys = new(self.key_rows) if own else None
        first = (new(self.total) if whole_key or not own
                 else keys if planes == 1 else None)
        out = [first, *(new(self.total) for _ in range(planes - 1))]
        if self.key_rows is None:
            return out, None
        return out, (keys if own else first, 0)

    @staticmethod
    def result(planes, key_out):
        """The sorted planes, plane 0 the stored keys where ``key_out``."""
        return planes if key_out is None else [key_out[0], *planes[1:]]


def sort_radix(planes, chunk, num_cmp, cfg, n_valid=None, sources=None,
               row0=0, key_out=None):
    """Radix-distribution-sort int32 planes in place: ascending by plane 0,
    then plane 1 when num_cmp == 2; further planes ride along.  The length
    is a power of two with ``plan(len, chunk)`` not None; rows past
    ``n_valid`` (default all) hold the sentinel fill (``msd._fill``) and come
    out as the fill.  ``cfg`` gives the network tiles of the mode.

    ``sources`` (one ``bitonic.Source`` a plane, from source row ``row0``;
    keys, rider and lex2): the sort makes its planes in its own first and
    last launches.  K4 reads the planes' rows from the sources, biased,
    padded and numbered as it loads them (``chunk_sort_cyclic_sources``),
    the counting step reads the key source (``source_counts``), and
    ``planes`` are written by K13, never read: planes from ``torch.empty``
    (the arbitrary-N last piece), or ``Outputs``, the planes this function
    allocates after K12's pack.  ``key_out`` = (out, row): K13 stores
    plane 0's keys unbiased there (``msd.concat``), as ``Outputs.key_rows``
    does for planes it allocates.

    Returns (planes, overflow): with overflow True a run overflowed its
    slot, nothing was written (no plane allocated) and the caller sorts the
    planes otherwise (from the same sources, where given)."""
    total = planes.total if isinstance(planes, Outputs) else planes[0].numel()
    p = plan(total, chunk)
    if p is None:
        raise ValueError(f"no radix plan for {total} keys in chunks of {chunk}")
    n_valid = total if n_valid is None else int(n_valid)
    np_ = len(planes if sources is None else sources)
    tiles = cfg.mode_tiles(np_, num_cmp)
    tail = num_cmp == 1 and np_ == 2

    if sources is None:
        sorted_ = bitonic.sort_chunks_ascending_cyclic(planes, num_cmp, p.C,
                                                       *tiles)
        counted = planes[0]
    else:
        dev = bitonic.source_device(sources)
        sorted_ = bitonic.sort_chunks_ascending_cyclic(
            [torch.empty(total, dtype=torch.int32, device=dev)
             for _ in sources], num_cmp, p.C, *tiles, sources=sources,
            row0=row0)
        counted = sources[0]
    b = rank_runs(*rank_args(sorted_[0], counted, p, n_valid,
                             cfg.mode_tiles(1, 1), tail, row0))
    if bool(b.overflow):  # the one host read
        return planes, True

    packed = msd.pack(sorted_, b.bounds, p.C, p.slot, p.nb_pad, num_cmp)
    if not tail:  # only the rider mode's sentinel rows come from sorted_
        sorted_ = None
    merged = bitonic.merge_slots_ascending(packed, num_cmp, p.C, p.slot,
                                           *tiles)
    del packed
    if isinstance(planes, Outputs):
        planes, key_out = planes.make(np_, merged[0].device, False)
    msd.concat(merged, sorted_, planes, b.start, b.src, p.nb_pad, num_cmp,
               key_out)
    return Outputs.result(planes, key_out), False
