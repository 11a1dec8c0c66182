"""Sort configuration for the PyTorch/CUDA port (counterpart of radx_tpu/config.py).

The JAX package sizes its bitonic network in (rows, 128) VMEM tiles and keeps
a per-TPU tuning table.  On Hopper the limits are a block's shared memory and
registers, so the port names its tiles in elements:

  * ``chunk_elems`` — the chunk-sort tile: one thread block sorts this many
    keys in shared memory through bitonic stages 1..log2(chunk_elems).
  * ``finish_elems`` — the finish tile: at every merge level, the distances
    below this run inside one block's shared memory; the distances at or
    above it run as cross passes over global memory.

Both are powers of two with ``finish_elems >= chunk_elems``.  A CUDA launch
also needs the tile to fit one block's shared memory (4 bytes x planes x
tile <= ``MAX_SMEM_BYTES``); the plain PyTorch versions on the CPU
take any size.  The relational paths have tiles of their own:

  * ``rider_chunk_elems`` / ``rider_finish_elems`` — the same two tiles for
    the (key, rider) sort of group-by (two planes in shared memory);
  * ``stable_chunk_elems`` / ``stable_finish_elems`` — the tiles of the
    lexicographic sorts of 2..8 planes (two: argsort, stable pairs,
    sort_u64, sort_multi, the joins, Table; more: LazyTable's sort and
    the distributed stable sorts), stated at two and three planes and
    halved as the planes grow so the footprint in shared memory stays
    within that of three (``lex_tiles``);
  * ``topk_chunk_elems`` — top_k's per-chunk (key, index) sort;
  * ``compact_elems`` — rows per chunk of the mask compaction, the JAX
    ``compact_chunk_rows`` counterpart; the card's kernel runs its own
    4096-row tiles (``kernels/compact.TILE``), whatever it says;
  * ``scan_elems`` — rows per tile (one block) of the single-pass
    segmented scan.

``TUNING`` holds the tiles measured on each kind of card, keyed by a
prefix of its name; ``tuned()`` is ``SortConfig`` with the row of the card
in use (the counterpart of the JAX per-TPU table, produced by
``radx_tpu_torch/tools/autotune.py``).

``strategy="radix"`` has no tile of its own: its chunk grows from the
mode's chunk tile (kernels/radix_sort.pick_chunk), as the JAX chunk grows
from ``chunk_rows`` and its siblings, and its sorts and merges run on the
mode's tiles (``mode_tiles``).
"""

from __future__ import annotations

import dataclasses
import functools

# One H100 block's dynamic shared memory, in bytes: 2^15 int32 keys of one
# plane (128 KB) fit, 2^16 (256 KB) do not.
MAX_SMEM_BYTES = 227 * 1024

STRATEGIES = ("bitonic", "lax", "radix")


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Configuration of the single-device sort.

    Attributes:
      strategy: ``"bitonic"`` (default) runs the hand-written CUDA bitonic
        network (kernels/bitonic.py); ``"lax"`` maps to ``torch.sort``, the
        counterpart of the JAX package's ``jax.lax.sort`` fallback;
        ``"radix"`` runs the radix distribution sort
        (kernels/radix_sort.py) where its plan applies, falling back to the
        network when a bucket overflows its slots.
      chunk_elems: chunk-sort tile in keys (power of two).
      finish_elems: finish tile in keys (power of two, >= chunk_elems).
      rider_chunk_elems, rider_finish_elems: the same tiles for the
        two-plane (key, rider) sort (powers of two, finish >= chunk).
      stable_chunk_elems, stable_finish_elems: the tiles of 2..8-plane
        lexicographic sorts at two and three planes, halved at 4-6 planes and
        quartered at 7-8 (powers of two, the chunk >= 8, finish >= chunk).
      topk_chunk_elems: rows per chunk of top_k's selection pass (power of
        two >= 2); k <= topk_chunk_elems // 2 takes the selection route.
      compact_elems: rows per chunk of the mask compaction (power of two;
        the card's kernel runs 4096-row tiles whatever it says).
      scan_elems: rows per block of the segmented scan (power of two
        >= 256).
    """

    strategy: str = "bitonic"
    # 2^14 keys (64 KB of shared memory) for both tiles: the fastest pair of
    # a chunk 2^11..2^14 x finish 2^13..2^15 sweep at 2^23 and 2^26 keys on
    # one H100 (PERF.md).  A 2^15 finish tile (128 KB) leaves room for
    # one block per SM and measured 9-16% slower end to end.
    chunk_elems: int = 1 << 14
    finish_elems: int = 1 << 14
    # Two planes of 2^13 keys are 64 KB of shared memory, the footprint of
    # the keys-only 2^14 tile; 2^14 (128 KB) leaves one block per SM.
    rider_chunk_elems: int = 1 << 13
    rider_finish_elems: int = 1 << 13
    # Lexicographic tiles, from a sweep on one H100 (PERF.md): 2^13 rows at
    # two planes (64 KB) and at three (96 KB); from four planes on the tile
    # halves so it stays within 96 KB (2^12 rows at 4-6 planes, 2^11 at
    # 7-8): the four-plane join sort measured 8% slower at 2^13 (128 KB).
    stable_chunk_elems: int = 1 << 13
    stable_finish_elems: int = 1 << 13
    topk_chunk_elems: int = 1 << 13
    # The single-pass kernels' tiles, from a sweep at 2^26 rows on one H100
    # (PERF.md): 2^12 fastest for the scan (2^13 +7%, 2^11 +28%); for the
    # compaction, whose kernel has it built in, within 6% of the fastest
    # on each of its three shapes (2^11 and 2^13 up to 21% and 9% off).
    compact_elems: int = 1 << 12
    scan_elems: int = 1 << 12

    def lex_tiles(self, planes: int) -> tuple[int, int]:
        """(chunk, finish) tiles of a lexicographic sort of ``planes``
        planes."""
        shrink = 1
        while planes > 3 * shrink:
            shrink *= 2
        return (self.stable_chunk_elems // shrink,
                self.stable_finish_elems // shrink)

    def mode_tiles(self, planes: int, num_cmp: int) -> tuple[int, int]:
        """(chunk, finish) tiles of a sort of ``planes`` planes with
        ``num_cmp`` compare planes: keys only, (key, rider) or
        lexicographic."""
        if num_cmp == 2:
            return self.lex_tiles(planes)
        if planes == 2:
            return self.rider_chunk_elems, self.rider_finish_elems
        return self.chunk_elems, self.finish_elems

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown sort strategy {self.strategy!r}")
        if not (_is_pow2(self.chunk_elems) and self.chunk_elems >= 2):
            raise ValueError("chunk_elems must be a power of two >= 2")
        if not _is_pow2(self.finish_elems):
            raise ValueError("finish_elems must be a power of two")
        if self.finish_elems < self.chunk_elems:
            raise ValueError("finish_elems must be >= chunk_elems")
        if not (_is_pow2(self.rider_chunk_elems) and self.rider_chunk_elems >= 2):
            raise ValueError("rider_chunk_elems must be a power of two >= 2")
        if not _is_pow2(self.rider_finish_elems):
            raise ValueError("rider_finish_elems must be a power of two")
        if self.rider_finish_elems < self.rider_chunk_elems:
            raise ValueError("rider_finish_elems must be >= rider_chunk_elems")
        chunk, fin = self.stable_chunk_elems, self.stable_finish_elems
        if not (_is_pow2(chunk) and chunk >= 8 and _is_pow2(fin)):
            raise ValueError("stable_chunk_elems / _finish_elems must be "
                             "powers of two, the chunk >= 8")
        if fin < chunk:
            raise ValueError("stable_finish_elems must be >= "
                             "stable_chunk_elems")
        if not (_is_pow2(self.topk_chunk_elems) and self.topk_chunk_elems >= 2):
            raise ValueError("topk_chunk_elems must be a power of two >= 2")
        if not _is_pow2(self.compact_elems):
            raise ValueError("compact_elems must be a power of two")
        if not (_is_pow2(self.scan_elems) and self.scan_elems >= 256):
            raise ValueError("scan_elems must be a power of two >= 256")


# radx_tpu/kernels/bitonic.py FINISH_WIDTH: chunks fused into one finish pass.
_JAX_FINISH_WIDTH = 16


def _jax_tiles(chunk_rows: int, n_planes: int) -> tuple[int, int]:
    chunk = chunk_rows * 128
    width = min(_JAX_FINISH_WIDTH, max(2, 16384 // (chunk_rows * n_planes)))
    width = 1 << (width.bit_length() - 1)
    return chunk, chunk * width


def config_from_jax(cfg) -> SortConfig:
    """Map a ``radx_tpu.SortConfig`` onto the port's, cutting the network as
    the JAX pipeline cuts it.

    The JAX chunk is ``chunk_rows * 128`` keys.  Its finish pass fuses the
    last log2(W) cross distances of a level into the W-chunk finish (W =
    FINISH_WIDTH, clamped by its VMEM budget to ``16384 // (chunk_rows *
    planes)``), so every distance below ``W * chunk`` runs in the finish:
    that product is the port's finish tile.  The keys-only tiles come from
    ``chunk_rows``, the rider tiles from ``rider_chunk_rows`` (two planes),
    the lexicographic ones from ``stable_chunk_rows`` (cut as at three
    planes; the JAX ``stable2_chunk_rows`` has no counterpart, since the
    port's two-plane sorts take the same tiles),
    top_k's chunk from ``topk_chunk_rows`` and the compaction tile from
    ``compact_chunk_rows``.  The engine holds no weights; data passes
    between the two packages as numpy arrays.
    """
    chunk, finish = _jax_tiles(cfg.chunk_rows, 1)
    r_chunk, r_finish = _jax_tiles(cfg.rider_chunk_rows, 2)
    s_chunk, s_finish = _jax_tiles(cfg.stable_chunk_rows, 3)
    return SortConfig(
        strategy=cfg.strategy, chunk_elems=chunk, finish_elems=finish,
        rider_chunk_elems=r_chunk, rider_finish_elems=r_finish,
        stable_chunk_elems=s_chunk, stable_finish_elems=s_finish,
        topk_chunk_elems=cfg.topk_chunk_rows * 128,
        compact_elems=cfg.compact_chunk_rows * 128,
    )


DEFAULT = SortConfig()

# Tiles by card, keyed by a prefix of the name ``device_kind`` returns (the
# longest matching prefix wins); values override SortConfig fields.  A card
# with no row runs the SortConfig defaults.
TUNING: dict[str, dict] = {
    # radx_tpu_torch/tools/autotune.py at 2^26 keys on one H100 80GB HBM3
    # at 700 W (PERF.md): no tile beat these, the defaults of PR 5's sweep,
    # by more than the spread of the repeats.
    "NVIDIA H100": {"chunk_elems": 1 << 14, "finish_elems": 1 << 14,
                    "rider_chunk_elems": 1 << 13,
                    "rider_finish_elems": 1 << 13,
                    "stable_chunk_elems": 1 << 13,
                    "stable_finish_elems": 1 << 13,
                    "topk_chunk_elems": 1 << 13},
    # CPU runs (the plain PyTorch versions): small tiles make the tests'
    # small inputs run every pass of the pipeline.
    "cpu": {"chunk_elems": 256, "finish_elems": 1024,
            "rider_chunk_elems": 256, "rider_finish_elems": 1024,
            "stable_chunk_elems": 256, "stable_finish_elems": 1024,
            "topk_chunk_elems": 256, "compact_elems": 256,
            "scan_elems": 256},
}


@functools.cache
def device_kind() -> str:
    """The name of the current CUDA card (``torch.cuda.get_device_name``),
    or ``"cpu"`` without CUDA.  Called lazily: importing the package
    touches no CUDA."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name()


def tuned(**overrides) -> SortConfig:
    """SortConfig for the current card: the longest prefix of
    ``device_kind()`` in ``TUNING``, then ``overrides``; a card with no
    row gets the defaults."""
    kind = device_kind()
    params: dict = {}
    for prefix in sorted(TUNING, key=len, reverse=True):
        if kind.startswith(prefix):
            params.update(TUNING[prefix])
            break
    params.update(overrides)
    return SortConfig(**params)
