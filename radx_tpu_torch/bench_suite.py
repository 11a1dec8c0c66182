"""Benchmark suite of the port on the card — the counterpart of
radx_tpu/bench_suite.py, with the rows the JAX package measures outside
its suite added (NOTES.md, tools/validate_scale.py).

    python -m radx_tpu_torch.bench_suite --configs sort_8m,groupby_64m
    python -m radx_tpu_torch.bench_suite --configs all   # DEFAULT_SET

Prints one ``Metrics.row()`` per config, the card's name and power limit
(nvidia-smi), and as the last line ``{"suite": [...]}``: per config its
seconds per call, items/s, the spread of the repeats and the peak device
memory of the timed calls (the config's data included).

Each config is a ``Config`` record: ``make(n, device, gen)`` builds its
data on ``device`` from a seeded ``torch.Generator``, ``op(data)`` is the
timed call and ``check(data, out)`` its gate, which raises
``AssertionError`` on any difference from a plain PyTorch (or numpy)
reference.  ``run`` makes the data, gates one output of the op and only
then times it (``utils.timing.time_op``: CUDA events around back-to-back
calls); the CPU tests run make -> op -> check on ``device="cpu"``, where
every kernel wrapper runs its plain version.

The JAX suite draws its data from ``runtime.gen_*`` (the C++ generators
the port does not carry); the port draws the same distributions on the
card with the same seeds, so the bits differ but every config keeps its
n, key distribution, bins, k and op.  The JAX suite's chaining tricks are
not ported: its ``time_op`` chains applications inside one ``jit`` and
folds each result back into the next input (``v ^ tile(sums)`` in the
dense configs, the ``~_encode_keys`` XOR in ``topk_64m``) so that XLA
keeps every application.  PyTorch runs each call as issued, so the timed
op is the call itself, as in ``radx_tpu_torch/bench.py``.  Two configs
time a kernel rather than an entry point, as in JAX: ``groupby_dense_16m``
(``dense_sums``) and ``groupby_minmax_16m`` (``dense_extrema``); their
gates also run the entry point, ``groupby_dense``.  Ops that sort in place
(``pairs_*``: ``sort_planes`` on three planes) sort copies, so every call
sorts the original data.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable

import numpy as np
import torch

from radx_tpu_torch import bench
from radx_tpu_torch.config import SortConfig, tuned
from radx_tpu_torch.kernels import aggregate, bitonic, msd, radix_sort
from radx_tpu_torch.ops import chunked
from radx_tpu_torch.ops import sort as sort_ops
from radx_tpu_torch.ops.filter import filter_columns
from radx_tpu_torch.ops.groupby import _order_i32, groupby, groupby_dense
from radx_tpu_torch.ops.topk import top_k
from radx_tpu_torch.utils import timing

_SIGN = -(1 << 31)
_I32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Config:
    """One benchmark config.  ``what`` names the row (``{n}`` is the size);
    ``item_bytes``: bytes one item moves (``bytes_moved = item_bytes *
    n``, the JAX figures); ``kernels``: the launch names the op (and its
    gate) must make on the card; ``extra(data, metrics, iters, repeats)``
    adds fields to the suite row after the timing."""

    what: str
    n: int
    seed: int
    make: Callable
    op: Callable
    check: Callable
    item_bytes: int
    kernels: tuple[str, ...]
    iters: int = 5
    repeats: int = 5
    extra: Callable | None = None

    def label(self, n: int) -> str:
        log_n = n.bit_length() - 1
        return self.what.format(n=f"2^{log_n}" if n == 1 << log_n else n)


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.element_size() == 4 else t


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _uniform(n: int, gen) -> torch.Tensor:
    """n uniform uint32 keys."""
    return bench._randint(-(2**31), 2**31, n, gen).view(torch.uint32)


def _below(n: int, m: int, gen) -> torch.Tensor:
    """n uniform uint32 keys reduced mod m (the JAX ``gen_uniform % m``)."""
    u = bench._randint(-(2**31), 2**31, n, gen).long() & 0xFFFFFFFF
    return (u % m).to(torch.int32).view(torch.uint32)


def _permutation(n: int, gen) -> torch.Tensor:
    """A shuffled permutation of 0 .. n-1 as uint32 keys."""
    return torch.randperm(n, generator=gen, device=gen.device).to(
        torch.int32).view(torch.uint32)


def _biased(keys: torch.Tensor) -> torch.Tensor:
    return keys.view(torch.int32) ^ _SIGN


# --- keys-only sorts --------------------------------------------------------


def _make_sort(n, device, gen):
    return {"keys": _permutation(n, gen), "cfg": tuned()}


def _make_uniform_sort(n, device, gen):
    return {"keys": _uniform(n, gen), "cfg": tuned()}


def _sort(d):
    return sort_ops.sort(d["keys"], d["cfg"])


def _check_sort(d, out):
    _require(_same(out, bench.torch_sort_u32(d["keys"])),
             "sort differs from torch.sort")


def _radix_geometry(n, cfg):
    """(padded length, radix chunk) of a keys-only sort of n keys, as
    ``ops/sort._engine`` picks them."""
    total = sort_ops._pad_len(n)
    return total, radix_sort.pick_chunk(total, cfg.chunk_elems)


def _make_radix(n, device, gen):
    cfg = tuned(strategy="radix")
    if radix_sort.plan(*_radix_geometry(n, cfg)) is None:
        raise ValueError(f"no radix plan for n={n}")
    return {"keys": _permutation(n, gen), "cfg": cfg}


def _check_radix(d, out):
    """Equal to torch.sort, and the radix stage did not overflow (then
    ``sort`` would have run the network): the flag of the same stage
    replayed on the same keys."""
    _check_sort(d, out)
    keys, cfg = d["keys"], d["cfg"]
    n = keys.numel()
    total, chunk = _radix_geometry(n, cfg)
    _, overflow = radix_sort.sort_radix([sort_ops._key_plane(keys, total)],
                                        chunk, 1, cfg, n)
    _require(not overflow, "the radix sort overflowed its slots")


def _arbn_extra(d, m, iters, repeats):
    """The rate of ``sort`` at the largest power of two below n, on the
    first keys of the same data (gated too), and the overhead of the
    arbitrary-N path: rate(pow2) / rate(n) - 1."""
    keys, cfg = d["keys"], d["cfg"]
    n = keys.numel()
    p = 1 << (n.bit_length() - 1)
    sub = {"keys": keys[:p], "cfg": cfg}
    _check_sort(sub, _sort(sub))
    mp = timing.time_op(_sort, sub, items=p, iters=iters, repeats=repeats)
    return {"decomposition": sort_ops._use_decomposition(n, cfg),
            "pow2_n": p, "pow2_items_per_s": mp.items_per_s,
            "pow2_spread_pct": mp.spread_pct,
            "overhead_pct": 100.0 * (mp.items_per_s / m.items_per_s - 1)}


# --- stable pairs -----------------------------------------------------------


def _make_pairs(n, device, gen):
    keys = _uniform(n, gen)
    idx = torch.arange(n, dtype=torch.int32, device=device)
    return {"keys": keys, "planes": (_biased(keys), idx, idx.clone()),
            "cfg": tuned()}


def _pairs(d):
    """(key, index, value) planes sorted lexicographically by (key, index)
    on the network's two-compare mode at ``lex_tiles(3)``, on copies."""
    k, i, v = (p.clone() for p in d["planes"])
    bitonic.sort_planes(k, *d["cfg"].lex_tiles(3), lex=[i, v])
    return k, i, v


def _check_pairs(d, out):
    k, i, v = out
    keys = d["keys"]
    _require(_same((k ^ _SIGN).view(torch.uint32), bench.torch_sort_u32(keys)),
             "pairs keys not sorted")
    _require(_same(_biased(keys)[i.long()], k),
             "pairs index is not a permutation that carries the keys")
    _require(torch.equal(v, i), "pairs values did not ride with their index")
    _require(bool(((k[:-1] < k[1:]) | (i[:-1] < i[1:])).all()),
             "pairs sort not stable")


def _make_pairs_unique(n, device, gen):
    return {"keys": _permutation(n, gen),
            "vals": torch.arange(n, dtype=torch.int32, device=device),
            "cfg": tuned()}


def _pairs_unique(d):
    return sort_ops.sort_pairs(d["keys"], d["vals"], d["cfg"],
                               assume_unique=True)


def _check_pairs_unique(d, out):
    k, v = out
    keys = d["keys"]
    n = keys.numel()
    iota = torch.arange(n, dtype=torch.int32, device=keys.device)
    _require(_same(k, iota), "unique-pairs keys not sorted")
    want = torch.empty_like(iota)
    want[keys.view(torch.int32).long()] = iota  # argsort of a permutation
    _require(_same(v, want), "unique-pairs payload wrong")


# --- group-by, dense aggregates, filter -------------------------------------


def _make_groupby(n, device, gen):
    return {"keys": _below(n, 10007, gen), "vals": _uniform(n, gen),
            "cfg": tuned()}


def _groupby(d):
    return groupby(d["keys"], d["vals"], "sum", d["cfg"])


def _check_groupby(d, out):
    bench._check_groups(*out, d["keys"], d["vals"])


DENSE_BINS = 1024


def _make_dense(n, device, gen):
    vals = _uniform(n, gen)
    return {"keys": _below(n, DENSE_BINS - 7, gen), "vals": vals,
            "v32": vals.view(torch.int32), "cfg": tuned()}


def _dense_sums(d):
    return aggregate.dense_sums(d["keys"], d["v32"], DENSE_BINS)


def _present(counts):
    return (counts > 0).nonzero().flatten()


def _check_dense_sums(d, out):
    """The kernel's sums and counts against int64 index_add_ sums mod 2^32
    and a bincount, then ``groupby_dense`` (the entry point) against the
    same."""
    sums, counts = out
    keys, vals = d["keys"].view(torch.int32).long(), d["vals"]
    want = torch.zeros(DENSE_BINS, dtype=torch.int64, device=keys.device)
    want.index_add_(0, keys, vals.view(torch.int32).long() & 0xFFFFFFFF)
    want &= 0xFFFFFFFF
    wcount = torch.bincount(keys, minlength=DENSE_BINS)
    _require(sums.shape == (DENSE_BINS,) and counts.shape == (DENSE_BINS,),
             "dense sums: wrong number of bins")
    _require(torch.equal(sums.view(torch.int32).long() & 0xFFFFFFFF, want)
             and torch.equal(counts.long(), wcount), "dense sums wrong")
    uk, got, ng = groupby_dense(d["keys"], vals, "sum", DENSE_BINS, d["cfg"])
    present = _present(wcount)
    g = present.numel()
    _require(int(ng) == g and torch.equal(uk[:g].view(torch.int32).long(),
                                          present),
             "dense groupby keys wrong")
    _require(torch.equal(got[:g].view(torch.int32).long() & 0xFFFFFFFF,
                         want[present]), "dense groupby sums wrong")


def _make_minmax(n, device, gen):
    vals = _uniform(n, gen)
    return {"keys": _below(n, DENSE_BINS - 3, gen), "vals": vals,
            "ovals": _order_i32(vals), "cfg": tuned()}


def _dense_min(d):
    return aggregate.dense_extrema(d["keys"], d["ovals"], DENSE_BINS, True)


def _check_dense_min(d, out):
    """The kernel's minima (order-isomorphic int32; an empty bin holds
    0x7FFFFFFF, 0xFFFFFFFF biased) against ``scatter_reduce`` amin, then
    ``groupby_dense(..., "min")`` against the same."""
    ext, counts = out
    keys = d["keys"].view(torch.int32).long()
    want = torch.full((DENSE_BINS,), _I32_MAX, dtype=torch.int32,
                      device=keys.device)
    want.scatter_reduce_(0, keys, d["ovals"], "amin")
    wcount = torch.bincount(keys, minlength=DENSE_BINS)
    _require(ext.shape == (DENSE_BINS,) and counts.shape == (DENSE_BINS,),
             "dense min: wrong number of bins")
    _require(torch.equal(ext, want) and torch.equal(counts.long(), wcount),
             "dense min values wrong")
    _require(bool((ext[wcount == 0] == _I32_MAX).all()),
             "dense min: an empty bin lost its identity")
    uk, got, ng = groupby_dense(d["keys"], d["vals"], "min", DENSE_BINS,
                                d["cfg"])
    present = _present(wcount)
    g = present.numel()
    _require(int(ng) == g and torch.equal(uk[:g].view(torch.int32).long(),
                                          present),
             "dense min keys wrong")
    _require(torch.equal(got[:g].view(torch.int32), want[present] ^ _SIGN),
             "dense groupby min wrong")


def _make_filter(n, device, gen):
    vals = _uniform(n, gen)
    return {"vals": vals, "mask": vals.view(torch.int32) & 1, "cfg": tuned()}


def _filter(d):
    return filter_columns(d["mask"], [d["vals"]], d["cfg"])


def _check_filter(d, out):
    (got,), count = out
    want = d["vals"].view(torch.int32)[d["mask"] != 0]
    c = want.numel()
    _require(int(count) == c and torch.equal(got[:c].view(torch.int32), want),
             "filter output wrong")


# --- top_k and argsort ------------------------------------------------------


TOPK_K = 1024


def _top_k(d):
    return top_k(d["keys"], TOPK_K, True, d["cfg"])


def _check_top_k(d, out):
    """(value, index) against a stable descending torch.sort: ties by the
    smaller index."""
    vals, idx = out
    keys = d["keys"]
    order = torch.sort(_biased(keys), descending=True,
                       stable=True).indices[:TOPK_K]
    _require(idx.shape == (TOPK_K,) and torch.equal(idx.long(), order),
             "top_k indices wrong")
    _require(_same(vals, keys.view(torch.int32)[order]), "top_k values wrong")


def _argsort(d):
    return sort_ops.argsort(d["keys"], d["cfg"])


def _check_argsort(d, out):
    want = torch.sort(_biased(d["keys"]), stable=True).indices
    _require(out.shape == want.shape and torch.equal(out.long(), want),
             "argsort differs from a stable torch.sort")


# --- the out-of-core sort -----------------------------------------------------


CHUNKED_SLAB = 1 << 28


def _make_chunked(n, device, gen):
    return {"keys": _permutation(n, gen).cpu().numpy(), "cfg": tuned(),
            "slab": min(CHUNKED_SLAB, max(n // 4, 1)), "device": device}


def _sort_chunked(d):
    return chunked.sort_chunked(d["keys"], d["cfg"], d["slab"],
                                device=d["device"])


def _check_sort_chunked(d, out):
    out = torch.from_numpy(np.ascontiguousarray(out))
    _require(_same(out, torch.from_numpy(np.sort(d["keys"]))),
             "sort_chunked differs from np.sort")


# --- the table ----------------------------------------------------------------


def _lex(planes, distances=None):
    return bitonic.mode_kernels(2, planes, distances)


def _log2(x):
    return x.bit_length() - 1


# a radix sort runs the levels above the tile inside its chunks of at most
# radix_sort.MAX_CHUNK rows; its first launch (K4) reads the caller's keys
# and its last (K13) writes them back unbiased
_RADIX = (*bitonic.mode_kernels(
    1, 1, _log2(radix_sort.MAX_CHUNK) - _log2(SortConfig().finish_elems)),
          bitonic.radix_source_kernel(1, 1), bitonic.radix_kernels(1, 1)[1],
          msd.mode_kernels(1, 1)[0], msd.unbias_kernel(1, 1), "radix_hist",
          "radix_rank")
_GROUPBY = (*bitonic.sort_kernels(1, 2), "segscan", "compact")


def _sort_config(n, seed=1, **kw):
    kw.setdefault("iters", 5 if n <= 1 << 26 else 2)
    kw.setdefault("repeats", 5 if n <= 1 << 26 else 3)
    return Config("sort_u32 {n}", n, seed, _make_sort, _sort, _check_sort, 8,
                  bitonic.sort_kernels(
                      1, 1, _log2(n) - _log2(SortConfig().finish_elems)),
                  **kw)


def _radix_config(n):
    return Config("sort_radix {n}", n, 1, _make_radix, _sort, _check_radix, 8,
                  _RADIX, iters=5 if n <= 1 << 26 else 2, repeats=5)


def _pairs_config(n):
    return Config("sort_pairs {n}", n, 2, _make_pairs, _pairs, _check_pairs,
                  24, _lex(3), iters=5 if n <= 1 << 22 else 2, repeats=5)


def _pairs_unique_config(n):
    return Config("sort_pairs_unique {n}", n, 12, _make_pairs_unique,
                  _pairs_unique, _check_pairs_unique, 16,
                  bitonic.sort_kernels(1, 2), iters=5 if n <= 1 << 22 else 2,
                  repeats=5)


def _groupby_config(n):
    return Config("groupby_sum {n}", n, 3, _make_groupby, _groupby,
                  _check_groupby, 16, _GROUPBY, iters=4)


def _topk_config(n):
    # the lex2 sort of the candidates: TOPK_K rows of every chunk
    cfg = SortConfig()
    rows = n // cfg.topk_chunk_elems * TOPK_K
    return Config("top_k {n} k=1024", n, 11, _make_uniform_sort, _top_k,
                  _check_top_k, 8,
                  _lex(2, _log2(rows) - _log2(cfg.lex_tiles(2)[1])))


def _argsort_config(n):
    return Config("argsort {n}", n, 13, _make_uniform_sort, _argsort,
                  _check_argsort, 8, bitonic.sort_kernels(2, 2, unbias=False))


CONFIGS: dict[str, Config] = {
    # the JAX suite (radx_tpu/bench_suite.py CONFIGS), names kept
    "sort_8m": _sort_config(1 << 23),
    "sort_64m": _sort_config(1 << 26),
    "sort_268m": _sort_config(1 << 28),
    "sort_radix_64m": _radix_config(1 << 26),
    "sort_radix_268m": _radix_config(1 << 28),
    "pairs_4m": _pairs_config(1 << 22),
    "pairs_256m": _pairs_config(1 << 28),
    "pairs_unique_4m": _pairs_unique_config(1 << 22),
    "pairs_unique_256m": _pairs_unique_config(1 << 28),
    "groupby_4m": _groupby_config(1 << 22),
    "groupby_64m": _groupby_config(1 << 26),
    "groupby_dense_16m": Config(
        "groupby_dense {n} bins=1024", 1 << 24, 6, _make_dense, _dense_sums,
        _check_dense_sums, 8, ("dense_sums", "compact"), iters=10),
    "groupby_minmax_16m": Config(
        "groupby_dense_min {n} bins=1024", 1 << 24, 8, _make_minmax,
        _dense_min, _check_dense_min, 8, ("dense_extrema", "compact"),
        iters=10),
    "filter_64m": Config("filter {n}", 1 << 26, 5, _make_filter, _filter,
                         _check_filter, 12, ("compact",), iters=10),
    "topk_64m": _topk_config(1 << 26),
    # the rows the JAX package measures outside its suite
    "sort_536m": _sort_config(1 << 29),
    "sort_1g": _sort_config(1 << 30),
    "argsort_4m": _argsort_config(1 << 22),
    "argsort_64m": _argsort_config(1 << 26),
    "topk_4m": _topk_config(1 << 22),
    "topk_16m": _topk_config(1 << 24),
    "arbn_600m": Config("sort_u32 {n}", 600_000_000, 3, _make_uniform_sort,
                        _sort, _check_sort, 8, bitonic.sort_kernels(1, 1),
                        iters=2, repeats=3, extra=_arbn_extra),
    "sort_chunked_1g": Config("sort_chunked {n}", 1 << 30, 9, _make_chunked,
                              _sort_chunked, _check_sort_chunked, 8,
                              bitonic.KEY_KERNELS, iters=1, repeats=2),
}

# ``--configs all``: every config but the host-bound out-of-core sort
DEFAULT_SET = tuple(c for c in CONFIGS if c != "sort_chunked_1g")


def make_and_gate(name: str, n: int | None = None, device="cuda"):
    """Make config ``name``'s data on ``device`` and gate one output of its
    op; returns the data.  Raises AssertionError on a wrong output."""
    c = CONFIGS[name]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(c.seed)
    data = c.make(c.n if n is None else n, device, gen)
    c.check(data, c.op(data))
    return data


def run(name: str, n: int | None = None, *, iters: int | None = None,
        repeats: int | None = None) -> tuple[timing.Metrics, dict]:
    """Gate config ``name`` at n rows (default: its own) on the card, then
    time its op (the config's iters and repeats unless given); returns
    (Metrics, the suite row)."""
    timing.require_cuda()
    c = CONFIGS[name]
    n = c.n if n is None else n
    iters = c.iters if iters is None else iters
    repeats = c.repeats if repeats is None else repeats
    data = make_and_gate(name, n)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = timing.time_op(c.op, data, name=c.label(n), items=n,
                       bytes_moved=c.item_bytes * n, iters=iters,
                       repeats=repeats, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    row = {"config": name, "n": n, "seconds": m.seconds,
           "items_per_s": m.items_per_s, "spread_pct": m.spread_pct,
           "peak_mem_gb": peak}
    if c.extra is not None:
        row.update(c.extra(data, m, iters, repeats))
    del data
    torch.cuda.empty_cache()
    return m, row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="sort_8m",
                    help="comma-separated names, or 'all' (every config "
                         "but sort_chunked_1g)")
    args = ap.parse_args(argv)
    names = (DEFAULT_SET if args.configs == "all" else
             [s.strip() for s in args.configs.split(",")])
    unknown = [s for s in names if s not in CONFIGS]
    if unknown:
        print(f"unknown configs {unknown}; have {sorted(CONFIGS)}")
        return 2
    rows = []
    for name in names:
        m, row = run(name)
        print(m.row(), flush=True)
        rows.append(row)
    print(timing.nvidia_smi())
    print(json.dumps({"suite": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
