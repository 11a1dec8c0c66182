"""Lazy columnar pipelines — port of radx_tpu/ops/lazy.py.

The eager ``Table`` reads every operator's row count back to the host to cut
its columns.  ``LazyTable`` keeps padded columns and the row count as a 0-d
int32 tensor on the device instead:

  invariant: rows [0, count) are the valid rows, in operator order; rows
  past ``count`` are not part of the result.

Every operator threads validity on the device, so nothing waits for the
host between operators, and ``collect()`` is the pipeline's one host sync.
Sorts keep the JAX package's validity contract: valid row i sorts on
(key_i, i), invalid row i on (0x7FFFFFFF, n + i), so invalid rows follow
every valid one and never join a valid run, whatever the keys (a valid key
equal to 0x7FFFFFFF still wins the tie).  The dense group-by passes the
count to the dense aggregate kernels as ``n_valid``.

No operator here reads a device value on the host: no ``int()``, ``.item()``
or boolean-mask indexing (all of which wait for the card); on a CUDA
device a pipeline runs under ``torch.cuda.set_sync_debug_mode("error")``
until ``collect()``.  There is no pytree or jit: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses

import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.ops import join as join_ops
from radx_tpu_torch.ops import sort as sort_ops
from radx_tpu_torch.ops import topk as topk_ops
from radx_tpu_torch.ops.filter import _compact
from radx_tpu_torch.ops.groupby import AGGS, _dense, _groupby, dense_applies
from radx_tpu_torch.ops.table import Table, expand_matches, take

_I32_MAX = 0x7FFFFFFF


def _pos(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _count(value: int, device) -> torch.Tensor:
    """A 0-d int32 count made on the device (no host-to-device copy)."""
    return torch.full((), value, dtype=torch.int32, device=device)


# --- operator cores ----------------------------------------------------------


def filter_lazy(mask, cols, count, cfg: SortConfig):
    """Stable compaction by mask and validity: (int32 planes, new count)."""
    valid = (mask != 0) & (_pos(mask.numel(), mask.device) < count)
    return _compact(valid, cols, cfg)


def groupby_lazy(enc, values, count, agg: str, cfg: SortConfig):
    """Validity-aware sort-based aggregation over encoded uint32 keys
    (ops/groupby._groupby with the rows below ``count`` valid).  Returns
    (uint32 keys, aggregates, num_groups) padded to the input's rows.  The
    rider sort stays on the network under ``"radix"``, whose overflow flag
    is read on the host."""
    n = enc.numel()
    if cfg.strategy == "radix":
        cfg = dataclasses.replace(cfg, strategy="bitonic")
    uk, out, ng = _groupby(enc, values, cfg, agg, _pos(n, enc.device) < count,
                           count)
    return uk[:n], out[:n], ng


def _union_flags(stie, bcount, pcount):
    """(valid build rows, valid probe rows) of a sorted lazy union."""
    is_build = stie < bcount  # bcount <= nb < 2^30: invalid builds excluded
    is_probe = ((stie >= join_ops.PROBE_TIE)
                & (stie - join_ops.PROBE_TIE < pcount))
    return is_build, is_probe


def _sort_lazy(enc, cols, count, cfg: SortConfig, descending: bool):
    """Stable validity-aware sort of the columns by an encoded uint32 key:
    the (key', tie) planes of the validity contract, every column riding."""
    n = enc.numel()
    total = sort_ops._pad_len(n)
    dev = enc.device
    if descending:
        enc = sort_ops._flip(enc)
    pos = _pos(n, dev)
    valid = pos < count
    kb = sort_ops._key_plane(enc, total)
    kb[:n] = torch.where(valid, kb[:n], _I32_MAX)
    tie = torch.full((total,), _I32_MAX, dtype=torch.int32, device=dev)
    tie[:n] = torch.where(valid, pos, pos + n)
    planes = [kb, tie, *(sort_ops._payload_plane(c, total) for c in cols)]
    sort_ops._lex_sort(planes, cfg)
    return [p[:n].view(c.dtype) for p, c in zip(planes[2:], cols)]


# --- the LazyTable -------------------------------------------------------------


class LazyTable:
    """Padded columns and a device row count; see the module docstring."""

    def __init__(self, columns, count, cfg: SortConfig | None = None):
        self.columns = dict(columns)
        if len({c.shape[0] for c in self.columns.values()}) != 1:
            raise ValueError("all columns must have equal padded length")
        if not isinstance(count, torch.Tensor):
            count = _count(count, self.device)
        self.count = count
        self.cfg = cfg or DEFAULT

    @classmethod
    def from_table(cls, table: Table, cfg: SortConfig | None = None):
        return cls(table.columns, _count(table.num_rows, table.device), cfg)

    @property
    def padded_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    # -- operators (no host syncs anywhere below) ---------------------------

    def filter(self, mask) -> "LazyTable":
        names = list(self.columns)
        cols, count = filter_lazy(
            sort_ops._as_tensor(mask, self.device),
            [self.columns[m] for m in names], self.count, self.cfg)
        return LazyTable({m: c.view(self.columns[m].dtype)
                          for m, c in zip(names, cols)}, count, self.cfg)

    def groupby(self, key: str, value: str, agg: str = "sum",
                bins: int | None = None) -> "LazyTable":
        """GROUP BY key aggregating value (the surface of Table.groupby).
        With ``bins`` the dense aggregate kernels run with the count as
        their ``n_valid``: no sort, no sync.  Keys past the bound among the
        valid rows are the caller's contract (the eager API checks them)."""
        if agg not in AGGS:
            raise ValueError(f"unknown agg {agg!r}")
        key_col, vals = self.columns[key], self.columns[value]
        if dense_applies(agg, vals.dtype, bins):
            if key_col.dtype == torch.float32:
                raise TypeError("dense groupby keys must be uint32/int32")
            uk, out, ng = _dense(key_col.view(torch.uint32), vals, agg, bins,
                                 self.cfg, n_valid=self.count)
            uk = uk.view(key_col.dtype)
        else:
            uk, out, ng = groupby_lazy(sort_ops._encode_keys(key_col), vals,
                                       self.count, agg, self.cfg)
            uk = sort_ops._decode_keys(uk, key_col.dtype)
        return LazyTable({key: uk, agg: out}, ng, self.cfg)

    def _union(self, other: "LazyTable", on: str, value: str,
               other_value: str):
        key_dtype = self.columns[on].dtype
        if other.columns[on].dtype != key_dtype:
            raise TypeError("join key dtypes must match on both sides")
        skey, stie, sbval, spval = join_ops.tagged_union(
            sort_ops._encode_keys(other.columns[on]),
            other.columns[other_value],
            sort_ops._encode_keys(self.columns[on]), self.columns[value],
            self.cfg)
        return (skey, sbval, spval,
                *_union_flags(stie, other.count, self.count))

    def join(self, other: "LazyTable", on: str, value: str,
             other_value: str) -> "LazyTable":
        """Single-match inner join with ``other`` (the build side); duplicate
        build keys resolve to the last valid build row."""
        skey, sbval, spval, is_build, is_probe = self._union(
            other, on, value, other_value)
        (k, b, p), count = join_ops.merge_core(skey, sbval, spval, is_build,
                                               is_probe, self.cfg)
        return LazyTable(
            {on: sort_ops._decode_keys(k.view(torch.uint32),
                                       self.columns[on].dtype),
             value: p.view(self.columns[value].dtype),
             other_value: b.view(other.columns[other_value].dtype)},
            count, self.cfg)

    def join_multi(self, other: "LazyTable", on: str, value: str,
                   other_value: str, max_matches: int = 4):
        """Inner join keeping up to max_matches build rows per key.  Returns
        (LazyTable, truncated): ``truncated`` is a 0-d bool tensor on the
        device, True when a valid build key had more than max_matches valid
        rows (the extra matches are dropped); check it after collecting."""
        if max_matches < 1:
            raise ValueError("max_matches must be >= 1")
        skey, sbval, spval, is_build, is_probe = self._union(
            other, on, value, other_value)
        fills, valid, truncated = join_ops.multi_core(
            skey, sbval, is_build, is_probe, self.cfg, max_matches)
        k = sort_ops._decode_keys((skey ^ sort_ops._SIGN).view(torch.uint32),
                                  self.columns[on].dtype)
        (k, p, b), count = expand_matches(
            k, spval.view(self.columns[value].dtype),
            torch.stack(fills).view(other.columns[other_value].dtype),
            torch.stack(valid), self.cfg)
        return LazyTable({on: k, value: p, other_value: b}, count,
                         self.cfg), truncated

    def distinct(self, key: str) -> "LazyTable":
        """SELECT DISTINCT ON (key): one row per distinct valid key, its
        first occurrence in row order, rows ordered by key — sort_by, a
        boundary mask, and the validity-aware filter."""
        t = self.sort_by(key)
        sk = sort_ops._encode_keys(t.columns[key]).view(torch.int32)
        is_first = torch.ones_like(sk)
        is_first[1:] = (sk[1:] != sk[:-1]).to(torch.int32)
        return t.filter(is_first)

    def top_k(self, key: str, k: int, largest: bool = True) -> "LazyTable":
        """ORDER BY key DESC / ASC LIMIT k: the selection operator over the
        rows with invalid ones given the worst key (and, by their index, the
        losing tie), then a gather of the k winning rows of each column; the
        count becomes min(count, k)."""
        n = self.padded_rows
        if not 1 <= k <= n:
            raise ValueError(f"need 1 <= k <= {n}, got k={k}")
        enc = sort_ops._encode_keys(self.columns[key])
        work = sort_ops._flip(enc) if largest else enc
        valid = _pos(n, self.device) < self.count
        work = torch.where(valid, work.view(torch.int32), -1).view(torch.uint32)
        _, idx = topk_ops._top_k(work, self.cfg, n, k,
                                 topk_ops.select_applies(k, self.cfg))
        return LazyTable({m: take(c, idx) for m, c in self.columns.items()},
                         torch.clamp(self.count, max=k), self.cfg)

    def sort_by(self, key: str, descending: bool = False) -> "LazyTable":
        names = list(self.columns)
        outs = _sort_lazy(sort_ops._encode_keys(self.columns[key]),
                          [self.columns[m] for m in names], self.count,
                          self.cfg, descending)
        return LazyTable(dict(zip(names, outs)), self.count, self.cfg)

    # -- the single sync -------------------------------------------------------

    def collect(self) -> Table:
        """The eager Table of the valid rows: the pipeline's one host sync."""
        c = int(self.count)
        return Table({m: v[:c] for m, v in self.columns.items()})
