"""Columnar Table — port of radx_tpu/ops/table.py: the query-executor
surface over the sort / filter / group-by / join operators.

A Table is an immutable set of named, equal-length 1-D 32-bit tensors on one
device.  Every operator returns a new Table whose rows are exactly the valid
ones: the eager API reads each operator's row count back to the host
(``int(count)``) to cut its columns.  ``lazy()`` switches to the pipeline
API of ops/lazy.py, which keeps the count on the device until ``collect()``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.ops import filter as filter_ops
from radx_tpu_torch.ops import groupby as groupby_ops
from radx_tpu_torch.ops import join as join_ops
from radx_tpu_torch.ops import sort as sort_ops
from radx_tpu_torch.ops import topk as topk_ops


def take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of a 32-bit column through its int32 view (PyTorch has
    no uint32 indexing on the card)."""
    return col.view(torch.int32)[idx].view(col.dtype)


@dataclasses.dataclass(frozen=True)
class Table:
    columns: Mapping[str, torch.Tensor]

    def __post_init__(self):
        if not self.columns:
            raise ValueError("table needs at least one column")
        if len({c.shape[0] for c in self.columns.values()}) != 1:
            raise ValueError("all columns must have equal length")
        if len({c.device for c in self.columns.values()}) != 1:
            raise ValueError("all columns must lie on one device")
        for name, c in self.columns.items():
            if c.dim() != 1 or c.element_size() != 4:
                raise TypeError(f"column {name!r} must be 1-D 32-bit")

    @classmethod
    def from_arrays(cls, *, device=None, **cols) -> "Table":
        """Columns from tensors, or numpy arrays copied to ``device``."""
        return cls({k: sort_ops._as_tensor(v, device) for k, v in cols.items()})

    @property
    def num_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.columns.items()}

    def lazy(self, cfg: SortConfig | None = None):
        """The pipeline API (ops/lazy.LazyTable): operators thread a row
        count on the device instead of reading it back; ``collect()`` is
        the one host sync."""
        from radx_tpu_torch.ops.lazy import LazyTable

        return LazyTable.from_table(self, cfg)

    def _cut(self, cols, count) -> "Table":
        c = int(count)
        return Table({n: v[:c] for n, v in cols.items()})

    # -- operators ---------------------------------------------------------

    def sort_by(self, key, descending=False,
                cfg: SortConfig | None = None) -> "Table":
        """Stable sort of all columns by one or several uint32 / int32 /
        float32 columns: ``key`` a name or a list (primary first),
        ``descending`` a bool or a per-key list.  Several keys compose as
        stable single-column passes, least significant first (LSD)."""
        keys = [key] if isinstance(key, str) else list(key)
        descs = ([descending] * len(keys) if isinstance(descending, bool)
                 else list(descending))
        if len(descs) != len(keys):
            raise ValueError("descending list must match key list")
        t = self
        for k, d in zip(reversed(keys), reversed(descs)):
            t = t._sort_by_one(k, d, cfg)
        return t

    def _sort_by_one(self, key: str, descending: bool,
                     cfg: SortConfig | None) -> "Table":
        enc = sort_ops._encode_keys(self.columns[key])
        if descending:
            enc = sort_ops._flip(enc)
        names = list(self.columns)
        # one (key, index) sort, the columns gathered by the sorted index
        _, outs = sort_ops.sort_multi(enc, [self.columns[n] for n in names],
                                      cfg or DEFAULT)
        return Table(dict(zip(names, outs)))

    def filter(self, mask, cfg: SortConfig | None = None) -> "Table":
        """Keep the rows where mask != 0 (stable)."""
        names = list(self.columns)
        cols, count = filter_ops.filter_columns(
            sort_ops._as_tensor(mask, self.device),
            [self.columns[n] for n in names], cfg or DEFAULT)
        return self._cut(dict(zip(names, cols)), count)

    def distinct(self, key: str, cfg: SortConfig | None = None) -> "Table":
        """SELECT DISTINCT ON (key): one row per distinct key value, its
        first occurrence in row order, rows ordered by key (the stable
        multi-plane sort, a boundary mask, the compaction)."""
        cfg = cfg or DEFAULT
        names = list(self.columns)
        enc = sort_ops._encode_keys(self.columns[key])
        ks, outs = sort_ops.sort_multi(enc, [self.columns[n] for n in names],
                                       cfg)
        kb = ks.view(torch.int32)
        first = torch.ones_like(kb)
        first[1:] = (kb[1:] != kb[:-1]).to(torch.int32)
        cols, count = filter_ops.filter_columns(first, outs, cfg)
        return self._cut(dict(zip(names, cols)), count)

    def top_k(self, key: str, k: int, largest: bool = True,
              cfg: SortConfig | None = None) -> "Table":
        """ORDER BY key DESC / ASC LIMIT k over all columns (ties keep the
        earliest rows), by the selection operator (ops/topk.py) and one
        gather of the k rows of each column."""
        _, idx = topk_ops.top_k(self.columns[key], k, largest, cfg or DEFAULT)
        return Table({n: take(c, idx) for n, c in self.columns.items()})

    def groupby(self, key: str, value: str, agg: str = "sum",
                bins: int | None = None,
                cfg: SortConfig | None = None) -> "Table":
        """GROUP BY key aggregating value; returns Table(key, agg).  With
        ``bins`` (a power of two bounding the key space: <= 2^16 for sum /
        count, <= 2^13 for min / max) the dense aggregate kernels run
        instead of the sort."""
        cfg = cfg or DEFAULT
        k, v = self.columns[key], self.columns[value]
        if groupby_ops.dense_applies(agg, v.dtype, bins):
            uk, out, ng = groupby_ops.groupby_dense(k, v, agg, bins, cfg)
        else:
            uk, out, ng = groupby_ops.groupby(k, v, agg, cfg)
        return self._cut({key: uk, agg: out}, ng)

    def join(self, other: "Table", on: str, value: str, other_value: str,
             max_matches: int = 1, how: str = "inner", missing=None,
             cfg: SortConfig | None = None) -> "Table":
        """Inner or left join with ``other`` (the build side) on column
        ``on``.  max_matches == 1: the tagged merge join (duplicate build
        keys resolve to the last build row); larger: the bounded multi-match
        join, raising if a build key has more rows.  how="left"
        (max_matches == 1 only) keeps every row of this table, with
        ``missing`` (default 0) as other_value where no key matched."""
        cfg = cfg or DEFAULT
        if how != "inner" and max_matches != 1:
            raise ValueError("how='left' requires max_matches == 1")
        if max_matches == 1:
            k, bv, pv, count = join_ops.join_merge(
                other.columns[on], other.columns[other_value],
                self.columns[on], self.columns[value], cfg=cfg, how=how,
                missing=missing)
            return self._cut({on: k, value: pv, other_value: bv}, count)
        k, bv, pv, valid, truncated = join_ops.join_merge_multi(
            other.columns[on], other.columns[other_value],
            self.columns[on], self.columns[value], max_matches, cfg)
        if bool(truncated):
            raise ValueError(
                "join truncated: a build key exceeded max_matches; re-run "
                f"with max_matches > {max_matches}")
        cols, count = expand_matches(k, pv, bv, valid, cfg)
        return self._cut(dict(zip((on, value, other_value), cols)), count)


def expand_matches(k, pv, bv, valid, cfg: SortConfig):
    """(M, n) match planes -> rows in key order with the M ranks of a probe
    row adjacent, compacted to the valid ones: ([keys, probe values, build
    values], count)."""
    m, n = valid.shape
    cols, count = filter_ops._compact(
        valid.T.reshape(-1),
        [k.view(torch.int32)[:, None].expand(n, m).reshape(-1),
         pv.view(torch.int32)[:, None].expand(n, m).reshape(-1),
         bv.view(torch.int32).T.reshape(-1)], cfg)
    return [c.view(x.dtype) for c, x in zip(cols, (k, pv, bv))], count
