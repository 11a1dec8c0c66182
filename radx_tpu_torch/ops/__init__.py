"""Public operator layer of the port: the sort API (ops/sort.py), filter
(ops/filter.py), group-by (ops/groupby.py), unique (ops/distinct.py), top_k
(ops/topk.py), joins (ops/join.py), Table (ops/table.py) and LazyTable
(ops/lazy.py)."""

from radx_tpu_torch.ops import sort  # noqa: F401  (submodule, not the function)
