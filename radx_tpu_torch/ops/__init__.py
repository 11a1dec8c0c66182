"""Public operator layer of the port: the sort API (ops/sort.py), filter
(ops/filter.py), group-by (ops/groupby.py) and unique (ops/distinct.py)."""

from radx_tpu_torch.ops import sort  # noqa: F401  (submodule, not the function)
