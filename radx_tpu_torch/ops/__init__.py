"""Public operator layer of the port: the sort API (ops/sort.py)."""

from radx_tpu_torch.ops import sort  # noqa: F401  (submodule, not the function)
