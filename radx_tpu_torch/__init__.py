"""radx_tpu_torch — the PyTorch / CUDA port of radx_tpu for NVIDIA Hopper.

The JAX package ``radx_tpu`` beside it is the reference.  This package
imports ``torch`` and numpy only, touches no CUDA state when imported, and
builds its CUDA kernels (``csrc/``) with nvcc at their first launch.

  * ``sort`` / ``sort_any`` — single-device sorts of uint32 (and int32 /
    float32) keys on the bitonic network of ``kernels/bitonic.py``;
  * ``filter_columns`` — stable compaction of 32-bit columns by a mask
    (``kernels/compact.py``);
  * ``groupby`` — sort-based sum / count / min / max per key (rider sort,
    ``kernels/segscan.py``, compaction);
  * ``unique`` — sorted distinct keys, with counts on request;
  * ``argsort`` / ``sort_pairs`` / ``sort_pairs_any`` / ``sort_u64`` — the
    stable and lexicographic sorts (the network's lexicographic mode over
    two planes; payloads gathered after it, ``kernels/gather.py``);
  * ``top_k`` — the k largest or smallest keys with their indices;
  * ``groupby_dense`` — GROUP BY over a bounded key space on the dense
    aggregate kernels (``kernels/aggregate.py``);
  * ``Table`` / ``LazyTable`` — the columnar query surface (filter,
    group-by, join, sort, top_k, distinct), eager or with one host sync;
  * ``SortConfig`` — strategy and shared-memory tile sizes; ``DEFAULT``,
    and ``tuned()``, the tiles measured on the card in use.
"""

from radx_tpu_torch.config import DEFAULT, SortConfig, tuned  # noqa: F401
from radx_tpu_torch.ops.distinct import unique  # noqa: F401
from radx_tpu_torch.ops.filter import filter_columns  # noqa: F401
from radx_tpu_torch.ops.groupby import groupby, groupby_dense  # noqa: F401
from radx_tpu_torch.ops.lazy import LazyTable  # noqa: F401
from radx_tpu_torch.ops.sort import (  # noqa: F401
    argsort,
    sort,
    sort_any,
    sort_pairs,
    sort_pairs_any,
    sort_u64,
)
from radx_tpu_torch.ops.table import Table  # noqa: F401
from radx_tpu_torch.ops.topk import top_k  # noqa: F401

__version__ = "0.1.0"
