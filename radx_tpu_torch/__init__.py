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
  * ``SortConfig`` — strategy and shared-memory tile sizes.
"""

from radx_tpu_torch.config import SortConfig  # noqa: F401
from radx_tpu_torch.ops.distinct import unique  # noqa: F401
from radx_tpu_torch.ops.filter import filter_columns  # noqa: F401
from radx_tpu_torch.ops.groupby import groupby  # noqa: F401
from radx_tpu_torch.ops.sort import sort, sort_any  # noqa: F401

__version__ = "0.1.0"
