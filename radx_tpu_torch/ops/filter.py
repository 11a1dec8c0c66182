"""Filter (predicate -> stable compaction) — port of radx_tpu/ops/filter.py,
the first half of the BASELINE's config-3 query.

``filter_columns(mask, cols)`` runs the compaction kernel
(kernels/compact.py) over the columns' 32-bit patterns.  Columns keep their
length: the kept rows come first, in their original order, and ``count`` (a
0-d int32 tensor on the columns' device) says how many; the rows after them
are not part of the result.  Nothing reads ``count`` back to the host, so a
caller chains it on the device or syncs once.
"""

from __future__ import annotations

import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import compact
from radx_tpu_torch.ops.sort import _as_tensor

# The reference caps one call at 2^30 rows (radx_tpu/ops/filter.py:62-63);
# the port keeps the cap so that both raise at the same size (ROADMAP F3).
MAX_ROWS = 1 << 30


def _compact(mask: torch.Tensor, cols, cfg: SortConfig, n_valid=None):
    """Stable compaction of 32-bit columns by a mask (only the rows below
    ``n_valid``, a 0-d int32 device tensor, if given): ([int32 planes],
    count), at most ``compact.MAX_PLANES`` columns per kernel pass.  A
    bool / uint8 / int32 mask goes to the kernel as it is (it tests nonzero
    itself); any other dtype is compared with 0 first."""
    m = (mask.contiguous() if mask.dtype in compact.MASK_BYTES
         else mask.ne(0))
    planes = [c.contiguous().view(torch.int32) for c in cols]
    outs = []
    for i in range(0, len(planes), compact.MAX_PLANES):
        part, count = compact.compact(m, planes[i: i + compact.MAX_PLANES],
                                      cfg.compact_elems, n_valid=n_valid)
        outs += part
    return outs, count


def filter_columns(mask, cols, cfg: SortConfig | None = None, *, device=None):
    """Stable compaction of 32-bit columns by a boolean or 0/1 mask.

    Returns ``(cols_out, count)``: each column reordered so rows where
    ``mask != 0`` occupy the first ``count`` slots in their original order.
    Tensors stay on their device; numpy inputs go to ``device`` (default
    CUDA)."""
    cfg = cfg or DEFAULT
    mask = _as_tensor(mask, device)
    cols = [_as_tensor(c, device if device is not None else mask.device)
            for c in cols]
    if mask.dim() != 1:
        raise ValueError("the mask must be 1-D")
    if not cols:
        raise ValueError("filter_columns needs at least one column")
    n = mask.shape[0]
    for c in cols:
        if c.shape != (n,):
            raise ValueError("all columns must match mask shape")
        if c.element_size() != 4:
            raise TypeError("columns must be 32-bit dtypes")
    if n == 0:
        return cols, torch.zeros((), dtype=torch.int32, device=mask.device)
    if n > MAX_ROWS:
        raise ValueError("filter supports up to 2^30 rows per call")
    outs, count = _compact(mask, cols, cfg)
    return [o.view(c.dtype) for o, c in zip(outs, cols)], count
