"""unique / distinct — port of radx_tpu/ops/distinct.py.

The keys-only sort (ops/sort), one shifted compare for the first row of each
run of equal keys, and the compaction kernel (kernels/compact.py) over the
sorted keys — and over the row index when counts are asked for: the count
of a value is the distance from its first row to the next value's.  Outputs
are padded to ``len(keys)`` rows with ``count`` (a 0-d int32 tensor on the
device) valid ones; nothing is read back to the host.
"""

from __future__ import annotations

import torch

from radx_tpu_torch.config import DEFAULT, SortConfig
from radx_tpu_torch.kernels import compact
from radx_tpu_torch.ops import sort as sort_ops


def unique(keys, return_counts: bool = False, cfg: SortConfig | None = None,
           *, device=None):
    """Sorted distinct values of a uint32 / int32 / float32 tensor.

    Returns ``(values, count)`` — or ``(values, counts, count)`` with
    ``return_counts`` — of which the first ``count`` entries are valid.
    Float semantics follow the engine's total order: -0.0 and +0.0 are
    distinct values and NaNs are deduplicated by bit pattern."""
    cfg = cfg or DEFAULT
    keys = sort_ops._as_tensor(keys, device)
    if keys.dtype not in sort_ops._KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    n = keys.numel()
    if n == 0:
        raise ValueError("unique needs at least one element")
    enc = sort_ops._encode_keys(keys)
    plane = sort_ops._key_plane(enc, sort_ops._pad_len(n))
    if cfg.strategy == "lax":
        plane = torch.sort(plane).values
    else:
        sort_ops._engine([plane], cfg, 1, n)
    s = plane[:n]
    first = torch.ones_like(s)
    first[1:] = (s[1:] != s[:-1]).to(torch.int32)
    cols = [s]
    if return_counts:
        cols.append(torch.arange(n, dtype=torch.int32, device=s.device))
    outs, count = compact.compact(first, cols, cfg.compact_elems)
    vals = sort_ops._decode_keys(sort_ops._unbias(outs[0], n), keys.dtype)
    if not return_counts:
        return vals, count
    # counts[g] = start of group g+1 minus start of group g; the last valid
    # group ends at n.  Entries past `count` are not part of the result.
    starts = outs[1]
    nexts = torch.roll(starts, -1)
    g = torch.arange(n, dtype=torch.int32, device=s.device)
    ends = torch.where(g == count - 1, n, nexts)
    return vals, ends - starts, count
