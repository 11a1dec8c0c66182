"""One step of the distributed sort on small shapes — the counterpart of
``__graft_entry__.dryrun_multichip``."""

from __future__ import annotations

import numpy as np
import torch

from radx_tpu_torch.parallel import dist_sort
from radx_tpu_torch.parallel.mesh import Mesh


def dryrun_multichip(n_devices: int, device=None,
                     per_device: int = 1 << 18) -> None:
    """Run the distributed sort on a mesh of ``n_devices`` shards, all on
    ``device`` (default CUDA): keys with the flat exchange, then with the
    hierarchical one (a power of two D >= 4), then stable pairs at
    ``per_device // 16`` keys a shard.  Raises on overflow or on a result
    that differs from numpy."""
    mesh = Mesh([torch.device("cuda" if device is None else device)]
                * n_devices)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, per_device * n_devices, dtype=np.uint32)
    want = np.sort(keys)
    exchanges = ["flat"]
    if dist_sort._hier_factor(n_devices) is not None:
        exchanges.append("hier")
    for exchange in exchanges:
        out, valid, overflow = dist_sort.sort_sharded(keys, mesh,
                                                      exchange=exchange)
        if bool(overflow.any()):
            raise RuntimeError(f"dry run ({exchange}) overflowed its slots")
        if not np.array_equal(dist_sort.collect(out, valid), want):
            raise AssertionError(f"dry run ({exchange}) produced a wrong order")

    n = max(per_device // 16, 1) * n_devices
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    ks, vs, valid, overflow = dist_sort.sort_pairs_sharded(keys, vals, mesh,
                                                           stable=True)
    if bool(overflow.any()):
        raise RuntimeError("dry run (pairs) overflowed its slots")
    order = np.argsort(keys, kind="stable")
    if not (np.array_equal(dist_sort.collect(ks, valid), keys[order])
            and np.array_equal(dist_sort.collect(vs, valid),
                               order.astype(np.uint32))):
        raise AssertionError("dry run (pairs) produced a wrong order")
