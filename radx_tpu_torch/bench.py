"""Headline benchmark of the port: uint32 sort throughput on the card.

    python -m radx_tpu_torch.bench            # prints one JSON line

The workload is the JAX package's ``bench.py`` fixture: N = 2^23 shuffled
uint32 keys (a permutation of 0..N-1, numpy seed 0).  What is timed is the
user's entry point, ``radx_tpu_torch.sort`` on a uint32 tensor already on the
card: the sign-bias and pad pass, the bitonic kernels and the unbias pass.
Timing is ``utils.timing.time_cuda`` (CUDA events, warm-up, least of the
repeats, with their spread).  The result is gated on equality with
``torch.sort`` on the card.  With no CUDA device it raises.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from radx_tpu_torch.config import SortConfig
from radx_tpu_torch.ops.sort import sort
from radx_tpu_torch.utils import timing

N = 1 << 23
ITERS, REPEATS = 10, 9  # back-to-back sorts per repeat; least of the repeats
_SIGN = -(1 << 31)


def torch_sort_u32(keys: torch.Tensor) -> torch.Tensor:
    """uint32 sort by ``torch.sort`` on the sign-biased int32 view (PyTorch
    sorts int32 on every device)."""
    biased = keys.view(torch.int32) ^ _SIGN
    return (torch.sort(biased).values ^ _SIGN).view(torch.uint32)


def permutation_keys(n: int) -> np.ndarray:
    return np.random.default_rng(0).permutation(n).astype(np.uint32)


def measure(n: int = N, cfg: SortConfig | None = None) -> dict:
    """Time ``sort`` on n permutation keys on the card; one result row."""
    dev = timing.require_cuda()
    keys = torch.from_numpy(permutation_keys(n)).to(dev)
    got = sort(keys, cfg)
    want = torch_sort_u32(keys)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"sort of {n} keys differs from torch.sort")
    t = timing.time_cuda(lambda: sort(keys, cfg), iters=ITERS, repeats=REPEATS)
    log_n = n.bit_length() - 1
    name = f"n2e{log_n}" if n == 1 << log_n else f"n{n}"
    return {
        "metric": f"sort_u32_keys_per_s_{name}",
        "value": n / t.seconds,
        "unit": "keys/s",
        "ms": t.seconds * 1e3,
        "spread_pct": t.spread_pct,
        "device": timing.device_info(),
    }


def main():
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
