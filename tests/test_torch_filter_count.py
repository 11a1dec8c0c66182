"""The count-only filter (``COUNT(*) ... WHERE``): ``filter_columns(mask, [])``
and ``filter_chunked(mask, [])`` of the port (radx_tpu_torch/ops/filter.py,
ops/chunked.py) against the JAX package's (radx_tpu/ops/filter.py,
ops/chunked.py; Pallas in interpret mode): both return ``([], count)``, and
the counts are equal (tolerance 0: integers).  The compaction's CPU model
(``compact.compact_lookback``) with no planes gives the one-plane count.

Masks are bool or 0/1 int32 (ROADMAP F5: the reference counts other
integers as repeats), made from a numpy seed; one JAX result per case.
"""

import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import chunked as j_chunked
from radx_tpu.ops.filter import filter_columns as j_filter
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import compact as tc
from radx_tpu_torch.ops import chunked as t_chunked
from radx_tpu_torch.ops.filter import filter_columns

JCFG = JaxSortConfig(chunk_rows=8, compact_chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SLAB = 16
# the mask of ROADMAP Queue 3 P1: 20 of 40 rows kept
P1_MASK = np.tile(np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int32), 5)


def _mask(pattern, dtype):
    n = 0 if pattern == "empty" else 77
    if pattern == "mixed":
        m = np.random.default_rng(11).random(n) < 0.4
    else:
        m = np.full(n, pattern == "all_one")
    return m.astype(dtype)


def test_p1_mask_counts_twenty():
    """The fault's own input: the reference's ``([], 20)`` from both."""
    outs, count = filter_columns(P1_MASK, [], CFG, device="cpu")
    j_outs, j_count = j_filter(P1_MASK, [], JCFG)
    assert outs == [] and list(j_outs) == []
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(j_count) == 20
    outs, total = t_chunked.filter_chunked(P1_MASK, [], CFG, slab=SLAB,
                                           device="cpu")
    j_outs, j_total = j_chunked.filter_chunked(P1_MASK, [], JCFG, slab=SLAB)
    assert outs == [] and list(j_outs) == []
    assert isinstance(total, int) and total == j_total == 20


@pytest.mark.parametrize("dtype", [np.bool_, np.int32], ids=["bool", "int32"])
@pytest.mark.parametrize("pattern", ["mixed", "all_zero", "all_one", "empty"])
def test_filter_columns_count_only_matches_jax(pattern, dtype):
    mask = _mask(pattern, dtype)
    outs, count = filter_columns(mask, [], CFG, device="cpu")
    j_outs, j_count = j_filter(mask, [], JCFG)
    assert outs == [] and list(j_outs) == []
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(j_count) == int(np.count_nonzero(mask))


@pytest.mark.parametrize("dtype", [np.bool_, np.int32], ids=["bool", "int32"])
@pytest.mark.parametrize("pattern", ["mixed", "all_zero", "all_one", "empty"])
def test_filter_chunked_count_only_matches_jax(pattern, dtype):
    """Five slabs of 16 rows (the last one ragged) at n = 77."""
    mask = _mask(pattern, dtype)
    outs, total = t_chunked.filter_chunked(mask, [], CFG, slab=SLAB,
                                           device="cpu")
    j_outs, j_total = j_chunked.filter_chunked(mask, [], JCFG, slab=SLAB)
    assert outs == [] and list(j_outs) == []
    assert total == j_total == int(np.count_nonzero(mask))


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_model_zero_planes_counts_like_one_plane(density, mask_dtype):
    """The kernel's pass modelled on the CPU with no planes (the count
    only), 3 tiles of 256 and a ragged one, against the one-plane call."""
    rng = np.random.default_rng(int(density * 10) + 3)
    n = 3 * 256 + 41
    mask = torch.from_numpy(rng.random(n) < density).to(mask_dtype)
    plane = torch.from_numpy(rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                             .astype(np.int32))
    gen = torch.Generator().manual_seed(5)
    none, count0 = tc.compact_lookback(mask, [], 256, gen)
    _, count1 = tc.compact_lookback(mask, [plane], 256, gen)
    ref_none, ref_count = tc.compact_ref(mask, [])
    assert none == [] and ref_none == []
    assert count0.dtype == count1.dtype == ref_count.dtype == torch.int32
    assert int(count0) == int(count1) == int(ref_count) == int(mask.sum())
    # the wrapper on the CPU takes no planes too
    outs, count = tc.compact(mask, [], 256)
    assert outs == [] and int(count) == int(mask.sum())
