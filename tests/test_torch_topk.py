"""The port's ``top_k`` (radx_tpu_torch/ops/topk.py) against the JAX
package's (radx_tpu/ops/topk.py, Pallas in interpret mode), bit for bit:
values and indices (ties keep the smallest index, so the answer is unique).
Both routes run: the selection route (per-chunk sort, candidate truncation,
final sort) and the full-sort route.  On the CPU the port's wrappers run
their plain PyTorch versions."""

import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops.topk import top_k as j_top_k
from radx_tpu_torch import SortConfig, top_k
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.ops import topk as tt

JCFG = JaxSortConfig(chunk_rows=8, topk_chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SMALL = SortConfig(topk_chunk_elems=64, stable_chunk_elems=16,
                   stable_finish_elems=64)
N = 4096  # > 2 chunks of 1024: k <= 512 takes the selection route


def _keys(rng, dtype):
    if dtype == "float32":
        k = (rng.integers(-50, 50, N) / 4).astype(np.float32)  # many ties
        k[rng.integers(0, N, 40)] = np.nan
        k[:6] = [np.inf, -np.inf, -0.0, 0.0, np.nan, -np.nan]
        return k
    if dtype == "int32":
        return rng.integers(-100, 100, N).astype(np.int32)
    return rng.integers(0, 2**32, N, dtype=np.uint32)


CASES = [("float32", 100, True), ("float32", 7, False), ("uint32", 1, True),
         ("int32", 600, True), ("int32", 33, False)]


@pytest.mark.parametrize("dtype,k,largest", CASES)
def test_top_k_matches_jax(dtype, k, largest):
    rng = np.random.default_rng(CASES.index((dtype, k, largest)))
    keys = _keys(rng, dtype)
    jv, ji = j_top_k(keys, k, largest, JCFG)
    assert tt.select_applies(k, CFG) == (k <= 512)
    for cfg in (CFG, SMALL):
        v, i = top_k(keys, k, largest, cfg, device="cpu")
        assert v.dtype == torch.from_numpy(keys).dtype and i.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_top_k_numpy_model_both_routes():
    """Stable order on ties, NaN first when largest; k = n and k = 1."""
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 30, 5000).astype(np.uint32)
    for k in (1, 31, 32, 33, 500, 5000):
        for largest in (True, False):
            order = np.argsort(-keys.astype(np.int64) if largest else keys,
                               kind="stable")[:k]
            for cfg in (SMALL, SortConfig(topk_chunk_elems=256)):
                v, i = top_k(keys, k, largest, cfg, device="cpu")
                np.testing.assert_array_equal(i.numpy(), order)
                np.testing.assert_array_equal(v.numpy(), keys[order])


def test_top_k_validation():
    keys = np.arange(10, dtype=np.uint32)
    for k in (0, 11):
        with pytest.raises(ValueError):
            top_k(keys, k, device="cpu")
    with pytest.raises(TypeError):
        top_k(np.zeros(4, np.int64), 1, device="cpu")
