"""The port's dense GROUP BY (radx_tpu_torch/kernels/aggregate.py,
ops/groupby.groupby_dense) against the JAX package's (radx_tpu/kernels/
aggregate.py in interpret mode, radx_tpu.groupby_dense), bit for bit
(tolerance 0: integer sums wrap mod 2^32 in both, extrema and counts are
exact).  On the CPU the port's wrappers run their plain PyTorch versions;
tests/test_torch_gpu.py holds the CUDA kernels against those on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radx_tpu
from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.kernels import aggregate as ja
from radx_tpu_torch import SortConfig, groupby_dense
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import aggregate as ta

JCFG = JaxSortConfig(chunk_rows=8, compact_chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
N = 3000


def _keys(rng, n, bins):
    """Keys mostly below ``bins``, some at or above it (dropped), some
    >= 2^31 (negative as int32)."""
    k = rng.integers(0, bins, n, dtype=np.uint32)
    k[rng.integers(0, n, 60)] = rng.integers(bins, 2 * bins, 60, dtype=np.uint32)
    k[rng.integers(0, n, 30)] = rng.integers(2**31, 2**32, 30, dtype=np.uint32)
    k[: n // 4] = 3  # a hot key
    return k


@pytest.mark.parametrize("bins", [128, 1 << 16])
def test_dense_sums_matches_jax(bins):
    rng = np.random.default_rng(bins)
    k = _keys(rng, N, bins)
    v = rng.integers(-(2**31), 2**31, N, dtype=np.int64).astype(np.int32)
    n_valid = N - 777
    js, jc = ja.dense_sums(jnp.asarray(k), jnp.asarray(v), bins=bins,
                           interpret=True, n_valid=n_valid)
    ts, tc = ta.dense_sums(torch.from_numpy(k), torch.from_numpy(v), bins,
                           torch.tensor(n_valid, dtype=torch.int32))
    assert ts.dtype == torch.uint32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # no n_valid: every row; an empty prefix: nothing
    whole = ta.dense_sums(torch.from_numpy(k), torch.from_numpy(v), bins)[1]
    keep = k < bins
    np.testing.assert_array_equal(whole.numpy(),
                                  np.bincount(k[keep], minlength=bins))
    none = ta.dense_sums(torch.from_numpy(k), torch.from_numpy(v), bins,
                         torch.tensor(0, dtype=torch.int32))
    assert not none[0].view(torch.int32).any() and not none[1].any()


@pytest.mark.parametrize("bins,is_min", [(128, True), (128, False),
                                         (1 << 13, True)])
def test_dense_extrema_matches_jax(bins, is_min):
    rng = np.random.default_rng([bins, is_min])
    k = _keys(rng, N, bins)
    k[k == 5] = 6  # bin 5 empty: it keeps the identity
    v = rng.integers(-(2**31), 2**31, N, dtype=np.int64).astype(np.int32)
    n_valid = N - 123
    je, jc = ja.dense_extrema(jnp.asarray(k), jnp.asarray(v), bins=bins,
                              is_min=is_min, interpret=True, n_valid=n_valid)
    te, tc = ta.dense_extrema(torch.from_numpy(k), torch.from_numpy(v), bins,
                              is_min, torch.tensor(n_valid, dtype=torch.int32))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(te[5]) == ((1 << 31) - 1 if is_min else -(1 << 31))


def test_dense_bounds_and_validation():
    k = torch.zeros(8, dtype=torch.uint32)
    for bins in (64, 100, 1 << 17):
        with pytest.raises(ValueError, match="bins"):
            ta.dense_sums(k, k, bins)
    with pytest.raises(ValueError, match="bins"):
        ta.dense_extrema(k, k, 1 << 14, True)
    with pytest.raises(ValueError, match="n_valid"):
        ta.dense_sums(k, k, 128, torch.tensor(3))  # int64
    with pytest.raises(ValueError, match="shape"):
        ta.dense_sums(k, k[:4], 128)
    ta.reset_counts()
    ta.dense_sums(k, k, 1 << 16)
    ta.dense_extrema(k, k.view(torch.int32), 1 << 13, False)
    assert not any(ta.LAUNCHES.values())
    assert all(v == 1 for v in ta.PLAIN_CALLS.values())


def _values(rng, n, dtype):
    if dtype == "float32":
        v = (rng.standard_normal(n) * 50).astype(np.float32)
        v[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, -0.0]
        return v
    if dtype == "int32":
        return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    return rng.integers(0, 2**32, n, dtype=np.uint32)


GRID = [("sum", "uint32", "uint32", 256), ("sum", "int32", "int32", 1 << 16),
        ("count", "uint32", "float32", 128), ("min", "int32", "float32", 256),
        ("max", "uint32", "uint32", 1 << 13), ("min", "uint32", "int32", 128)]


@pytest.mark.parametrize("agg,key_dtype,val_dtype,bins", GRID)
def test_groupby_dense_matches_jax(agg, key_dtype, val_dtype, bins):
    rng = np.random.default_rng(GRID.index((agg, key_dtype, val_dtype, bins)))
    k = rng.integers(0, min(bins, 200), N).astype(key_dtype)
    v = _values(rng, N, val_dtype)
    juk, jout, jng = radx_tpu.groupby_dense(k, v, agg, bins, JCFG)
    g = int(jng)
    uk, out, ng = groupby_dense(k, v, agg, bins, CFG, device="cpu")
    assert int(ng) == g and ng.dtype == torch.int32 and uk.numel() == bins
    assert uk.dtype == getattr(torch, key_dtype)
    np.testing.assert_array_equal(uk[:g].numpy(), np.asarray(juk)[:g])
    want = np.asarray(jout)[:g]
    assert out.dtype == getattr(torch, str(want.dtype))
    np.testing.assert_array_equal(out[:g].numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_groupby_dense_errors_match_jax():
    k = np.arange(300, dtype=np.uint32)
    v = np.ones(300, np.float32)
    cases = [
        ((k, v, "sum", 512), TypeError),  # float32 sums
        ((k, k, "sum", 256), ValueError),  # a key >= bins
        ((k, k, "min", 1 << 14), ValueError),  # min/max bins > 8192
        ((k, k, "sum", 1 << 17), ValueError),
        ((k, k, "count", 100), ValueError),
        ((k, k, "mean", 512), ValueError),
        ((v, k, "sum", 512), TypeError),  # float keys
        ((k, k[:5], "sum", 512), ValueError),
    ]
    for args, err in cases:
        with pytest.raises(err):
            radx_tpu.groupby_dense(*args, JCFG)
        with pytest.raises(err):
            groupby_dense(*args, CFG, device="cpu")
    neg = np.array([1, -1, 2], np.int32)  # -1 is 0xFFFFFFFF as a bin id
    with pytest.raises(ValueError, match="bins"):
        groupby_dense(neg, neg, "sum", 128, device="cpu")
    uk, out, ng = groupby_dense(k[:0], k[:0], device="cpu")
    assert int(ng) == 0 and uk.numel() == 0


def test_groupby_dense_numpy_model_and_small_tiles():
    rng = np.random.default_rng(3)
    k = rng.integers(0, 1000, 20_000).astype(np.uint32)
    v = rng.integers(0, 2**32, 20_000, dtype=np.uint32)
    ek, inv = np.unique(k, return_inverse=True)
    sums = np.zeros(ek.size, np.uint64)
    np.add.at(sums, inv, v.astype(np.uint64))
    for cfg in (SortConfig(compact_elems=64), CFG):
        uk, out, ng = groupby_dense(k, v, "sum", 1024, cfg, device="cpu")
        assert int(ng) == ek.size
        np.testing.assert_array_equal(uk[: ek.size].numpy(), ek)
        np.testing.assert_array_equal(out[: ek.size].numpy(),
                                      (sums % 2**32).astype(np.uint32))
