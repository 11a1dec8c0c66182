"""The port's ``groupby`` (radx_tpu_torch/ops/groupby.py) against the JAX
package's (radx_tpu/ops/groupby.py, Pallas in interpret mode).  The
0xFFFFFFFF-key / phantom-group cases and the filter -> groupby pipeline are
in tests/test_torch_compact.py (each file stays short in interpret mode).

Tolerances: keys, group counts, integer aggregates and float32 min / max bit
for bit; float32 sums within 1e-5 times the group's sum of magnitudes (the
two packages add in different orders).  The grid of key dtype x value dtype
x aggregate is reduced to keep interpret mode inside its time: every
aggregate runs on matched key / value dtypes and once on mixed ones.  On the
CPU the port's kernel wrappers run their plain PyTorch versions.
"""

import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops.groupby import groupby as j_groupby
from radx_tpu_torch import SortConfig, groupby
from radx_tpu_torch.config import config_from_jax

JCFG = JaxSortConfig(chunk_rows=8, rider_chunk_rows=8, compact_chunk_rows=8)
CFG = config_from_jax(JCFG)
SMALL = SortConfig(rider_chunk_elems=16, rider_finish_elems=64,
                   compact_elems=64, scan_elems=256)
N = 2000  # pads to 2048: the phantom all-pad group exists


def _keys(rng, n, dtype):
    if dtype == "float32":
        k = rng.integers(-40, 40, n).astype(np.float32) / 8
        k[:12] = [np.nan, -0.0, 0.0, np.inf, -np.inf, -0.0] * 2
        return k
    if dtype == "int32":
        return rng.integers(-300, 300, n).astype(np.int32)
    return rng.integers(0, 300, n, dtype=np.uint32)


def _values(rng, n, dtype):
    if dtype == "float32":
        v = (rng.standard_normal(n) * 50).astype(np.float32)
        v[rng.integers(0, n, 40)] = rng.choice(
            np.array([0.0, -0.0], np.float32), 40)
        return v
    if dtype == "int32":
        return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    return rng.integers(0, 2**32, n, dtype=np.uint32)


def _group_abs_sums(keys, vals, uk):
    kb, ub = keys.view(np.uint32), uk.view(np.uint32)
    a = np.abs(vals.astype(np.float64))
    return np.array([a[kb == u].sum() for u in ub])


def _check(keys, vals, agg, cfgs=(CFG, SMALL)):
    juk, jout, jng = j_groupby(keys, vals, agg, JCFG)
    jng = int(jng)
    juk, jout = np.asarray(juk)[:jng], np.asarray(jout)[:jng]
    for cfg in cfgs:
        uk, out, ng = groupby(torch.from_numpy(keys), torch.from_numpy(vals),
                              agg, cfg)
        assert ng.dtype == torch.int32 and ng.dim() == 0
        assert int(ng) == jng
        assert uk.dtype == torch.from_numpy(keys).dtype
        assert uk.numel() >= keys.size
        got_k, got = uk[:jng].numpy(), out[:jng].numpy()
        np.testing.assert_array_equal(got_k.view(np.uint32), juk.view(np.uint32))
        assert got.dtype == jout.dtype
        if agg == "sum" and vals.dtype == np.float32:
            err = np.abs(got.astype(np.float64) - jout.astype(np.float64))
            assert (err <= 1e-5 * _group_abs_sums(keys, vals, juk)).all()
        else:
            np.testing.assert_array_equal(got.view(np.uint32),
                                          jout.view(np.uint32))


GRID = [(agg, kd, vd) for agg in ("sum", "count", "min", "max")
        for kd, vd in (("uint32", "uint32"), ("int32", "int32"),
                       ("float32", "float32"))]
GRID += [("min", "int32", "float32")]


@pytest.mark.parametrize("agg,key_dtype,val_dtype", GRID)
def test_groupby_matches_jax(agg, key_dtype, val_dtype):
    rng = np.random.default_rng([len(GRID), GRID.index((agg, key_dtype,
                                                        val_dtype))])
    _check(_keys(rng, N, key_dtype), _values(rng, N, val_dtype), agg)


def test_groupby_lax_strategy_and_numpy_model():
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 100, 3000, dtype=np.uint32)
    keys[:5] = 0xFFFFFFFF
    vals = rng.integers(0, 1 << 11, 3000, dtype=np.uint32)
    ek, inv = np.unique(keys, return_inverse=True)
    for cfg in (SortConfig(strategy="lax"), SMALL):
        for agg, want in (("sum", np.bincount(inv, vals).astype(np.uint32)),
                          ("count", np.bincount(inv).astype(np.int32)),
                          ("max", np.array([vals[keys == k].max() for k in ek]))):
            uk, out, ng = groupby(keys, vals, agg, cfg, device="cpu")
            assert int(ng) == ek.size
            np.testing.assert_array_equal(uk[: ek.size].numpy(), ek)
            np.testing.assert_array_equal(out[: ek.size].numpy(), want)


def test_groupby_validation_and_empty():
    k = torch.zeros(4, dtype=torch.uint32)
    uk, out, ng = groupby(k[:0], k[:0])
    assert int(ng) == 0 and uk.numel() == 0
    with pytest.raises(TypeError):
        groupby(k, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        groupby(torch.zeros(4, dtype=torch.int64), k)
    with pytest.raises(ValueError):
        groupby(k, k[:3])
    with pytest.raises(ValueError, match="agg"):
        groupby(k, k, "mean")
