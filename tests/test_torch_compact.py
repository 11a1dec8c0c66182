"""The port's compaction (radx_tpu_torch/kernels/compact.py), filter
(ops/filter.py) and unique (ops/distinct.py) against the JAX package's
(radx_tpu/kernels/compact.py, ops/filter.py, ops/distinct.py; Pallas in
interpret mode), bit for bit (tolerance 0: int32 planes); and the two
compaction-bound group-by cases: the group of key 0xFFFFFFFF that the pads
join (with and without the phantom all-pad group) and the filter -> groupby
pipeline of the BASELINE's config-3 query.

On the CPU the port's wrappers run their plain PyTorch versions; the card
compares kernel and plain version (tests/test_torch_gpu.py, chip_smoke.py).
The rows past ``count`` are not part of either package's result and are not
compared.  Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.kernels import compact as jc
from radx_tpu.ops.distinct import unique as j_unique
from radx_tpu.ops.filter import filter_columns as j_filter
from radx_tpu.ops.groupby import groupby as j_groupby
from radx_tpu_torch import SortConfig, filter_columns, groupby, unique
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import compact as tc

JCFG = JaxSortConfig(chunk_rows=8, rider_chunk_rows=8, compact_chunk_rows=8)
CFG = config_from_jax(JCFG)
N = 2000  # pads to 2048: the phantom all-pad group exists


def _planes(rng, n, p):
    return [rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
            for _ in range(p)]


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_compact_matches_jax(density):
    """P = 1, 2, 3 planes, a ragged n across several JAX chunks; one JAX
    result per plane count."""
    rng = np.random.default_rng(int(density * 10))
    n = 3 * 1024 + 77
    mask = (rng.random(n) < density).astype(np.int32)
    for p in (1, 2, 3):
        planes = _planes(rng, n, p)
        jouts, jcount = jc.compact_flat(
            jnp.asarray(mask), [jnp.asarray(x) for x in planes], 8,
            interpret=True)
        jcount = int(jcount)
        for tile in (256, CFG.compact_elems):
            outs, count = tc.compact(torch.from_numpy(mask),
                                     [torch.from_numpy(x) for x in planes],
                                     tile)
            assert count.dtype == torch.int32 and count.dim() == 0
            assert int(count) == jcount == int(mask.sum())
            for got, want, x in zip(outs, jouts, planes):
                np.testing.assert_array_equal(got[:jcount].numpy(),
                                              np.asarray(want)[:jcount])
                np.testing.assert_array_equal(got[:jcount].numpy(),
                                              x[mask != 0])


def test_compact_counts_plain_calls_and_validates():
    tc.reset_counts()
    m = torch.tensor([1, 0, 1], dtype=torch.int32)
    outs, count = tc.compact(m, [torch.tensor([7, 8, 9], dtype=torch.int32)],
                             1024)
    assert outs[0][:2].tolist() == [7, 9] and int(count) == 2
    assert tc.PLAIN_CALLS["compact_ref"] == 1 and not any(tc.LAUNCHES.values())
    x = torch.zeros(3, dtype=torch.int32)
    # no planes: the count alone (K7's zero-plane case)
    none, count0 = tc.compact(m, [], 1024)
    assert none == [] and int(count0) == 2
    with pytest.raises(ValueError):
        tc.compact(m, [x] * 5, 1024)
    with pytest.raises(ValueError):
        tc.compact(m, [torch.zeros(4, dtype=torch.int32)], 1024)
    with pytest.raises(ValueError):
        tc.compact(m, [x.long()], 1024)
    with pytest.raises(ValueError):
        tc.compact(m, [x], 1000)
    with pytest.raises(ValueError, match="unsupported device"):
        tc.compact(m.to("meta"), [x.to("meta")], 1024)


def test_filter_columns_matches_jax():
    rng = np.random.default_rng(3)
    n = 2500
    mask = rng.random(n) < 0.3
    cols = [rng.integers(0, 2**32, n, dtype=np.uint32),
            rng.standard_normal(n).astype(np.float32),
            rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)]
    jouts, jcount = j_filter(mask, cols, JCFG)
    jcount = int(jcount)
    outs, count = filter_columns(torch.from_numpy(mask),
                                 [torch.from_numpy(c) for c in cols], CFG)
    assert int(count) == jcount
    for got, want, c in zip(outs, jouts, cols):
        assert got.dtype == torch.from_numpy(c).dtype
        np.testing.assert_array_equal(got[:jcount].numpy().view(np.uint32),
                                      np.asarray(want)[:jcount].view(np.uint32))
    # more columns than one kernel pass takes, numpy input with device=
    many = [c for c in _planes(rng, n, 6)]
    outs, count = filter_columns(mask.astype(np.int32), many, device="cpu")
    for got, c in zip(outs, many):
        np.testing.assert_array_equal(got[: int(count)].numpy(), c[mask])


def test_filter_columns_edges_and_validation():
    outs, count = filter_columns(torch.zeros(0, dtype=torch.int32),
                                 [torch.zeros(0, dtype=torch.uint32)])
    assert int(count) == 0 and outs[0].numel() == 0
    # no columns: the count alone (a COUNT(*) ... WHERE), equal to the count
    # of a one-column call on the same mask
    mask4 = torch.tensor([1, 0, 1, 1])
    none, count0 = filter_columns(mask4, [])
    _, count1 = filter_columns(mask4, [torch.zeros(4, dtype=torch.int32)])
    assert none == [] and count0.dtype == torch.int32 and count0.dim() == 0
    assert int(count0) == int(count1) == 3
    with pytest.raises(ValueError, match="match mask"):
        filter_columns(torch.ones(4), [torch.zeros(3, dtype=torch.int32)])
    with pytest.raises(TypeError, match="32-bit"):
        filter_columns(torch.ones(4), [torch.zeros(4, dtype=torch.int64)])
    with pytest.raises(ValueError, match="1-D"):
        filter_columns(torch.ones(2, 2), [torch.zeros(2, dtype=torch.int32)])


def test_filter_keeps_the_reference_row_cap(monkeypatch):
    """ROADMAP F3: the reference raises above 2^30 rows per call; so does
    the port (checked on a small array by lowering the cap)."""
    from radx_tpu_torch.ops import filter as tf

    monkeypatch.setattr(tf, "MAX_ROWS", 8)
    with pytest.raises(ValueError, match="2\\^30"):
        tf.filter_columns(torch.ones(9), [torch.zeros(9, dtype=torch.int32)])
    assert tf.filter_columns(torch.ones(8),
                             [torch.zeros(8, dtype=torch.int32)])[1] == 8


@pytest.mark.parametrize("dtype", ["uint32", "float32"])
def test_unique_matches_jax(dtype):
    rng = np.random.default_rng(4)
    n = 3000
    if dtype == "uint32":
        keys = rng.integers(0, 700, n, dtype=np.uint32)
        keys[:40] = 0xFFFFFFFF  # the pad sentinel as a real key
    else:
        keys = rng.integers(-20, 20, n).astype(np.float32) / 4
        keys[:30] = [np.nan, -0.0, 0.0, np.inf, -np.inf] * 6
    jv, jc_, jcount = j_unique(keys, return_counts=True, cfg=JCFG)
    jcount = int(jcount)
    for cfg in (CFG, SortConfig(strategy="lax")):
        v, c, count = unique(torch.from_numpy(keys), True, cfg)
        assert int(count) == jcount
        np.testing.assert_array_equal(v[:jcount].numpy().view(np.uint32),
                                      np.asarray(jv)[:jcount].view(np.uint32))
        np.testing.assert_array_equal(c[:jcount].numpy(),
                                      np.asarray(jc_)[:jcount])
        v2, count2 = unique(torch.from_numpy(keys), cfg=cfg)
        assert int(count2) == jcount
        assert torch.equal(v2[:jcount].view(torch.int32),
                           v[:jcount].view(torch.int32))


def test_unique_small_and_validation():
    v, c, count = unique(np.array([5], np.uint32), True, device="cpu")
    assert int(count) == 1 and v[0] == 5 and c[0] == 1
    v, count = unique(np.array([3, 3, 1, 3], np.int32), device="cpu")
    assert v[: int(count)].tolist() == [1, 3]
    with pytest.raises(ValueError):
        unique(torch.zeros(0, dtype=torch.uint32))
    with pytest.raises(TypeError):
        unique(torch.zeros(3, dtype=torch.int64))


def _check_groupby(keys, vals, agg):
    juk, jout, jng = j_groupby(keys, vals, agg, JCFG)
    jng = int(jng)
    uk, out, ng = groupby(torch.from_numpy(keys), torch.from_numpy(vals), agg,
                          CFG)
    assert int(ng) == jng
    np.testing.assert_array_equal(uk[:jng].numpy(), np.asarray(juk)[:jng])
    np.testing.assert_array_equal(out[:jng].numpy(), np.asarray(jout)[:jng])


@pytest.mark.parametrize("n", [N, 1024])
def test_groupby_max_key_group_and_phantom(n):
    """0xFFFFFFFF as a real key: the pads join its group and add their
    neutral element (n = 2000); with no padding (n = 1024) there is no
    phantom group to drop."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 50, n, dtype=np.uint32)
    keys[::7] = 0xFFFFFFFF
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    _check_groupby(keys, vals, "min" if n == N else "count")


def test_filter_then_groupby_matches_jax():
    """The config-3 query at a small size: filter on a predicate column,
    then group the kept rows by key and sum their values."""
    rng = np.random.default_rng(10)
    n = 3000
    key = rng.integers(0, 1 << 8, n, dtype=np.uint32)
    val = rng.integers(0, 1 << 11, n, dtype=np.uint32)
    pred = rng.integers(0, 2**32, n, dtype=np.uint32)
    mask = pred < (1 << 31)
    (jk, jv), jc = j_filter(mask, [key, val], JCFG)
    jc = int(jc)
    juk, jout, jng = j_groupby(np.asarray(jk)[:jc], np.asarray(jv)[:jc], "sum",
                               JCFG)
    jng = int(jng)
    (fk, fv), count = filter_columns(torch.from_numpy(mask),
                                     [torch.from_numpy(key),
                                      torch.from_numpy(val)], CFG)
    c = int(count)
    assert c == jc
    uk, out, ng = groupby(fk[:c], fv[:c], "sum", CFG)
    assert int(ng) == jng
    np.testing.assert_array_equal(uk[:jng].numpy(), np.asarray(juk)[:jng])
    np.testing.assert_array_equal(out[:jng].numpy(), np.asarray(jout)[:jng])
