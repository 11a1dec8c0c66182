"""The port's segmented scan (radx_tpu_torch/kernels/segscan.py) against the
JAX package's ``segscan_flat`` (radx_tpu/kernels/segscan.py, Pallas in
interpret mode, 1024-row chunks so runs cross chunk boundaries).

Tolerances: integers and float32 min/max bit for bit; float32 sums within
1e-5 times the sum of magnitudes of the run so far (the two packages add in
different orders).  ``fill`` is compared where a flagged row precedes
(values and flags), and against a numpy model everywhere.  On the CPU the
port runs its plain PyTorch version; the card compares kernel and plain
version (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.kernels import segscan as jsg
from radx_tpu_torch.kernels import segscan as tsg

N = 3000
OPS = ("sum", "min", "max")
DTYPES = {"uint32": np.uint32, "int32": np.int32, "float32": np.float32}


def _sorted_keys(rng, n):
    """Short runs, one run of 1200 equal keys (across two JAX chunks) and
    0xFFFFFFFF keys at the end (the pad key of both packages)."""
    k = rng.integers(0, 400, n).astype(np.uint32)
    k[1000:2200] = 123
    k[-25:] = 0xFFFFFFFF
    return np.sort(k)


def _values(rng, n, dtype):
    if dtype == "float32":
        v = rng.standard_normal(n).astype(np.float32) * 100
        v[rng.integers(0, n, 60)] = rng.choice(
            np.array([0.0, -0.0, np.inf, -np.inf], np.float32), 60)
        v[7] = np.nan
        return v
    if dtype == "uint32":
        return rng.integers(0, 2**32, n, dtype=np.uint32)
    return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)


def _run_abs_sum(k, v):
    """Sum of |v| over each row's run up to the row, in float64."""
    a = np.abs(v.astype(np.float64))
    out = np.empty_like(a)
    for i in range(len(k)):
        out[i] = a[i] + (out[i - 1] if i and k[i] == k[i - 1] else 0.0)
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_segscan_matches_jax(op, dtype):
    rng = np.random.default_rng([OPS.index(op), list(DTYPES).index(dtype)])
    k = _sorted_keys(rng, N)
    v = _values(rng, N, dtype)
    if op == "sum" and dtype == "float32":
        v[~np.isfinite(v)] = 1.0  # inf - inf or NaN say nothing of the order
    want = np.asarray(jsg.segscan_flat(jnp.asarray(k), jnp.asarray(v), op, 8,
                                       True))
    for tile in (256, 2048):
        got = tsg.segscan_flat(torch.from_numpy(k), torch.from_numpy(v), op,
                               tile)
        assert got.dtype == torch.from_numpy(v).dtype
        got = got.numpy()
        if op == "sum" and dtype == "float32":
            err = np.abs(got.astype(np.float64) - want.astype(np.float64))
            assert (err <= 1e-5 * _run_abs_sum(k, v)).all()
        else:
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def test_float_zero_min_max_do_not_depend_on_order():
    """-0.0 and +0.0 in one run: min is -0.0 and max +0.0 whichever comes
    first (as jnp.minimum / jnp.maximum); NaN propagates."""
    k = np.zeros(4, np.uint32)
    for v in ([0.0, -0.0, 0.0, -0.0], [-0.0, 0.0, -0.0, 0.0]):
        v = np.array(v, np.float32)
        for op, sign in (("min", True), ("max", False)):
            want = np.asarray(jsg.segscan_flat(jnp.asarray(k), jnp.asarray(v),
                                               op, 8, True))
            got = tsg.segscan_flat(torch.from_numpy(k), torch.from_numpy(v),
                                   op, 256).numpy()
            assert np.signbit(got[-1]) == sign == np.signbit(want[-1])
    v = np.array([1.0, np.nan, -5.0], np.float32)
    for op in ("min", "max"):
        got = tsg.segscan_flat(torch.zeros(3, dtype=torch.uint32),
                               torch.from_numpy(v), op, 256).numpy()
        assert got[0] == 1.0 and np.isnan(got[1:]).all()


def _fill_model(k, vals, flags):
    outs, houts = [], []
    for v, h in zip(vals, flags):
        o, ho = v.copy(), np.zeros(len(k), np.bool_)
        last = None
        for i in range(len(k)):
            if i == 0 or k[i] != k[i - 1]:
                last = None
            if h[i]:
                last = v[i]
            if last is not None:
                o[i], ho[i] = last, True
        outs.append(o)
        houts.append(ho)
    return outs, houts


@pytest.mark.parametrize("m", [1, 2])
def test_fill_matches_jax_and_model(m):
    rng = np.random.default_rng(40 + m)
    k = _sorted_keys(rng, N)
    vals = [_values(rng, N, "uint32") for _ in range(m)]
    flags = [rng.random(N) < 0.02 for _ in range(m)]
    jv, jh = jsg.segscan_flat(jnp.asarray(k), [jnp.asarray(v) for v in vals],
                              "fill", 8, True,
                              has=[jnp.asarray(h) for h in flags])
    mv, mh = _fill_model(k, vals, flags)
    for tile in (256, 1024):
        gv, gh = tsg.segscan_flat(torch.from_numpy(k),
                                  [torch.from_numpy(v) for v in vals], "fill",
                                  tile, has=[torch.from_numpy(h) for h in flags])
        for j in range(m):
            got_h = gh[j].numpy()
            np.testing.assert_array_equal(got_h, np.asarray(jh[j]))
            np.testing.assert_array_equal(got_h, mh[j])
            np.testing.assert_array_equal(gv[j].numpy()[got_h],
                                          np.asarray(jv[j])[got_h])
            np.testing.assert_array_equal(gv[j].numpy(), mv[j])


def test_segscan_all_equal_keys_and_one_row():
    k = np.full(2000, 0xFFFFFFFF, np.uint32)
    v = np.arange(2000, dtype=np.int32)
    want = np.asarray(jsg.segscan_flat(jnp.asarray(k), jnp.asarray(v), "sum",
                                       8, True))
    got = tsg.segscan_flat(torch.from_numpy(k), torch.from_numpy(v), "sum", 256)
    np.testing.assert_array_equal(got.numpy(), want)
    one = tsg.segscan_flat(torch.tensor([3], dtype=torch.uint32),
                           torch.tensor([-4], dtype=torch.int32), "max", 256)
    assert one.tolist() == [-4]


def test_segscan_counts_and_validation():
    tsg.reset_counts()
    k = torch.zeros(8, dtype=torch.int32)
    tsg.segscan_planes(k, k.clone(), "sum", torch.int32, 256)
    assert tsg.PLAIN_CALLS["segscan_ref"] == 1
    assert not any(tsg.LAUNCHES.values())
    with pytest.raises(ValueError, match="unknown"):
        tsg.segscan_planes(k, k, "mean", torch.int32, 256)
    with pytest.raises(TypeError):
        tsg.segscan_planes(k, k, "sum", torch.int64, 256)
    with pytest.raises(ValueError):
        tsg.segscan_planes(k, k, "sum", torch.int32, 128)
    with pytest.raises(ValueError):
        tsg.segscan_planes(k, k[:4], "sum", torch.int32, 256)
    with pytest.raises(ValueError):
        tsg.segscan_planes(k, [k] * 5, "fill", torch.int32, 256, [k] * 5)
    with pytest.raises(ValueError):
        tsg.segscan_planes(k, [k], "fill", torch.int32, 256, [])
    with pytest.raises(ValueError, match="unsupported device"):
        tsg.segscan_planes(k.to("meta"), k.to("meta"), "sum", torch.int32, 256)
