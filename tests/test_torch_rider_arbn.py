"""The arbitrary-N (key, rider) sort of the port
(radx_tpu_torch/ops/sort.py::_sort_rider_arbn) and the group-by that runs on
it, against the JAX package (Pallas in interpret mode), which pads the rider
sort to a power of two.

The port takes this path from 2^22 rows where a power of two would waste more
than 10%; here ``_use_decomposition`` is patched so that small inputs take it
too, with tiny rider tiles (16 / 64 rows: two or three pieces and their valley
merges).  Its padded length is ``blocks * chunk`` instead of ``_pad_len(n)``,
so the two packages agree on what callers read: the n real rows of the sort,
as a (key, rider) multiset (tied keys' riders come in no set order), and the
first ``num_groups`` rows of a group-by.  Keys, group counts, integer
aggregates and float32 min / max bit for bit; float32 sums within 1e-5 times
the group's sum of magnitudes (the packages add in different orders).  Each
case costs one JAX compilation; the cases that share one (the same n, dtypes
and aggregate) reuse it.  On the CPU the kernel wrappers run their plain
PyTorch versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radx_tpu
from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import sort as js
from radx_tpu.ops.groupby import groupby as j_groupby
from radx_tpu_torch import SortConfig, Table, groupby
from radx_tpu_torch.kernels import msd as tm
from radx_tpu_torch.ops import sort as ts

JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     rider_chunk_rows=8, compact_chunk_rows=8,
                     topk_chunk_rows=8, interpret=True)
SMALL = SortConfig(rider_chunk_elems=16, rider_finish_elems=64,
                   compact_elems=64, scan_elems=256)
FF = 0xFFFFFFFF
NEUTRAL = -7


@pytest.fixture
def decomposed(monkeypatch):
    """Every rider sort outside ``"lax"`` takes the arbitrary-N path; the
    list holds the n of each call."""
    calls = []
    real = ts._sort_rider_arbn

    def spy(keys, payload, cfg, n, neutral):
        calls.append(n)
        return real(keys, payload, cfg, n, neutral)

    monkeypatch.setattr(ts, "_use_decomposition",
                        lambda n, cfg: cfg.strategy != "lax")
    monkeypatch.setattr(ts, "_sort_rider_arbn", spy)
    return calls


def _total(n, cfg=SMALL):
    blocks, _ = ts._decompose_blocks(n, cfg.rider_chunk_elems)
    return blocks * cfg.rider_chunk_elems


def test_sizes_cover_pads_none_and_three_pieces():
    assert ts._decompose_blocks(3000, 16) == (192, [128, 64])
    assert ts._decompose_blocks(3072, 16) == (192, [128, 64])  # no pads
    assert ts._decompose_blocks(5127, 16) == (336, [256, 64, 16])


# --- (a) the sort itself --------------------------------------------------------


def _rider_keys(rng, n, dist):
    if dist == "low":
        return rng.integers(0, 16, n, dtype=np.uint32)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    if dist == "ff_1pct":
        keys[rng.choice(n, n // 100, replace=False)] = FF
    return keys


def _drop_pads(keys, riders, pads):
    """The rows sorted by (key, rider) without ``pads`` rows (0xFFFFFFFF,
    NEUTRAL): the real rows' multiset."""
    order = np.lexsort((riders, keys))
    keys, riders = keys[order], riders[order]
    at = np.flatnonzero((keys == FF) & (riders == NEUTRAL))
    assert at.size >= pads
    keep = np.ones(keys.size, bool)
    keep[at[:pads]] = False
    return keys[keep], riders[keep]


@pytest.mark.parametrize("n", [3000, 5120 + 7])
def test_sort_rider_arbn_matches_jax(n):
    """Uniform keys, low-entropy keys and keys with 1% 0xFFFFFFFF (which
    the pads join), on one JAX compilation."""
    rng = np.random.default_rng(n)
    total = _total(n)
    assert total < ts._pad_len(n)
    for dist in ("uniform", "low", "ff_1pct"):
        keys = _rider_keys(rng, n, dist)
        payload = rng.permutation(n).astype(np.int32)
        k, r = ts._sort_rider_arbn(torch.from_numpy(keys),
                                   torch.from_numpy(payload), SMALL, n,
                                   NEUTRAL)
        assert k.dtype == torch.uint32 and r.dtype == torch.int32
        k, r = k.numpy(), r.numpy()
        assert k.shape == r.shape == (total,)
        np.testing.assert_array_equal(k[:n], np.sort(keys), err_msg=dist)
        assert (k[n:] == FF).all()
        jk, jr = js._sort_rider_jit(jnp.asarray(keys), jnp.asarray(payload),
                                    JCFG, n, NEUTRAL)
        jk, jr = np.asarray(jk), np.asarray(jr)
        got = _drop_pads(k, r, total - n)
        want = _drop_pads(jk, jr, jk.size - n)
        np.testing.assert_array_equal(got[0], want[0], err_msg=dist)
        np.testing.assert_array_equal(got[1], want[1], err_msg=dist)


# --- (b) the group-by on it -------------------------------------------------------


def _keys(rng, n, dtype, ff):
    """Keys whose encoding is 0xFFFFFFFF at a few rows when ``ff`` (uint32
    0xFFFFFFFF, int32 2^31 - 1, the float32 NaN 0x7FFFFFFF)."""
    if dtype == "float32":
        k = rng.integers(-40, 40, n).astype(np.float32) / 8
        k[:12] = [np.nan, -0.0, 0.0, np.inf, -np.inf, -0.0] * 2
        top = np.uint32(0x7FFFFFFF).view(np.float32)
    elif dtype == "int32":
        k = rng.integers(-300, 300, n).astype(np.int32)
        top = np.int32(2**31 - 1)
    else:
        k = rng.integers(0, 300, n, dtype=np.uint32)
        top = np.uint32(FF)
    if ff:
        k[rng.choice(n, 9, replace=False)] = top
    return k


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


# (agg, key and value dtype, n): n = 3072 is whole blocks (no pads), 3000
# and 5127 leave pads (5127: three pieces)
GRID = [("sum", "uint32", 3000), ("sum", "int32", 3072),
        ("sum", "float32", 5127), ("count", "uint32", 3072),
        ("count", "int32", 3000), ("count", "float32", 3000),
        ("min", "uint32", 3000), ("min", "int32", 3072),
        ("min", "float32", 3000), ("max", "uint32", 3072),
        ("max", "int32", 3000), ("max", "float32", 3072)]


@pytest.mark.parametrize("agg,dtype,n", GRID)
def test_groupby_decomposed_matches_jax(decomposed, agg, dtype, n):
    """Each case with the 0xFFFFFFFF group present and absent (the phantom
    rule), on one JAX compilation."""
    rng = np.random.default_rng([GRID.index((agg, dtype, n))])
    vals = _values(rng, n, dtype)
    for ff in (True, False):
        keys = _keys(rng, n, dtype, ff)
        juk, jout, jng = j_groupby(keys, vals, agg, JCFG)
        jng = int(jng)
        juk, jout = np.asarray(juk)[:jng], np.asarray(jout)[:jng]
        del decomposed[:]
        uk, out, ng = groupby(torch.from_numpy(keys), torch.from_numpy(vals),
                              agg, SMALL)
        assert decomposed == [n]
        assert uk.numel() == out.numel() == _total(n)
        assert ng.dtype == torch.int32 and int(ng) == jng, ff
        np.testing.assert_array_equal(uk[:jng].numpy().view(np.uint32),
                                      juk.view(np.uint32))
        got = out[:jng].numpy()
        assert got.dtype == jout.dtype
        if agg == "sum" and dtype == "float32":
            err = np.abs(got.astype(np.float64) - jout.astype(np.float64))
            assert (err <= 1e-5 * _group_abs_sums(keys, vals, juk)).all()
        else:
            np.testing.assert_array_equal(got.view(np.uint32),
                                          jout.view(np.uint32))


# --- (c) LazyTable: the rows past the count sort as 0xFFFFFFFF --------------------


@pytest.mark.parametrize("agg,n,ff", [("count", 3072, True),
                                      ("max", 3000, False)])
def test_lazy_groupby_decomposed_matches_jax(decomposed, agg, n, ff):
    """After a filter only the rows below the count are valid; the invalid
    rows take key 0xFFFFFFFF and the neutral rider, and their group goes
    unless a valid key is 0xFFFFFFFF (n = 3072: no pads, only them)."""
    rng = np.random.default_rng([n, ff])
    a = {"k": rng.integers(0, 1000, n).astype(np.uint32),
         "v": rng.integers(0, 2**32, n, dtype=np.uint32)}
    mask = (a["v"] % 3) != 0
    if ff:
        a["k"][:3] = FF
        mask[:3] = True
    want = (radx_tpu.Table.from_arrays(**a).lazy(JCFG)
            .filter(jnp.asarray(mask)).groupby("k", "v", agg)
            .collect().to_numpy())
    lazy = Table.from_arrays(device="cpu", **a).lazy(SMALL).filter(
        torch.from_numpy(mask)).groupby("k", "v", agg)
    assert decomposed == [n]
    got = lazy.collect().to_numpy()
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name].view(np.uint32),
                                      want[name].view(np.uint32), err_msg=name)
    assert (got["k"] == FF).any() == ff


# --- the radix strategy on the last piece -----------------------------------------


def test_groupby_decomposed_radix_last_piece(decomposed):
    """Under ``"radix"`` the last piece (64 blocks of 1024 rows: 2^16, the
    smallest radix plan at these tiles) goes through the distribution sort,
    pads and real 0xFFFFFFFF keys beside each other."""
    cfg = SortConfig(strategy="radix", chunk_elems=1024, finish_elems=2048,
                     rider_chunk_elems=1024, rider_finish_elems=2048)
    n = 3 * (1 << 16) - 5  # 192 blocks: pieces of 128 and 64
    assert ts._decompose_blocks(n, 1024) == (192, [128, 64])
    rng = np.random.default_rng(19)
    keys = rng.integers(0, 5000, n, dtype=np.uint32)
    keys[::97] = FF
    vals = rng.integers(0, 1 << 20, n, dtype=np.uint32)
    tm.reset_counts()
    uk, out, ng = groupby(keys, vals, "sum", cfg, device="cpu")
    assert decomposed == [n] and tm.PLAIN_CALLS["radix_concat_ref"] == 1
    ek, inv = np.unique(keys, return_inverse=True)
    assert int(ng) == ek.size
    np.testing.assert_array_equal(uk[: ek.size].numpy(), ek)
    np.testing.assert_array_equal(out[: ek.size].numpy(),
                                  np.bincount(inv, vals).astype(np.uint32))


# --- (d) the routing at the benchmark's size --------------------------------------


class _Stop(Exception):
    pass


def test_groupby_of_1e8_rows_takes_the_decomposition(monkeypatch):
    """db-benchmark q3's 1e8 rows: 12288 blocks of the 2^13-row rider tile,
    two pieces (0.66% pads instead of 2^27 rows).  The group-by reaches
    ``_sort_rider_arbn`` with every row (shapes only, on the meta device:
    nothing runs)."""
    n, cfg = 10**8, SortConfig()
    assert cfg.mode_tiles(2, 1) == (1 << 13, 1 << 13)
    assert ts._decompose_blocks(n, 1 << 13) == (12288, [8192, 4096])
    assert ts._use_decomposition(n, cfg)
    seen = []

    def spy(keys, payload, cfg, n, neutral):
        seen.append((keys.numel(), payload.numel(), n, neutral))
        raise _Stop

    monkeypatch.setattr(ts, "_sort_rider_arbn", spy)
    keys = torch.empty(n, dtype=torch.uint32, device="meta")
    for agg, neutral in (("sum", 0), ("count", 0), ("min", -1)):
        with pytest.raises(_Stop):
            groupby(keys, keys, agg)
        assert seen.pop() == (n, n, n, neutral)
    # whole powers of two and sizes just below one keep the padded path
    for m in (1 << 27, (1 << 27) - 5, 1 << 28, (1 << 22) - 1):
        assert not ts._use_decomposition(m, cfg)
