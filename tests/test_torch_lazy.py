"""The port's LazyTable (radx_tpu_torch/ops/lazy.py) against the JAX
package's (radx_tpu.LazyTable, Pallas in interpret mode): each operator after
a filter (so rows past the count are present and must be ignored), collected
and compared bit for bit.  The row count stays a 0-d int32 tensor until
``collect()``.  On the CPU the port's kernel wrappers run their plain
PyTorch versions; on a card ``chip_smoke.py`` runs lazy pipelines under
``torch.cuda.set_sync_debug_mode("error")``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radx_tpu
from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu_torch import LazyTable, Table
from radx_tpu_torch.config import config_from_jax

JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     rider_chunk_rows=8, compact_chunk_rows=8,
                     topk_chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
N = 2000


def _lazy(seed=0, n=N, keys=60):
    rng = np.random.default_rng(seed)
    a = {"k": rng.integers(0, keys, n).astype(np.uint32),
         "f": (rng.integers(-30, 30, n) / 4).astype(np.float32),
         "v": rng.integers(0, 2**32, n, dtype=np.uint32)}
    a["k"][:3] = 0xFFFFFFFF if keys > 256 else 1
    mask = (a["v"] % 3) != 0
    jl = radx_tpu.Table.from_arrays(**a).lazy(JCFG).filter(jnp.asarray(mask))
    tl = Table.from_arrays(device="cpu", **a).lazy(CFG).filter(
        torch.from_numpy(mask))
    return jl, tl


def _same(jl, tl):
    assert isinstance(tl, LazyTable)
    assert tl.count.dtype == torch.int32 and tl.count.dim() == 0
    want, got = jl.collect().to_numpy(), tl.collect().to_numpy()
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name].view(np.uint32),
                                      want[name].view(np.uint32), err_msg=name)


@pytest.mark.parametrize("agg,bins,keys", [("sum", None, 1000),
                                           ("min", 256, 200),
                                           ("count", 128, 100)])
def test_groupby_after_filter_matches_jax(agg, bins, keys):
    """The sort path (with 0xFFFFFFFF keys and the phantom group) and the
    dense path (count passed to the kernels as n_valid)."""
    jl, tl = _lazy(keys, keys=keys)
    _same(jl.groupby("k", "v", agg, bins=bins),
          tl.groupby("k", "v", agg, bins=bins))


def test_sort_by_and_distinct_match_jax():
    jl, tl = _lazy(1)
    _same(jl.sort_by("f", descending=True), tl.sort_by("f", descending=True))
    _same(jl.distinct("k"), tl.distinct("k"))


@pytest.mark.parametrize("k", [25, 1990])
def test_top_k_matches_jax(k):
    """k above the filtered count: invalid rows never win, count = min."""
    jl, tl = _lazy(2)
    _same(jl.top_k("v", k), tl.top_k("v", k))


def _dims(seed, dup):
    rng = np.random.default_rng(seed)
    dk = np.repeat(rng.permutation(80)[:50].astype(np.uint32), dup)
    dw = rng.integers(0, 2**32, dk.size, dtype=np.uint32)
    mask = np.arange(dk.size) % 7 != 3
    jd = radx_tpu.Table.from_arrays(k=dk, w=dw).lazy(JCFG).filter(
        jnp.asarray(mask))
    td = Table.from_arrays(k=dk, w=dw, device="cpu").lazy(CFG).filter(
        torch.from_numpy(mask))
    return jd, td


def test_join_matches_jax():
    jl, tl = _lazy(3, n=1200, keys=80)
    jd, td = _dims(3, 1)
    _same(jl.join(jd, "k", "v", "w"), tl.join(td, "k", "v", "w"))


def test_join_multi_matches_jax():
    jl, tl = _lazy(4, n=1000, keys=80)
    jd, td = _dims(4, 3)
    (jt, jtr), (tt, ttr) = (jl.join_multi(jd, "k", "v", "w", 2),
                            tl.join_multi(td, "k", "v", "w", 2))
    assert ttr.dim() == 0 and bool(ttr) == bool(jtr) == True  # noqa: E712
    _same(jt, tt)


def test_lazy_surface():
    t = Table.from_arrays(device="cpu", k=np.arange(8, dtype=np.uint32))
    lt = LazyTable(t.columns, 5)
    assert lt.count.dtype == torch.int32 and lt.padded_rows == 8
    assert lt.collect().num_rows == 5
    with pytest.raises(ValueError):
        lt.top_k("k", 9)
    with pytest.raises(ValueError):
        lt.groupby("k", "k", "mean")
    with pytest.raises(ValueError):
        lt.join_multi(lt, "k", "k", "k", 0)
    f = Table.from_arrays(device="cpu", k=np.ones(8, np.float32)).lazy()
    with pytest.raises(TypeError):
        f.groupby("k", "k", "count", bins=128)
