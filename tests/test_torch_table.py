"""The port's Table (radx_tpu_torch/ops/table.py) against the JAX package's
(radx_tpu.Table, Pallas in interpret mode), operator by operator, bit for
bit (every order involved is total: stable sorts, key-ordered joins and
group-bys), and the port of examples/query_pipeline.py on the CPU.  On the
CPU the port's kernel wrappers run their plain PyTorch versions."""

import numpy as np
import pytest
import torch

import radx_tpu
from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu_torch import SortConfig, Table
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.examples import query_pipeline
from radx_tpu_torch.ops.lazy import LazyTable

JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     rider_chunk_rows=8, compact_chunk_rows=8,
                     topk_chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
N = 2000


def _arrays(seed=0, n=N):
    rng = np.random.default_rng(seed)
    f = (rng.integers(-30, 30, n) / 4).astype(np.float32)
    f[:5] = [np.nan, -0.0, 0.0, np.inf, -np.inf]
    return {"k": rng.integers(0, 60, n).astype(np.uint32),
            "f": f,
            "v": rng.integers(0, 2**32, n, dtype=np.uint32)}


def _tables(seed=0, n=N):
    a = _arrays(seed, n)
    return radx_tpu.Table.from_arrays(**a), Table.from_arrays(device="cpu", **a)


def _same(jt, tt):
    want, got = jt.to_numpy(), tt.to_numpy()
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name].view(np.uint32),
                                      want[name].view(np.uint32), err_msg=name)


def test_sort_by_two_keys_matches_jax():
    jt, tt = _tables(1)
    _same(jt.sort_by(["k", "f"], descending=[False, True], cfg=JCFG),
          tt.sort_by(["k", "f"], descending=[False, True], cfg=CFG))


def test_filter_distinct_top_k_match_jax():
    jt, tt = _tables(2)
    mask = (_arrays(2)["v"] & 3) != 0
    _same(jt.filter(mask, cfg=JCFG), tt.filter(mask, cfg=CFG))
    _same(jt.distinct("k", cfg=JCFG), tt.distinct("k", cfg=CFG))
    _same(jt.top_k("f", 17, cfg=JCFG), tt.top_k("f", 17, cfg=CFG))


@pytest.mark.parametrize("agg,bins", [("sum", None), ("max", 128),
                                      ("count", 256)])
def test_groupby_matches_jax(agg, bins):
    jt, tt = _tables(3)
    _same(jt.groupby("k", "v", agg, bins=bins, cfg=JCFG),
          tt.groupby("k", "v", agg, bins=bins, cfg=CFG))


def _dims(seed):
    rng = np.random.default_rng(seed)
    a = {"k": rng.permutation(100)[:70].astype(np.uint32),
         "w": rng.integers(0, 2**32, 70, dtype=np.uint32)}
    return radx_tpu.Table.from_arrays(**a), Table.from_arrays(device="cpu", **a)


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_matches_jax(how):
    jt, tt = _tables(4)
    jd, td = _dims(4)
    _same(jt.join(jd, "k", "v", "w", how=how, missing=5, cfg=JCFG),
          tt.join(td, "k", "v", "w", how=how, missing=5, cfg=CFG))


def test_join_multi_match_and_truncation():
    """max_matches=2 with at most two build rows per key equals the JAX
    result; a third build row raises in both."""
    jt, tt = _tables(5, 800)
    rng = np.random.default_rng(5)
    dk = np.repeat(rng.permutation(60)[:40].astype(np.uint32), 2)
    dw = rng.integers(0, 2**32, 80, dtype=np.uint32)
    jd = radx_tpu.Table.from_arrays(k=dk, w=dw)
    td = Table.from_arrays(k=dk, w=dw, device="cpu")
    _same(jt.join(jd, "k", "v", "w", max_matches=2, cfg=JCFG),
          tt.join(td, "k", "v", "w", max_matches=2, cfg=CFG))
    td3 = Table.from_arrays(k=np.append(dk, dk[0]),
                            w=np.append(dw, np.uint32(1)),
                            device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        tt.join(td3, "k", "v", "w", max_matches=2, cfg=CFG)
    with pytest.raises(ValueError, match="left"):
        tt.join(td, "k", "v", "w", max_matches=2, how="left")


def test_table_surface():
    a = _arrays(6, 50)
    t = Table.from_arrays(device="cpu", **a)
    assert t.num_rows == 50 and t.device.type == "cpu"
    assert t.column("f").dtype == torch.float32
    for name, col in t.to_numpy().items():
        np.testing.assert_array_equal(col.view(np.uint32),
                                      a[name].view(np.uint32))
    lt = t.lazy()
    assert isinstance(lt, LazyTable) and int(lt.count) == 50
    with pytest.raises(ValueError):
        Table({})
    with pytest.raises(ValueError):
        Table({"a": torch.zeros(3, dtype=torch.int32),
               "b": torch.zeros(4, dtype=torch.int32)})
    with pytest.raises(TypeError):
        Table({"a": torch.zeros(3, dtype=torch.int64)})
    with pytest.raises(ValueError):
        t.sort_by(["k", "f"], descending=[True])


def test_query_pipeline_example_on_cpu():
    out = query_pipeline.run(20_000, 50, "cpu",
                             SortConfig(compact_elems=1024, scan_elems=1024))
    assert out["groups"] == 50 and 0 < out["kept"] < 20_000
