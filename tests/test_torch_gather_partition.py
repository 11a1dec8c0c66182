"""The partitioned route of ``gather_planes`` (radx_tpu_torch/kernels/
gather.py, csrc/gather.cu) on the CPU: ``gather_planes_model``, the route's
position arithmetic in PyTorch (bucket counts, their prefixes, stable
in-tile ranks, P, V, place), held bit for bit against ``gather_planes_ref``
at tiny windows and tiles (many buckets, ragged tiles), and against the JAX
package, which sorts the value planes through its network, by running
``sort_pairs`` / ``sort_multi`` / ``join_merge`` with the model in place of
the gather (one JAX call a case, Pallas in interpret mode).  Tolerance 0:
a gather moves bits.  tests/test_torch_gpu.py holds the CUDA kernels
against the same plain steps on a card."""

import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import join as jj
from radx_tpu.ops import sort as js
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import gather as tg
from radx_tpu_torch.ops import join as tj
from radx_tpu_torch.ops import sort as ts

torch.set_num_threads(1)

JCFG = JaxSortConfig(chunk_rows=8, stable_chunk_rows=8, stable2_chunk_rows=8,
                     rider_chunk_rows=8, compact_chunk_rows=8,
                     interpret=True)
CFG = config_from_jax(JCFG)
W, T = 64, 256  # window rows, tile rows: many buckets, many tiles
N_ODD = 4099  # no multiple of T


def _i32(rng, n):
    return rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def _index(case, n, rng):
    """Index planes of the cases the route must survive."""
    return {
        "permutation": rng.permutation(n),
        "identity": np.arange(n),  # one bucket a tile
        "reversal": np.arange(n)[::-1],
        "one_index": np.full(n, n // 3),  # one bucket holds every row
        "duplicates": rng.integers(0, n, n),
        "out_of_range": np.where(rng.random(n) < 0.3,
                                 rng.choice([-1, -(2**31), n, 2**31 - 1], n),
                                 rng.integers(0, n, n)),
    }[case]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape
        assert torch.equal(g, w)


CASES = ["permutation", "identity", "reversal", "one_index", "duplicates",
         "out_of_range"]


@pytest.mark.parametrize("sources", [1, 2, 3, 4])
@pytest.mark.parametrize("case", CASES)
def test_model_index_mode_matches_ref(case, sources):
    """1..4 sources of unequal lengths (an index past a shorter source
    gives 0 there) over n = 4099 rows: 17 tiles, the last ragged."""
    rng = np.random.default_rng(CASES.index(case) * 10 + sources)
    idx = _t(_index(case, N_ODD, rng))
    srcs = [_t(_i32(rng, N_ODD - 37 * g)) for g in range(sources)]
    tg.reset_counts()
    got = tg.gather_planes_model(idx, srcs, "index", W, T)
    _assert_equal(got, tg.gather_planes_ref(idx, srcs, "index"))
    assert tg.PLAIN_CALLS["window_ref"] == sources
    assert tg.PLAIN_CALLS["place_ref"] == sources
    assert not any(tg.LAUNCHES.values())


@pytest.mark.parametrize("n", [1, 255, 256, 257, N_ODD])
@pytest.mark.parametrize("window_rows,tile", [(8, 256), (64, 1024),
                                              (1 << 13, 256),
                                              (1 << 20, 1 << 13)])
def test_model_geometries(n, window_rows, tile):
    """Windows from 8 rows (513 buckets at 4099 rows) to one holding the
    whole source, tiles from 256 rows to one larger than n."""
    rng = np.random.default_rng(n + tile)
    idx = _t(rng.integers(-5, n + 5, n))
    srcs = [_t(_i32(rng, n)), _t(_i32(rng, n))]
    _assert_equal(tg.gather_planes_model(idx, srcs, "index", window_rows,
                                         tile),
                  tg.gather_planes_ref(idx, srcs, "index"))


def _ties(rng, n, nb, np_, pads):
    """A shuffled tie plane: build ties, probe ties (2^30 + i), pads, and a
    few ties past either side or negative (they give 0, 0)."""
    kind = rng.integers(0, 3 if pads else 2, n)
    tie = np.where(kind == 0, rng.integers(0, nb, n),
                   np.where(kind == 1, tg.PROBE_TIE + rng.integers(0, np_, n),
                            tg.PAD_TIE))
    tie[:5] = [nb, tg.PROBE_TIE + np_, -3, tg.PROBE_TIE - 1, tg.PAD_TIE - 1]
    return tie


@pytest.mark.parametrize("pads", [False, True])
@pytest.mark.parametrize("window_rows,tile", [(W, T), (16, 512),
                                              (1 << 12, 256)])
def test_model_tagged_mode_matches_ref(pads, window_rows, tile):
    """Build windows then probe windows, the null bucket for the pad tie
    and out-of-range ties; (build, 0) / (0, probe) / (0, 0) out."""
    rng = np.random.default_rng(7 + pads + tile)
    nb, np_ = 1500, 2200
    tie = _t(_ties(rng, N_ODD, nb, np_, pads))
    srcs = [_t(_i32(rng, nb)), _t(_i32(rng, np_))]
    tg.reset_counts()
    got = tg.gather_planes_model(tie, srcs, "tagged", window_rows, tile)
    _assert_equal(got, tg.gather_planes_ref(tie, srcs, "tagged"))
    assert tg.PLAIN_CALLS["window_ref"] == tg.PLAIN_CALLS["place_ref"] == 1


def test_partition_is_a_stable_partition_by_window():
    """P is the index stably sorted by bucket; the table holds each
    bucket's prefix over the tiles and the totals its rows."""
    rng = np.random.default_rng(3)
    idx = _t(_index("out_of_range", N_ODD, rng))
    geo = tg.geometry(idx, [idx], "index", W, T)
    assert (geo.nbw, geo.nb, geo.tiles) == (-(-N_ODD // W), -(-N_ODD // W),
                                            -(-N_ODD // T))
    counts = tg.count_ref(idx, geo)
    assert counts.shape == (geo.nb + 1, geo.tiles)
    offsets, totals = tg.scan_ref(counts, geo)
    d = tg._buckets(idx, geo)
    assert torch.equal(totals, torch.bincount(d, minlength=geo.nb + 1))
    assert torch.equal(offsets[:, 0], torch.zeros(geo.nb + 1,
                                                  dtype=torch.int64))
    assert torch.equal(offsets[:, 1:] - offsets[:, :-1], counts[:, :-1])
    p = tg.part_ref(idx, geo, offsets, totals)
    assert torch.equal(p, idx[torch.sort(d, stable=True).indices])
    # null rows (outside the source) come last and read nothing
    inside = (idx >= 0) & (idx < N_ODD)
    assert int(totals[-1]) == int((~inside).sum())
    v = tg.window_ref(p, [idx], geo, torch.empty_like(p))
    assert not v[-int(totals[-1]):].any()


def test_cpu_route_runs_the_plain_steps():
    """``partitioned`` on CPU tensors composes the plain steps (no launch)
    and equals the model: one window and one place a value plane, each
    source's V in the next source's output, the last one's over P."""
    rng = np.random.default_rng(4)
    idx = _t(rng.permutation(N_ODD))
    srcs = [_t(_i32(rng, N_ODD)) for _ in range(3)]
    tg.reset_counts()
    got = tg.partitioned(idx, srcs, "index", W, T)
    assert {k: v for k, v in tg.PLAIN_CALLS.items() if v} == {
        "count_ref": 1, "scan_ref": 1, "part_ref": 1, "window_ref": 3,
        "place_ref": 3}
    assert not any(tg.LAUNCHES.values())
    _assert_equal(got, tg.gather_planes_model(idx, srcs, "index", W, T))
    assert tg.partitioned(idx[:0], srcs, "index")[0].numel() == 0


def test_geometry_validates():
    x = torch.zeros(1000, dtype=torch.int32)
    for bad in (dict(window_rows=3), dict(window_rows=0), dict(tile=128),
                dict(tile=1 << 14), dict(tile=300)):
        kw = {"window_rows": W, "tile": T, **bad}
        with pytest.raises(ValueError):
            tg.geometry(x, [x], "index", **kw)
    big = torch.empty(tg.MAX_WINDOWS * 4 + 1, dtype=torch.int32,
                      device="meta")
    with pytest.raises(ValueError, match="windows"):
        tg.geometry(x, [big], "index", 4, T)
    geo = tg.geometry(x, [big, x], "tagged", 8, T)
    assert (geo.nbw, geo.nb) == (tg.MAX_WINDOWS // 2 + 1,
                                 tg.MAX_WINDOWS // 2 + 1 + 125)


def test_route_by_size_alone():
    """Direct while the sources hold at most one window of bytes (summed
    over the sources), partitioned above; the CPU keeps the plain
    version whatever the size."""
    rows = tg.WINDOW_BYTES // 4

    def meta(n):
        return torch.empty(n, dtype=torch.int32, device="meta")

    assert not tg.takes_partitioned([meta(rows)])
    assert tg.takes_partitioned([meta(rows + 1)])
    assert not tg.takes_partitioned([meta(rows // 2), meta(rows // 2)])
    assert tg.takes_partitioned([meta(rows // 2), meta(rows // 2 + 1)])
    assert tg.takes_partitioned([meta(rows // 4)] * 4 + [meta(1)])
    x = torch.arange(8, dtype=torch.int32)
    tg.reset_counts()
    tg.gather_planes(x, [torch.zeros(rows + 1, dtype=torch.int32)])
    assert tg.PLAIN_CALLS["gather_planes_ref"] == 1
    assert tg.PLAIN_CALLS["count_ref"] == 0
    # each route's entry point on CPU tensors: its plain version
    srcs = [torch.arange(100, dtype=torch.int32)]
    want = tg.gather_planes_ref(x, srcs)
    tg.reset_counts()
    _assert_equal(tg.direct(x, srcs), want)
    _assert_equal(tg.partitioned(x, srcs, "index", W, T), want)
    assert tg.PLAIN_CALLS["gather_planes_ref"] == 1
    assert tg.PLAIN_CALLS["place_ref"] == 1
    assert not any(tg.LAUNCHES.values())


# --- through the call sites, against radx_tpu ----------------------------------


@pytest.fixture
def model_gather(monkeypatch):
    """The call sites' gather replaced by the model at W, T."""
    calls = []

    def through_model(index, sources, mode="index"):
        calls.append(mode)
        return tg.gather_planes_model(index, list(sources), mode, W, T)

    monkeypatch.setattr(tg, "gather_planes", through_model)
    return calls


def _bits(x):
    return np.asarray(x).view(np.uint32)


def test_sort_pairs_through_the_model_matches_jax(model_gather):
    """The payload gathered by the sorted index plane (3000 keys padded to
    4096, duplicates and real 0xFFFFFFFF keys): 47 windows, 12 tiles."""
    rng = np.random.default_rng(60)
    n = 3000
    k = rng.integers(0, 40, n, dtype=np.uint32)
    k[:7] = 0xFFFFFFFF
    p = rng.standard_normal(n).astype(np.float32)
    jk, jp = js.sort_pairs(k, p, JCFG)
    gk, gp = ts.sort_pairs(k, p, CFG, device="cpu")
    assert model_gather == ["index"]
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(_bits(gp.numpy()), _bits(jp))


def test_sort_multi_through_the_model_matches_jax(model_gather):
    """Three payloads of three dtypes in one partitioned gather."""
    rng = np.random.default_rng(61)
    n = 2500
    k = rng.integers(0, 60, n, dtype=np.uint32)
    pays = [rng.integers(0, 2**32, n, dtype=np.uint32),
            rng.standard_normal(n).astype(np.float32),
            rng.integers(-9, 9, n).astype(np.int32)]
    jk, jps = js.sort_multi(k, pays, JCFG)
    gk, gps = ts.sort_multi(k, pays, CFG, device="cpu")
    assert model_gather == ["index"]
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    for g, w in zip(gps, jps):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_join_merge_through_the_model_matches_jax(model_gather):
    """The union's build and probe value planes gathered by the sorted tie
    (tagged mode; the union's pads hold the pad tie)."""
    rng = np.random.default_rng(62)
    nb, np_ = 1300, 1700
    bk = rng.permutation(4000)[:nb].astype(np.uint32)
    pk = rng.integers(0, 4000, np_).astype(np.uint32)
    pk[:3] = 0xFFFFFFFF
    bv = rng.integers(0, 2**32, nb, dtype=np.uint32)
    pv = rng.integers(0, 2**32, np_, dtype=np.uint32)
    wk, wb, wp, wc = jj.join_merge(bk, bv, pk, pv, JCFG)
    gk, gb, gp, gc = tj.join_merge(bk, bv, pk, pv, CFG, device="cpu")
    assert model_gather == ["tagged"]
    c = int(wc)
    assert int(gc) == c
    for g, w in ((gk, wk), (gb, wb), (gp, wp)):
        np.testing.assert_array_equal(_bits(g[:c].numpy()),
                                      _bits(np.asarray(w)[:c]))
