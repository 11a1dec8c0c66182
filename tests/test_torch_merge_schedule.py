"""When and how often the distributed sort merges a shard's arrivals
(``parallel/dist_sort.py``: ``_exchange_merge``, ``_Merger``), on the CPU
with the plain version of ``kernels/merge.merge_runs``; no JAX.

  * every merge of a phase comes after that phase's last wave, whatever
    ``overlap`` says (a recording transport and a spy on ``merge_runs``);
  * a shard of a group of g non-empty runs runs g - 1 merges (one for a
    group of one: the copy into the output row), counted by
    ``PLAIN_CALLS``;
  * ``overlap`` changes no output of any entry point;
  * the merger's stack lets a run go once it has been merged: it holds at
    most one merged run a level.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from radx_tpu_torch.config import SortConfig
from radx_tpu_torch.kernels import merge as tm
from radx_tpu_torch.parallel import Mesh
from radx_tpu_torch.parallel import dist_sort as td
from radx_tpu_torch.parallel.mesh import InProcess

CFG = SortConfig(chunk_elems=1024, finish_elems=1024, rider_chunk_elems=1024,
                 rider_finish_elems=1024, stable_chunk_elems=1024,
                 stable_finish_elems=1024)
SIGN = -(1 << 31)

torch.set_num_threads(1)


def mesh(n_dev):
    return Mesh([torch.device("cpu")] * n_dev)


def _keys(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


@pytest.mark.parametrize("exchange", ["flat", "hier"])
@pytest.mark.parametrize("overlap", [True, False])
def test_merges_come_after_the_last_wave(monkeypatch, exchange, overlap):
    """Eight shards: flat, 7 waves then 7 merges a shard; hier (4 x 2), 3
    waves then 3 merges a shard, 1 wave then 1 merge a shard."""
    events = []
    wave, merge_runs = InProcess.wave, tm.merge_runs

    def spy_wave(self, sends):
        events.append("wave")
        return wave(self, sends)

    def spy_merge(*args, **kwargs):
        events.append("merge")
        return merge_runs(*args, **kwargs)

    monkeypatch.setattr(InProcess, "wave", spy_wave)
    monkeypatch.setattr(tm, "merge_runs", spy_merge)
    keys = _keys(3, 8 * 512)
    out, valid, overflow = td.sort_sharded(keys, mesh(8), cfg=CFG,
                                           overlap=overlap, exchange=exchange)
    assert not overflow.any()
    np.testing.assert_array_equal(td.collect(out, valid), np.sort(keys))
    phases = [(7, 7)] if exchange == "flat" else [(3, 3), (1, 1)]
    want = []
    for waves, merges in phases:
        want += ["wave"] * waves + ["merge"] * (8 * merges)
    assert events == want


@pytest.mark.parametrize("n_dev", [1, 2, 3, 5, 8])
def test_merges_a_shard(n_dev):
    """g - 1 pairwise merges a shard of a group of g non-empty runs; a
    group of one copies its run into the output row (one call)."""
    keys = _keys(n_dev, n_dev * 512)
    tm.reset_counts()
    out, valid, _ = td.sort_sharded(keys, mesh(n_dev), cfg=CFG)
    np.testing.assert_array_equal(td.collect(out, valid), np.sort(keys))
    assert tm.PLAIN_CALLS["merge_runs_ref"] == n_dev * max(1, n_dev - 1)


@pytest.mark.parametrize("exchange", ["flat", "hier"])
def test_overlap_changes_no_output(exchange):
    """sort_pairs_sharded (stable) and argsort_sharded on 8 shards with
    few distinct keys: overlap on and off give the same rows, valid and
    flag, bit for bit, and the stable order numpy gives."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 50, 8 * 300 - 5, dtype=np.uint32)
    values = rng.integers(-(2**31), 2**31, keys.size, dtype=np.int64)
    values = values.astype(np.int32)
    got = [td.sort_pairs_sharded(keys, values, mesh(8), cfg=CFG, stable=True,
                                 overlap=o, exchange=exchange)
           for o in (True, False)]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    k, v, valid, ovf = got[0]
    order = np.argsort(keys, kind="stable")
    assert not ovf.any()
    np.testing.assert_array_equal(td.collect(k, valid), keys[order])
    np.testing.assert_array_equal(td.collect(v, valid), values[order])
    a_on, a_off = (td.argsort_sharded(keys, mesh(8), cfg=CFG, overlap=o)
                   for o in (True, False))
    for a, b in zip(a_on, a_off):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(td.collect(a_on[1], a_on[2]), order)


def test_merger_lets_merged_runs_go():
    """Eight runs pushed one at a time: once two runs of a level have been
    merged, neither is held any more; the result is the sorted union,
    written into ``out`` with the key XOR."""
    rng = np.random.default_rng(9)
    raw = [np.sort(rng.integers(-(2**31), 2**31, 40 + r).astype(np.int32))
           for r in range(8)]
    out = [torch.empty(sum(r.size for r in raw), dtype=torch.int32)]
    merger = td._Merger(8, 1, out, SIGN)
    runs = [[torch.from_numpy(r.copy())] for r in raw]
    refs = [weakref.ref(r[0]) for r in runs]
    runs.reverse()
    alive = []
    while runs:
        merger.push(runs.pop())
        gc.collect()
        pushed = refs[:len(refs) - len(runs)]
        alive.append(sum(r() is not None for r in pushed))
    # of the runs pushed so far, those not yet merged
    assert alive == [1, 0, 1, 0, 1, 0, 1, 0]
    want = np.sort(np.concatenate(raw)) ^ np.int32(SIGN)
    np.testing.assert_array_equal(out[0].numpy(), want)
