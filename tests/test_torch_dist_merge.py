"""The distributed sort's runs at their own length: ``kernels/merge.py``
(``merge_runs``, the merge of two ascending runs of any lengths) and
``parallel/dist_sort.py``'s exchange, which sends and merges each run at
min(count, slot) rows instead of whole sentinel-padded slots.

  * ``merge_runs``' plain version against a stable numpy sort of the
    concatenation (empty runs, lengths about a tile, all-equal keys, real
    0xFFFFFFFF keys, lex2 with one and two payloads, the key XOR), and its
    path splits against the same order;
  * every distributed entry point against ``radx_tpu.parallel.dist_sort``
    on the conftest's virtual CPU devices: whole padded rows, ``valid`` and
    the flag bit for bit, at D = 3, 6 and 8 (groups of no power of two
    too), flat and hier, with and without overlap, ragged and
    overflowing (constant keys at capacity 1: truncated runs and ``valid``
    past the real rows, in hier too, where phase 2 cuts past them);
  * a recording transport: each wave sends exactly min(count, slot) rows a
    plane, counted independently of the code under test, and no slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.parallel import dist_sort as jd
from radx_tpu.parallel import make_mesh as j_mesh
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.kernels import merge as tm
from radx_tpu_torch.parallel import Mesh
from radx_tpu_torch.parallel import dist_sort as td
from radx_tpu_torch.parallel.mesh import InProcess

JCFG = JaxSortConfig(chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SIGN = -(1 << 31)

torch.set_num_threads(1)


def mesh(n_dev):
    return Mesh([torch.device("cpu")] * n_dev)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# --- merge_runs' plain version -------------------------------------------


def _run(rng, n, planes, ncmp, keys):
    """One ascending run of ``planes`` int32 planes (numpy, (P, n))."""
    x = np.empty((planes, n), np.int32)
    x[0] = {"uniform": lambda: rng.integers(-(2**31), 2**31, n),
            "few": lambda: rng.integers(-3, 3, n),
            "equal": lambda: np.full(n, 12345),
            "ffffffff": lambda: np.where(rng.random(n) < 0.5, 0x7FFFFFFF,
                                         rng.integers(0, 2**31, n))}[keys]()
    for p in range(1, planes):
        x[p] = rng.integers(-(2**31), 2**31, n)
    order = np.lexsort(x[:ncmp][::-1]) if n else np.arange(0)
    return x[:, order]


def _want(a, b, ncmp, key_xor=0):
    """The stable sort of A's rows, then B's, by the compare planes."""
    x = np.concatenate([a, b], axis=1)
    order = np.lexsort(x[:ncmp][::-1])  # stable: A's first on a tie
    out = x[:, order].copy()
    out[0] ^= np.int32(key_xor)
    return out, order


MERGE_CASES = {
    "empty_a": (0, 5, 1, 1, "uniform"),
    "empty_b": (7, 0, 2, 3, "uniform"),
    "one_one": (1, 1, 1, 1, "uniform"),
    "one_two_tie": (1, 2, 1, 1, "equal"),
    "tile_minus_plus": (2047, 2049, 1, 1, "uniform"),
    "two_tiles_plus_minus": (4097, 4095, 2, 2, "few"),
    "all_equal": (3000, 1001, 1, 1, "equal"),
    "all_equal_lex2": (1500, 2600, 2, 2, "equal"),
    "ffffffff": (2500, 1700, 1, 1, "ffffffff"),
    "ffffffff_lex2": (1000, 1200, 2, 2, "ffffffff"),
    "lex2_one_payload": (3333, 2222, 2, 3, "few"),
    "lex2_two_payloads": (2049, 6000, 2, 4, "uniform"),
    "keys_rider": (777, 4444, 1, 2, "few"),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_runs_plain_against_numpy(case):
    na, nb, ncmp, planes, keys = MERGE_CASES[case]
    rng = np.random.default_rng(sorted(MERGE_CASES).index(case))
    a, b = _run(rng, na, planes, ncmp, keys), _run(rng, nb, planes, ncmp, keys)
    key_xor = SIGN if case.startswith("ffffffff") else 0
    want, order = _want(a, b, ncmp, key_xor)
    ta = [torch.from_numpy(p.copy()) for p in a]
    tb_ = [torch.from_numpy(p.copy()) for p in b]
    calls = tm.PLAIN_CALLS["merge_runs_ref"]
    got = tm.merge_runs(ta, tb_, ncmp, key_xor=key_xor)
    assert tm.PLAIN_CALLS["merge_runs_ref"] == calls + 1
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    # into the prefix of a longer output, the rest left alone
    out = torch.full((planes, na + nb + 9), 7, dtype=torch.int32)
    tm.merge_runs(ta, tb_, ncmp, out=[o[:na + nb] for o in out],
                  key_xor=key_xor)
    np.testing.assert_array_equal(out[:, :na + nb].numpy(), want)
    assert (out[:, na + nb:] == 7).all()
    # the path: A's rows among the first t * TILE output rows
    split = tm.merge_path(ta, tb_, ncmp)
    d = np.minimum(np.arange(split.numel()) * tm.TILE, na + nb)
    from_a = np.concatenate([[0], np.cumsum(order < na)])
    np.testing.assert_array_equal(split.numpy(), from_a[d])
    assert split.numel() == -(-(na + nb) // tm.TILE) + 1


def test_merge_runs_rejects_bad_planes():
    a = [torch.zeros(4, dtype=torch.int32)]
    with pytest.raises(ValueError):
        tm.merge_runs(a, [torch.zeros(4, dtype=torch.int64)])
    with pytest.raises(ValueError):
        tm.merge_runs(a, a, num_cmp=2)
    with pytest.raises(ValueError):
        tm.merge_runs(a * 5, a * 5)
    with pytest.raises(ValueError):
        tm.merge_runs(a, a, out=[torch.zeros(7, dtype=torch.int32)])
    with pytest.raises(ValueError):
        tm.merge_runs([torch.zeros(4, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32)], a * 2, num_cmp=2)


# --- the entry points against the JAX package ----------------------------


def _uniform(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _dups(seed, n, hi=64):
    return np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint32)


def _keys_call(port, jax_fn, n_dev, keys, **kw):
    want = jax_fn(jnp.asarray(keys), j_mesh(n_dev), cfg=JCFG, **kw)
    got = port(keys, mesh(n_dev), cfg=CFG, **kw)
    return got, want


@pytest.mark.parametrize("n_dev,n,overlap,exchange", [
    (3, 3000 - 11, False, "flat"),
    (6, 3072 + 5, True, "flat"),
    (8, 2048, False, "hier"),
])
def test_sort_sharded_rows_match_jax(n_dev, n, overlap, exchange):
    keys = _uniform(n_dev, n)
    got, want = _keys_call(td.sort_sharded, jd.sort_sharded, n_dev, keys,
                           overlap=overlap, exchange=exchange)
    _same(got, want)
    assert not got[2].any()
    np.testing.assert_array_equal(td.collect(got[0], got[1]), np.sort(keys))


@pytest.mark.parametrize("n_dev,exchange", [(3, "flat"), (4, "hier")])
def test_overflow_rows_match_jax(n_dev, exchange):
    """Constant keys at capacity 1: every run lands on one shard, runs are
    cut at their slot, and ``valid`` counts rows past the real ones; in
    hier, phase 2 cuts its runs past phase 1's real rows."""
    keys = np.full(n_dev * 512, 0xABCD1234, np.uint32)
    got, want = _keys_call(td.sort_sharded, jd.sort_sharded, n_dev, keys,
                           capacity=1, exchange=exchange)
    _same(got, want)
    assert got[2].all()
    rows, valid = got[0].numpy(), got[1].numpy()
    assert valid.sum() == keys.size and valid[-1] == keys.size
    assert (rows[-1] != 0xFFFFFFFF).sum() < valid[-1]  # past the real rows


@pytest.mark.parametrize("n_dev,stable", [(6, True), (3, False)])
def test_sort_pairs_rows_match_jax(n_dev, stable):
    keys = _dups(20 + stable, n_dev * 256 - 77)
    vals = np.random.default_rng(22).integers(0, 2**32, keys.size,
                                              dtype=np.uint32)
    want = jd.sort_pairs_sharded(jnp.asarray(keys), jnp.asarray(vals),
                                 j_mesh(n_dev), capacity=8, cfg=JCFG,
                                 stable=stable, overlap=stable)
    got = td.sort_pairs_sharded(keys, vals, mesh(n_dev), capacity=8, cfg=CFG,
                                stable=stable, overlap=stable)
    _same(got, want)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(td.collect(got[1], got[2]), vals[order])


def test_overflowing_pairs_rows_match_jax():
    """Payloads through truncated runs (three planes)."""
    keys = np.full(3 * 256, 7, np.uint32)
    keys[::97] = 0xFFFFFFFF
    vals = np.arange(keys.size, dtype=np.int32)
    want = jd.sort_pairs_sharded(jnp.asarray(keys), jnp.asarray(vals),
                                 j_mesh(3), capacity=1, cfg=JCFG)
    got = td.sort_pairs_sharded(keys, vals, mesh(3), capacity=1, cfg=CFG)
    _same(got, want)
    assert got[3].all()


def test_argsort_rows_match_jax():
    keys = _dups(23, 3 * 512 + 1, hi=300)
    want = jd.argsort_sharded(jnp.asarray(keys), j_mesh(3), capacity=8,
                              cfg=JCFG, overlap=False)
    got = td.argsort_sharded(keys, mesh(3), capacity=8, cfg=CFG,
                             overlap=False)
    _same(got, want)
    np.testing.assert_array_equal(td.collect(got[1], got[2]),
                                  np.argsort(keys, kind="stable"))


# --- numpy-only cases -----------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 5, 7])
@pytest.mark.parametrize("overlap", [True, False])
def test_any_group_size_against_numpy(n_dev, overlap):
    keys = _uniform(30 + n_dev, n_dev * 300 + 13)
    vals = np.arange(keys.size, dtype=np.uint32)
    k, v, valid, overflow = td.sort_pairs_sharded(
        keys, vals, mesh(n_dev), cfg=CFG, stable=True, overlap=overlap)
    assert not overflow.any()
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(td.collect(k, valid), keys[order])
    np.testing.assert_array_equal(td.collect(v, valid), vals[order])
    n_runs = 1 << (n_dev - 1).bit_length()
    assert k.shape[1] % n_runs == 0
    for d in range(n_dev):  # the pads
        assert (k[d, int(valid[d]):].view(torch.int32) == -1).all()
        assert (v[d, int(valid[d]):].view(torch.int32) == 0).all()


def test_no_network_merge(monkeypatch):
    """The arrivals go through merge_runs, never the network's run merge."""
    def refuse(*args, **kwargs):
        raise AssertionError("merge_sorted_runs called")

    monkeypatch.setattr(tb, "merge_sorted_runs", refuse)
    assert not hasattr(td, "_pack_slots") and not hasattr(td, "_merge_pair")
    before = tm.PLAIN_CALLS["merge_runs_ref"]
    keys = _uniform(40, 4096)
    out, valid, _ = td.sort_sharded(keys, mesh(4), cfg=CFG, exchange="hier")
    np.testing.assert_array_equal(td.collect(out, valid), np.sort(keys))
    assert tm.PLAIN_CALLS["merge_runs_ref"] > before


# --- what a wave moves ----------------------------------------------------


class Recording(InProcess):
    """The in-process transport, recording every wave's runs: ``sent``
    (source, destination) -> the rows of each plane sent; ``received``
    (source, destination) -> (the rows of each plane received, the rows
    the receiver was told to expect)."""

    def __init__(self, devices):
        super().__init__(devices)
        self.sent, self.received = {}, {}

    def wave(self, sends):
        got = super().wave(sends)
        for i, (dst, src, planes, rows), r in zip(self.local, sends, got):
            assert (i, dst) not in self.sent
            self.sent[i, dst] = [p.numel() for p in planes]
            self.received[src, i] = ([p.numel() for p in r], rows)
        return got


class RecordingMesh(Mesh):
    def transport(self):
        self.tr = Recording(self.devices)
        return self.tr


def _expected_rows(keys, n_dev, rows, valid, slot):
    """min(count, slot) for each (source, destination), counted from the
    output alone: a source's keys that fall in the destination's range of
    distinct keys (the first and last key of its valid prefix)."""
    m = -(-keys.size // n_dev)
    want = {}
    for d in range(n_dev):
        v = int(valid[d])
        if not v:
            continue
        lo, hi = rows[d, 0], rows[d, v - 1]
        for i in range(n_dev):
            shard = keys[i * m: (i + 1) * m]
            want[i, d] = min(int(((shard >= lo) & (shard <= hi)).sum()), slot)
    return want


@pytest.mark.parametrize("n_dev,pairs", [(4, False), (6, True)])
def test_each_wave_moves_its_run_at_its_own_length(n_dev, pairs):
    """Distinct keys: each wave sends exactly min(count, slot) rows a plane
    (the count taken from the output rows), the receiver is told that
    many, and no wave sends a slot."""
    n = n_dev * 1000 - 3
    keys = np.random.default_rng(50).permutation(1 << 20)[:n].astype(
        np.uint32)
    m = RecordingMesh([torch.device("cpu")] * n_dev)
    if pairs:
        out, _, valid, overflow = td.sort_pairs_sharded(
            keys, np.arange(n, dtype=np.int32), m, cfg=CFG)
    else:
        out, valid, overflow = td.sort_sharded(keys, m, cfg=CFG)
    assert not overflow.any()
    slot = td._pow2_pad(4 * -(-n // n_dev**2), min_total=td.MIN_SLOT)
    want = _expected_rows(keys, n_dev, out.numpy(), valid.numpy(), slot)
    assert len(m.tr.sent) == len(m.tr.received) == n_dev * (n_dev - 1)
    for (src, dst), sent in m.tr.sent.items():
        w = want.get((src, dst), 0)
        assert sent == [w] * (3 if pairs else 1) and w < slot
        assert m.tr.received[src, dst] == (sent, w)
    # every key left its shard or stayed there, once
    assert sum(s[0] for s in m.tr.sent.values()) + sum(
        want.get((i, i), 0) for i in range(n_dev)) == n


def test_overflowing_waves_send_the_slot_prefix():
    """Constant keys at capacity 1: each source's whole shard is bound for
    the last shard and sends its first ``slot`` rows."""
    n_dev, m_rows = 3, 512
    keys = np.full(n_dev * m_rows, 5, np.uint32)
    m = RecordingMesh([torch.device("cpu")] * n_dev)
    out, valid, overflow = td.sort_sharded(keys, m, capacity=1, cfg=CFG)
    slot = td._pow2_pad(-(-keys.size // n_dev**2), min_total=td.MIN_SLOT)
    assert overflow.all() and slot < m_rows
    for (src, dst), sent in m.tr.sent.items():
        w = slot if dst == n_dev - 1 else 0
        assert sent == [w] and m.tr.received[src, dst] == (sent, w)
    assert int(valid[-1]) == keys.size
    assert (out[-1, : n_dev * slot].view(torch.int32) == 5).all()
    assert (out[-1, n_dev * slot:].view(torch.int32) == -1).all()


def test_dist_memory_tool_on_the_cpu(monkeypatch):
    """The step-1 tool: its 90%-equal keys, and no run without a card."""
    from radx_tpu_torch.tools import dist_memory

    k = dist_memory.keys_of("equal90", 1 << 16, torch.device("cpu"))
    share = float((k.view(torch.int32) == 0x9E3779B9 - (1 << 32)).double()
                  .mean())
    assert k.dtype == torch.uint32 and 0.89 < share < 0.91
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dist_memory.main([]) == 2
