"""The port's distributed sort (radx_tpu_torch/parallel/dist_sort.py) on an
in-process mesh of CPU shards against the JAX package's
(radx_tpu/parallel/dist_sort.py) on the conftest's virtual CPU devices.

Per-shard rows, valid counts and overflow flags must match bit for bit, and
``_auto`` must settle on the same capacity.  The numpy-only cases run the
meshes that would cost the JAX side most (D = 6 and 8, hier at 8), slots of
the 128- and 256-key floor, the size ceiling and ``collect``; the port's
``merge_sorted_chunks`` is held against the JAX one.  On the CPU the port's
kernel wrappers run their plain PyTorch versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.kernels import bitonic as jb
from radx_tpu.parallel import dist_sort as jd
from radx_tpu.parallel import make_mesh as j_mesh
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.kernels import bitonic as tb
from radx_tpu_torch.parallel import Mesh, dryrun_multichip
from radx_tpu_torch.parallel import dist_sort as td

JCFG = JaxSortConfig(chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
N = 4096

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


def _uniform(seed, n=N):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


@pytest.mark.parametrize("overlap", [True, False])
def test_flat_matches_jax(overlap):
    keys = _uniform(1)
    want = jd.sort_sharded(jnp.asarray(keys), j_mesh(4), cfg=JCFG,
                           overlap=overlap)
    got = td.sort_sharded(keys, mesh(4), cfg=CFG, overlap=overlap)
    _same(got, want)
    assert not got[2].any()
    np.testing.assert_array_equal(td.collect(got[0], got[1]), np.sort(keys))


def test_hier_matches_jax():
    keys = _uniform(2)
    want = jd.sort_sharded(jnp.asarray(keys), j_mesh(4), cfg=JCFG,
                           exchange="hier")
    got = td.sort_sharded(keys, mesh(4), cfg=CFG, exchange="hier")
    _same(got, want)
    np.testing.assert_array_equal(td.collect(got[0], got[1]), np.sort(keys))


def test_ragged_three_shards_matches_jax():
    keys = _uniform(3, N - 777)
    want = jd.sort_sharded(jnp.asarray(keys), j_mesh(3), cfg=JCFG)
    got = td.sort_sharded(keys, mesh(3), cfg=CFG)
    _same(got, want)
    assert int(got[1].sum()) == keys.size


def test_stable_pairs_with_duplicates_matches_jax():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 16, 2048, dtype=np.uint32)
    vals = np.arange(2048, dtype=np.uint32)
    want = jd.sort_pairs_sharded(jnp.asarray(keys), jnp.asarray(vals),
                                 j_mesh(2), capacity=8, cfg=JCFG, stable=True)
    got = td.sort_pairs_sharded(keys, vals, mesh(2), capacity=8, cfg=CFG,
                                stable=True)
    _same(got, want)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(td.collect(got[1], got[2]), vals[order])


def test_argsort_matches_jax():
    keys = np.random.default_rng(5).integers(0, 256, N, dtype=np.uint32)
    want = jd.argsort_sharded(jnp.asarray(keys), j_mesh(4), capacity=8,
                              cfg=JCFG)
    got = td.argsort_sharded(keys, mesh(4), capacity=8, cfg=CFG)
    _same(got, want)
    np.testing.assert_array_equal(td.collect(got[1], got[2]),
                                  np.argsort(keys, kind="stable"))


def test_sentinel_keys_keep_payloads_matches_jax():
    """Real keys 0xFFFFFFFF tie with the pads (ragged n too): the pads must
    lose every tiebreak, or a pad's payload takes a real one's place."""
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 1000, N - 123, dtype=np.uint32)
    keys[::5] = 0xFFFFFFFF
    vals = rng.standard_normal(keys.size).astype(np.float32)
    want = jd.sort_pairs_sharded(jnp.asarray(keys), jnp.asarray(vals),
                                 j_mesh(4), cfg=JCFG)
    got = td.sort_pairs_sharded(keys, vals, mesh(4), cfg=CFG)
    _same(got, want)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(td.collect(got[1], got[2]), vals[order])


def test_constant_keys_overflow_matches_jax():
    keys = np.full(2048, 0xABCD1234, np.uint32)
    want = jd.sort_sharded(jnp.asarray(keys), j_mesh(4), capacity=1, cfg=JCFG)
    got = td.sort_sharded(keys, mesh(4), capacity=1, cfg=CFG)
    _same(got, want)
    assert got[2].all()
    out, valid, overflow = td.sort_sharded(keys, mesh(4), capacity=8, cfg=CFG)
    assert not overflow.any()
    np.testing.assert_array_equal(td.collect(out, valid), keys)


def test_auto_capacity_matches_jax():
    """Presorted keys: every source shard lands on one destination, so the
    capacity must escalate past 2."""
    keys = np.sort(_uniform(7))
    want = jd.sort_sharded_auto(jnp.asarray(keys), j_mesh(4), cfg=JCFG)
    got = td.sort_sharded_auto(keys, mesh(4), cfg=CFG)
    assert got[2] == want[2] > 2
    _same(got[:2], want[:2])


def test_merge_sorted_chunks_matches_jax():
    rng = np.random.default_rng(8)
    runs = np.sort(rng.integers(-(2**31), 2**31, (4, 1024)).astype(np.int32),
                   axis=1)
    runs[1::2] = runs[1::2, ::-1]
    x = runs.reshape(-1).copy()
    want = jb.merge_sorted_chunks([jnp.asarray(x.reshape(-1, 128))], 8, 1,
                                  interpret=True)
    got = torch.from_numpy(x.copy())
    tb.merge_sorted_chunks(got, 1024, CFG.finish_elems)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[0]).reshape(-1))
    np.testing.assert_array_equal(got.numpy(), np.sort(x))


# --- numpy-only cases ----------------------------------------------------


@pytest.mark.parametrize("n_dev", [6, 8])
def test_flat_ragged_against_numpy(n_dev):
    keys = _uniform(9, (1 << 14) - 777)
    out, valid, overflow = td.sort_sharded(keys, mesh(n_dev), cfg=CFG)
    assert not overflow.any() and int(valid.sum()) == keys.size
    assert out.shape[0] == n_dev and out.dtype == torch.uint32
    np.testing.assert_array_equal(td.collect(out, valid), np.sort(keys))


@pytest.mark.parametrize("overlap", [True, False])
def test_hier_eight_against_numpy(overlap):
    rng = np.random.default_rng(10)
    keys = rng.integers(0, 64, 1 << 14, dtype=np.uint32)
    vals = np.arange(keys.size, dtype=np.uint32)
    k, v, valid, overflow = td.sort_pairs_sharded(
        keys, vals, mesh(8), capacity=8, cfg=CFG, stable=True,
        overlap=overlap, exchange="hier")
    assert not overflow.any()
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(td.collect(k, valid), keys[order])
    np.testing.assert_array_equal(td.collect(v, valid), vals[order])


def test_hier_non_pow2_runs_flat():
    keys = _uniform(11, 6 * 1024)
    hier = td.sort_sharded(keys, mesh(6), cfg=CFG, exchange="hier")
    flat = td.sort_sharded(keys, mesh(6), cfg=CFG)
    for h, f in zip(hier, flat):
        assert torch.equal(h, f)


@pytest.mark.parametrize("n_dev,n,slot", [(8, 2048, 128), (4, 1024, 256)])
def test_small_slots(n_dev, n, slot):
    """Slots at the 128-key floor and at 256: merges of runs below every
    tile of the network."""
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    for overlap in (True, False):
        k, v, valid, overflow = td.sort_pairs_sharded(
            keys, vals, mesh(n_dev), cfg=CFG, overlap=overlap)
        n_runs = 1 << (n_dev - 1).bit_length()
        assert k.shape == (n_dev, n_runs * slot)
        assert not overflow.any()
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(td.collect(k, valid), keys[order])
        np.testing.assert_array_equal(td.collect(v, valid), vals[order])


def test_all_sentinel_keys_with_payloads():
    keys = np.full(3000, 0xFFFFFFFF, np.uint32)
    vals = np.arange(3000, dtype=np.int32)
    k, v, valid, overflow = td.sort_pairs_sharded(keys, vals, mesh(8),
                                                  capacity=16, cfg=CFG)
    assert not overflow.any() and int(valid.sum()) == 3000
    np.testing.assert_array_equal(td.collect(k, valid), keys)
    np.testing.assert_array_equal(td.collect(v, valid), vals)


def test_inputs_are_not_written():
    keys = torch.from_numpy(_uniform(13))
    vals = torch.arange(N, dtype=torch.int32)
    k0, v0 = keys.clone(), vals.clone()
    td.sort_pairs_sharded(keys, vals, mesh(4), cfg=CFG)
    td.sort_sharded(keys, mesh(4), cfg=CFG, overlap=False)
    assert torch.equal(keys.view(torch.int32), k0.view(torch.int32))
    assert torch.equal(vals, v0)


def test_collect_takes_tensors_and_numpy():
    rows = np.array([[1, 2, 9], [3, 4, 5]], np.uint32)
    valid = np.array([2, 3], np.int32)
    want = np.array([1, 2, 3, 4, 5], np.uint32)
    np.testing.assert_array_equal(td.collect(rows, valid), want)
    np.testing.assert_array_equal(
        td.collect(torch.from_numpy(rows), torch.from_numpy(valid)), want)


def test_size_ceiling():
    """D * ceil(n / D) keys must stay within MAX_KEYS = 2^31 - 1 (the
    int32 index plane of a stable sort); the check runs before any
    allocation."""
    assert td._shard_len(td.MAX_KEYS, 1) == td.MAX_KEYS
    assert td._shard_len((1 << 31) - 2, 3) == ((1 << 31) - 2) // 3
    for n, n_dev in (((1 << 31), 1), (td.MAX_KEYS, 2), (0, 4)):
        with pytest.raises(ValueError):
            td._shard_len(n, n_dev)


def test_rejects_bad_input():
    with pytest.raises(TypeError):
        td.sort_sharded(np.arange(1024, dtype=np.int32), mesh(2), cfg=CFG)
    keys = _uniform(14, 1024)
    with pytest.raises(TypeError):
        td.sort_pairs_sharded(keys, np.zeros(1024, np.int64), mesh(2), cfg=CFG)
    with pytest.raises(ValueError):
        td.sort_sharded(keys, mesh(2), axis="x", cfg=CFG)
    with pytest.raises(ValueError):
        td.sort_sharded(keys, mesh(2), cfg=CFG, exchange="ring")
    with pytest.raises(ValueError):
        td.sort_sharded(keys[:0], mesh(2), cfg=CFG)


def test_make_mesh_raises_beyond_device_count():
    from radx_tpu_torch.parallel import make_mesh

    have = torch.cuda.device_count()
    with pytest.raises(ValueError):
        make_mesh(have + 1)
    m = Mesh([torch.device("cpu")] * 3, axis="x")
    assert m.size == 3 and m.axis == "x"
    with pytest.raises(ValueError):
        Mesh([])


@pytest.mark.parametrize("n_dev", [4, 6])
def test_dryrun_multichip_on_cpu_shards(n_dev):
    """Flat, hier (D = 4) and stable pairs on one mesh of CPU shards."""
    dryrun_multichip(n_dev, "cpu", per_device=1 << 12)
