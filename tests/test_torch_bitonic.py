"""The port's bitonic module (radx_tpu_torch/kernels/bitonic.py) against the
JAX package's (radx_tpu/kernels/bitonic.py), bit for bit (tolerance 0: the
data is integer keys).

On the CPU every port kernel wrapper runs its plain PyTorch version, so these
tests hold the network the CUDA kernels compute (the card-side comparison of
kernel and plain version is tests/test_torch_gpu.py and chip_smoke.py).  JAX
runs its Pallas kernels in interpret mode; ``config_from_jax`` cuts the
port's network into the same chunks.  Inputs come from a numpy seed and pass
between the packages as numpy arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.kernels import bitonic as jb
from radx_tpu_torch.config import SortConfig, config_from_jax
from radx_tpu_torch.kernels import _build
from radx_tpu_torch.kernels import bitonic as tb

JCFG = JaxSortConfig(chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)  # chunk 1024, finish 16384: the JAX cut
SMALL = SortConfig(chunk_elems=16, finish_elems=64)  # many fused cross passes
PORT_CFGS = pytest.mark.parametrize("cfg", [CFG, SMALL], ids=["jaxcut", "small"])


def _keys(rng, n):
    """int32 keys: uniform, a duplicate-heavy band and both extremes."""
    x = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    x[: n // 4] = rng.integers(0, 16, n // 4)
    extremes = np.array([-(2**31), 2**31 - 1] * 4, dtype=np.int32)
    x[n // 4: n // 4 + 8] = extremes[: len(x[n // 4: n // 4 + 8])]
    return rng.permutation(x)


def _jax(x):
    return [jnp.asarray(x.reshape(-1, 128))]


def _np(planes):
    return np.asarray(planes[0]).reshape(-1)


def _port(fn, x, *args, **kw):
    t = torch.from_numpy(x.copy())
    out = fn(t, *args, **kw)
    assert out is t  # in place
    return t.numpy()


def test_config_from_jax():
    assert (CFG.chunk_elems, CFG.finish_elems) == (1024, 16 * 1024)
    big = config_from_jax(JaxSortConfig(chunk_rows=2048))
    assert (big.chunk_elems, big.finish_elems) == (2048 * 128, 8 * 2048 * 128)
    assert config_from_jax(JaxSortConfig(strategy="lax")).strategy == "lax"
    radix = config_from_jax(JaxSortConfig(strategy="radix"))
    assert radix.strategy == "radix"
    assert radix == dataclasses.replace(config_from_jax(JaxSortConfig()),
                                        strategy="radix")


def test_sort_chunks_ascending_matches_jax():
    rng = np.random.default_rng(11)
    x = _keys(rng, 4096)
    want = _np(jb.sort_chunks_ascending(_jax(x), 8, 1, interpret=True))
    got = _port(tb.sort_chunks_ascending, x, CFG.chunk_elems)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x.reshape(4, -1), 1).reshape(-1))


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
def test_sort_planes_matches_jax(descending):
    rng = np.random.default_rng(12)
    x = _keys(rng, 8192)
    want = _np(jb.sort_planes(_jax(x), 8, 1, interpret=True,
                              descending=descending))
    for cfg in (CFG, SMALL, SortConfig()):
        got = _port(tb.sort_planes, x, cfg.chunk_elems, cfg.finish_elems,
                    descending=descending)
        np.testing.assert_array_equal(got, want, err_msg=str(cfg))


def _alternating_runs(rng, log_run, n_runs):
    runs = _keys(rng, n_runs << log_run).reshape(n_runs, -1)
    runs = np.sort(runs, axis=1)
    runs[1::2] = runs[1::2, ::-1]
    return runs.reshape(-1).copy()


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
def test_merge_sorted_runs_matches_jax(descending):
    rng = np.random.default_rng(13)
    log_run = 10
    x = _alternating_runs(rng, log_run, 8)
    want = _np(jb.merge_sorted_runs(_jax(x), log_run, 1, 8,
                                    descending=descending, interpret=True))
    for cfg in (CFG, SMALL):
        got = _port(tb.merge_sorted_runs, x, log_run, cfg.chunk_elems,
                    cfg.finish_elems, descending=descending)
        np.testing.assert_array_equal(got, want, err_msg=str(cfg))


def test_merge_valley_ascending_matches_jax():
    rng = np.random.default_rng(14)
    n = 24 * 128
    desc = np.sort(_keys(rng, n // 2))[::-1]
    asc = np.sort(_keys(rng, n - n // 2))
    valley = np.concatenate([desc, asc])
    want = _np(jb.merge_valley_ascending(_jax(valley), 8, 1, interpret=True))
    for cfg in (CFG, SMALL):
        got = _port(tb.merge_valley_ascending, valley, cfg.chunk_elems,
                    cfg.finish_elems)
        np.testing.assert_array_equal(got, want, err_msg=str(cfg))


@PORT_CFGS
@pytest.mark.parametrize("n", [1, 2, 3, 1000, 3 * 1024 + 17, 5000])
def test_merge_valley_descending_any_length(cfg, n):
    """A mountain (ascending ++ descending) of any length merges to one
    descending run: the virtual wires hold -inf."""
    rng = np.random.default_rng(n)
    x = _keys(rng, n)
    k = n // 3
    mountain = np.concatenate([np.sort(x[:k]), np.sort(x[k:])[::-1]])
    got = _port(tb.merge_valley_ascending, mountain, cfg.chunk_elems,
                cfg.finish_elems, descending=True)
    np.testing.assert_array_equal(got, np.sort(x)[::-1])


@pytest.mark.parametrize("f", tb.CROSS_FUSION)
@pytest.mark.parametrize("invert", [False, True])
def test_cross_fused_equals_sequential(f, invert):
    """One cross pass fusing f distances == f single-distance passes."""
    rng = np.random.default_rng(20 + f)
    x = _keys(rng, 1 << 12)
    j_low = min(3, 11 - f)
    kk = j_low + f + 1  # directions alternate between merge groups
    fused = _port(tb.cross_stage, x, j_low, f, kk, invert)
    seq = torch.from_numpy(x.copy())
    for dj in range(j_low + f - 1, j_low - 1, -1):
        tb.cross_stage(seq, dj, 1, kk, invert)
    np.testing.assert_array_equal(fused, seq.numpy())
    assert not np.array_equal(fused, x)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("ascending", [False, True])
def test_chunk_sort_directions(invert, ascending):
    """Chunk g ends sorted ascending iff g is even (or ``ascending``), with
    every direction flipped by ``invert``: the bitonic level invariant the
    cross-chunk merge expects."""
    rng = np.random.default_rng(30)
    chunk, n = 64, 1024
    x = _keys(rng, n)
    got = _port(tb.chunk_sort, x, chunk, invert=invert, ascending=ascending)
    for g, run in enumerate(got.reshape(-1, chunk)):
        up = (ascending or g % 2 == 0) != invert
        want = np.sort(x[g * chunk: (g + 1) * chunk])
        np.testing.assert_array_equal(run, want if up else want[::-1])


def test_chunk_sort_stage_ranges_compose():
    rng = np.random.default_rng(31)
    x = torch.from_numpy(_keys(rng, 2048))
    whole = tb.chunk_sort_ref(x, 256)
    split = tb.chunk_sort_ref(x, 256, kk_range=range(1, 4))
    split = tb.chunk_sort_ref(split, 256, kk_range=range(4, 9))
    np.testing.assert_array_equal(whole.numpy(), split.numpy())


@pytest.mark.parametrize("kk", [3, 7, 11])
@pytest.mark.parametrize("invert", [False, True])
def test_finish_tile_split(kk, invert):
    """A level's tail in a big tile == cross passes down to a small tile,
    then the small tile's finish (how the host splits every level)."""
    rng = np.random.default_rng(40 + kk)
    x = _keys(rng, 1 << 11)
    big = _port(tb.finish, x, 1 << 11, kk, invert)
    small = torch.from_numpy(x.copy())
    for j_low, f in tb._cross_schedule(kk, 4, tb.cross_fusion(1)):
        tb.cross_stage(small, j_low, f, kk, invert)
    tb.finish(small, 1 << 4, kk, invert)
    np.testing.assert_array_equal(big, small.numpy())


def test_cross_schedule_is_greedy():
    assert list(tb._cross_schedule(23, 15, 4)) == [(19, 4), (15, 4)]
    assert list(tb._cross_schedule(22, 15, 4)) == [(18, 4), (15, 3)]
    assert list(tb._cross_schedule(17, 15, 4)) == [(15, 2)]
    assert list(tb._cross_schedule(15, 15, 4)) == []
    assert list(tb._cross_schedule(14, 15, 4)) == []


def test_cpu_wrappers_count_plain_calls_not_launches():
    tb.reset_counts()
    x = torch.from_numpy(_keys(np.random.default_rng(50), 1 << 12))
    tb.sort_planes(x, 64, 256)
    assert not any(tb.LAUNCHES.values())
    assert all(tb.PLAIN_CALLS[k] > 0
               for k in ("chunk_sort_ref", "cross_stage_ref", "finish_ref"))
    assert np.array_equal(x.numpy(), np.sort(x.numpy()))
    tb.reset_counts()
    assert not any(tb.PLAIN_CALLS.values())


def test_wrappers_reject_bad_buffers():
    x = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError):
        tb.chunk_sort(torch.zeros(1024, dtype=torch.int64), 64)
    with pytest.raises(ValueError):
        tb.chunk_sort(torch.zeros(1000, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        tb.chunk_sort(x[::2], 64)
    with pytest.raises(ValueError):
        tb.chunk_sort(x, 2048)
    with pytest.raises(ValueError):  # more distances than a pass runs
        tb.cross_stage(x, 0, tb.cross_fusion(1) + 1, 10)
    # a tensor on neither the CPU nor a CUDA device has no path at all
    with pytest.raises(ValueError, match="unsupported device"):
        tb.finish(torch.empty(1024, dtype=torch.int32, device="meta"), 64, 10)


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.load()
