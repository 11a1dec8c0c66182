"""The port's measuring surface (radx_tpu_torch/bench_suite.py, utils/
timing.py, config.tuned, radx_tpu_torch/tools/) on the CPU, where every
kernel wrapper runs its plain version and nothing is timed: each config's
make -> op -> gate at a small size, each gate against corrupted outputs,
the ``pairs_*`` op bit-equal to the JAX ``sort_planes`` (interpret mode,
tolerance 0: (key, index) is a total order), ``Metrics.row()`` against the
JAX row, ``tuned()``'s lookup, the autotune's pick rule and the
distributed dry run at 16 shards.  Card-only cases are in
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu import bench_suite as jax_suite
from radx_tpu.kernels import bitonic as jb
from radx_tpu.utils import timing as jax_timing
from radx_tpu_torch import DEFAULT, SortConfig, bench_suite, config, tuned
from radx_tpu_torch.ops import sort as ts
from radx_tpu_torch.tools import autotune, dryrun_scale
from radx_tpu_torch.utils import Metrics, time_op, timing

N = 4096
# the radix plan needs slots of >= 1024 keys: 2^16 keys at the smallest
SIZES = {"sort_radix_64m": 1 << 16, "sort_radix_268m": 1 << 16}
EXTRA = ("sort_536m", "sort_1g", "argsort_4m", "argsort_64m", "topk_4m",
         "topk_16m", "arbn_600m", "sort_chunked_1g")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gate(name):
    c = bench_suite.CONFIGS[name]
    gen = torch.Generator().manual_seed(c.seed)
    data = c.make(SIZES.get(name, N), torch.device("cpu"), gen)
    return c, data, c.op(data)


def test_configs_cover_the_jax_suite_and_the_extra_rows():
    assert set(jax_suite.CONFIGS) <= set(bench_suite.CONFIGS)
    assert set(EXTRA) <= set(bench_suite.CONFIGS)
    assert set(bench_suite.DEFAULT_SET) == set(bench_suite.CONFIGS) - {
        "sort_chunked_1g"}


@pytest.mark.parametrize("name", list(bench_suite.CONFIGS))
def test_config_gate_passes_on_cpu(name):
    c, data, out = _gate(name)
    c.check(data, out)
    assert c.item_bytes > 0 and c.kernels


def _map_first(out, fn):
    """``out`` with its first array replaced by fn(array)."""
    if isinstance(out, (torch.Tensor, np.ndarray)):
        return fn(out)
    first = _map_first(out[0], fn)
    return type(out)([first, *out[1:]])


def _copy(t):
    """(a copy of t, a writable int32 view of it where t has 4-byte
    elements: PyTorch compares no uint32 on the CPU)."""
    t = t.copy() if isinstance(t, np.ndarray) else t.clone()
    return t, t.view(np.int32 if isinstance(t, np.ndarray) else torch.int32)


def _swap(t):
    t, w = _copy(t)
    j = next(j for j in range(1, len(w)) if w[j] != w[0])
    w[[0, j]] = w[[j, 0]]
    return t


def _flip_bit(t):
    t, w = _copy(t)
    w[0] ^= 1
    return t


def _wrong_count(out):
    """The count (a 0-d tensor) plus one where the output has one, else the
    first array one row short."""
    if isinstance(out, (tuple, list)):
        for i, x in enumerate(out):
            if isinstance(x, torch.Tensor) and x.dim() == 0:
                return type(out)([*out[:i], x + 1, *out[i + 1:]])
    return _map_first(out, lambda t: t[:-1])


CORRUPT = {"swap": lambda out: _map_first(out, _swap),
           "bit_flip": lambda out: _map_first(out, _flip_bit),
           "wrong_count": _wrong_count}


@pytest.mark.parametrize("how", list(CORRUPT))
@pytest.mark.parametrize("name", list(bench_suite.CONFIGS))
def test_gate_rejects_a_corrupted_output(name, how):
    c, data, out = _gate(name)
    bad = CORRUPT[how](out)
    with pytest.raises(AssertionError):
        c.check(data, bad)


def test_arbn_takes_the_arbitrary_n_path():
    """At its own n, and at the smallest n where the CPU reaches the
    decomposition path, where the gate passes."""
    c = bench_suite.CONFIGS["arbn_600m"]
    assert ts._use_decomposition(c.n, tuned())
    n = (1 << 22) + (1 << 20)
    assert ts._use_decomposition(n, tuned())
    bench_suite.make_and_gate("arbn_600m", n, "cpu")


def test_pairs_op_matches_jax_sort_planes():
    c, data, out = _gate("pairs_4m")
    want = jb.sort_planes([jnp.asarray(p.numpy().reshape(-1, 128))
                           for p in data["planes"]], 8, 2, interpret=True)
    for got, w in zip(out, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w).reshape(-1))


@pytest.mark.parametrize("seconds,items,bytes_", [
    (1e-3, 1 << 23, 8 << 23), (0.2501, 600_000_000, 0), (3.7e-5, 4096, 12)])
def test_metrics_row_matches_jax(seconds, items, bytes_):
    got = Metrics("sort_u32 2^23", seconds, items, bytes_, spread_pct=3.0)
    want = jax_timing.Metrics("sort_u32 2^23", seconds, items, bytes_)
    assert got.row() == want.row()
    assert got.items_per_s == want.items_per_s
    assert got.gbytes_per_s == want.gbytes_per_s


def test_tuned_by_card(monkeypatch):
    monkeypatch.setattr(config, "device_kind", lambda: "NVIDIA H100 80GB HBM3")
    assert tuned() == SortConfig(**config.TUNING["NVIDIA H100"])
    monkeypatch.setattr(config, "device_kind", lambda: "cpu")
    assert tuned() == SortConfig(**config.TUNING["cpu"])
    monkeypatch.setattr(config, "device_kind", lambda: "NVIDIA A100-SXM4-80GB")
    assert tuned() == DEFAULT
    assert tuned(chunk_elems=1 << 12).chunk_elems == 1 << 12
    assert tuned(strategy="radix").strategy == "radix"


def test_device_kind_without_cuda():
    assert config.device_kind() == "cpu"


def test_timing_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        time_op(lambda x: x + 1, torch.zeros(8))
    with pytest.raises(RuntimeError):
        with timing.trace("unused.json"):
            pass
    with pytest.raises(RuntimeError):
        bench_suite.run("sort_8m", N)


def _rows(times):
    """Sweep rows of the keys-only tiles: {(chunk, finish): (ms, spread)}."""
    return [{"metric": "sort_u32_keys_per_s_n2e26", "ms": ms,
             "spread_pct": sp, "chunk_elems": c, "finish_elems": f}
            for (c, f), (ms, sp) in times.items()]


@pytest.mark.parametrize("win_ms,spread,picked", [
    (8.0, 1.0, (1 << 13, 1 << 15)),   # 25% faster, 1% spread: the winner
    (9.9, 2.0, (1 << 14, 1 << 14)),   # 1% faster, 2% spread: the default
])
def test_autotune_pick_rule(win_ms, spread, picked):
    rows = _rows({(1 << 14, 1 << 14): (10.0, spread),
                  (1 << 13, 1 << 15): (win_ms, spread),
                  (1 << 12, 1 << 13): (12.0, spread)})
    p = autotune.pick(rows, *autotune.PICKED["keys"])
    assert p["winner"] == [1 << 13, 1 << 15]
    assert tuple(p["pick"]) == picked


def test_dryrun_scale_16_shards_on_cpu(capsys):
    assert dryrun_scale.main(["16", "--device", "cpu", "--per-device",
                              "1024"]) == 0
    out = capsys.readouterr().out
    assert "D= 16 exchange=hier waves=  6" in out
    assert out.strip().endswith("DRYRUN_SCALE_OK")
