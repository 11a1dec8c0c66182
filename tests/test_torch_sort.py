"""The port's sort API (radx_tpu_torch/ops/sort.py) against the JAX package's
(radx_tpu/ops/sort.py, Pallas kernels in interpret mode), bit for bit
(tolerance 0: integer keys and float bit patterns), plus numpy checks at sizes
too large for interpret mode.  On the CPU the port's kernel wrappers run
their plain PyTorch versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.ops import sort as js
from radx_tpu_torch import SortConfig, sort, sort_any
from radx_tpu_torch.config import config_from_jax
from radx_tpu_torch.ops import sort as ts

JCFG = JaxSortConfig(chunk_rows=8, interpret=True)
CFG = config_from_jax(JCFG)
SMALL = SortConfig(chunk_elems=16, finish_elems=64)


def _distributions(rng, n):
    """tests/test_sort.py's distributions, plus the pad-sentinel key."""
    return {
        "uniform": rng.integers(0, 2**32, n, dtype=np.uint32),
        "permutation": rng.permutation(n).astype(np.uint32),
        "constant": np.full(n, 0xDEADBEEF, dtype=np.uint32),
        "presorted": np.arange(n, dtype=np.uint32),
        "reverse": np.arange(n, 0, -1).astype(np.uint32),
        "low_entropy": rng.integers(0, 16, n, dtype=np.uint32),
        "extremes": rng.choice(
            np.array([0, 1, 2**31, 2**32 - 1], dtype=np.uint32), n
        ),
        "all_ffffffff": np.full(n, 0xFFFFFFFF, dtype=np.uint32),
    }


def _port_sort(keys, cfg):
    out = sort(keys, cfg, device="cpu")
    assert out.dtype == torch.uint32 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("n", [1000, 4096])
def test_sort_matches_jax(n):
    rng = np.random.default_rng(n)
    for name, keys in _distributions(rng, n).items():
        want = np.asarray(js.sort(keys, JCFG))
        for cfg in (CFG, SMALL, SortConfig(), SortConfig(strategy="lax")):
            np.testing.assert_array_equal(
                _port_sort(keys, cfg), want, err_msg=f"{name} {cfg}"
            )


@pytest.mark.parametrize("n", [3000, 5120])
def test_sort_arbn_keys_matches_jax(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    keys[:50] = 0xFFFFFFFF  # real keys equal to the pad sentinel
    want = np.asarray(js._sort_arbn_keys_jit(jnp.asarray(keys), JCFG, n))
    got = ts._sort_arbn_keys(torch.from_numpy(keys), CFG, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


def _special_floats(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    special = np.array(
        [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45],
        dtype=np.float32,
    )
    x[rng.integers(0, n, 200)] = rng.choice(special, 200)
    return x


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_sort_any_matches_jax(dtype):
    rng = np.random.default_rng(7)
    n = 2000
    if dtype == "int32":
        keys = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
        keys[:4] = [-(2**31), 2**31 - 1, 0, -1]
    else:
        keys = _special_floats(rng, n)
    for descending in (False, True):
        want = np.asarray(js.sort_any(keys, descending, JCFG))
        got = sort_any(keys, descending, CFG, device="cpu")
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32), want.view(np.uint32),
            err_msg=f"descending={descending}",
        )


def test_sort_any_uint32_and_total_order():
    keys = np.array(
        [np.nan, 1.0, -0.0, np.inf, 0.0, -np.inf, -1.0], dtype=np.float32
    )
    got = sort_any(torch.from_numpy(keys)).numpy()
    want = np.array(
        [-np.inf, -1.0, -0.0, 0.0, 1.0, np.inf, np.nan], dtype=np.float32
    )
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    u = np.array([5, 0xFFFFFFFF, 0, 7], dtype=np.uint32)
    np.testing.assert_array_equal(
        sort_any(u, True, device="cpu").numpy(), np.sort(u)[::-1]
    )
    with pytest.raises(TypeError):  # 64-bit keys come as numpy arrays
        sort_any(torch.zeros(4, dtype=torch.int64))


# n -> (pow2 path / decomposition) routing table, incl. the 2^22 threshold
_ROUTING_N = [
    1, 1000, (1 << 21) + 1, (1 << 22) - 1, 1 << 22, (1 << 22) + 1,
    3 * (1 << 22) + 7, (1 << 23) - 5, (1 << 23) + 1, 60_000_000, 1 << 26,
]


def test_routing_matches_jax():
    for strategy in ("bitonic", "lax"):
        jcfg, cfg = JaxSortConfig(strategy=strategy), SortConfig(strategy=strategy)
        for n in _ROUTING_N:
            assert ts._use_decomposition(n, cfg) == js._use_decomposition(
                n, jcfg
            ), (strategy, n)
    for n in _ROUTING_N + [8 * 128 * 65, 8 * 128 * 4097]:
        for block in (1024, 1 << 13):
            assert ts._decompose_blocks(n, block) == js._decompose_blocks(
                n, block
            ), (n, block)
        assert ts._pad_len(n) == js._pad_len(n)


@pytest.mark.parametrize("log_n", [16, 18])
def test_sort_large_vs_numpy(log_n):
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    for cfg in (SortConfig(), SMALL):
        np.testing.assert_array_equal(_port_sort(keys, cfg), np.sort(keys))


@pytest.mark.parametrize("n", [(1 << 16) + 3, 300_000])
def test_sort_arbn_keys_large_vs_numpy(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    cfg = SortConfig(chunk_elems=1024, finish_elems=4096)
    got = ts._sort_arbn_keys(torch.from_numpy(keys), cfg, n)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


def test_sort_small_n_and_input_untouched():
    for n in (0, 1, 2, 3):
        keys = np.arange(n, 0, -1).astype(np.uint32)
        np.testing.assert_array_equal(_port_sort(keys, SortConfig()), np.sort(keys))
    t = torch.from_numpy(np.array([3, 1, 2], np.uint32))
    out = sort(t)
    assert out.data_ptr() != t.data_ptr()
    np.testing.assert_array_equal(t.numpy(), [3, 1, 2])
    np.testing.assert_array_equal(out.numpy(), [1, 2, 3])


def test_sort_input_validation():
    with pytest.raises(TypeError):
        sort(np.arange(4, dtype=np.int64), device="cpu")
    with pytest.raises(ValueError):
        sort(np.zeros((2, 2), dtype=np.uint32), device="cpu")
    if torch.cuda.is_available():  # a numpy input goes to the card by default
        assert sort(np.zeros(4, dtype=np.uint32)).device.type == "cuda"
    else:  # torch's own error, no CPU path
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            sort(np.zeros(4, dtype=np.uint32))
    with pytest.raises(ValueError, match="lie on"):
        sort(torch.zeros(4, dtype=torch.uint32), device="cuda")
    with pytest.raises(TypeError):
        sort([3, 2, 1], device="cpu")


def test_config_validation():
    radix = SortConfig(strategy="radix")
    assert radix.strategy == "radix"
    assert radix.mode_tiles(1, 1) == (radix.chunk_elems, radix.finish_elems)
    assert radix.mode_tiles(2, 1) == (radix.rider_chunk_elems,
                                      radix.rider_finish_elems)
    assert radix.mode_tiles(5, 2) == radix.lex_tiles(5)
    with pytest.raises(ValueError):
        SortConfig(strategy="quick")
    with pytest.raises(ValueError):
        SortConfig(chunk_elems=1000)
    with pytest.raises(ValueError):
        SortConfig(chunk_elems=1024, finish_elems=512)
