"""The port's host oracle and runtime (radx_tpu_torch/oracle/,
radx_tpu_torch/runtime/, built from radx_tpu_torch/csrc/host/) against the
JAX package's (radx_tpu/oracle/cpu.py, oracle/native.py,
runtime/native.py), bit for bit (tolerance 0: integer keys and histograms).

Keys from a numpy seed: three uniform seeds, duplicate-heavy keys and
all-0xFFFFFFFF keys, at n = 5000 (three tiles of the default 2048, the last
one ragged) and at 4-bit digits in 512-key tiles.  No card is needed.

The JAX package's loaders build their libraries from cpp/ beside the
sources, with no lock; here they build them into a directory of this
module's own, so that no other test process that builds them at the same
time can hand one a half-written library.
"""

import numpy as np
import pytest

from radx_tpu import runtime as jrt
from radx_tpu.config import SortConfig as JaxSortConfig
from radx_tpu.oracle import cpu as jcpu
from radx_tpu.oracle import native as jnative
from radx_tpu.runtime import native as jrt_native
from radx_tpu_torch import runtime
from radx_tpu_torch.oracle import cpu, native

pytestmark = pytest.mark.usefixtures("jax_libs")


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    lib_dir = tmp_path_factory.mktemp("jax_native")
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jnative, "libradx_oracle.so"),
                          (jrt_native, "libradx_runtime.so")):
            mp.setattr(mod, "_LIB", str(lib_dir / name))
            mp.setattr(mod, "_lib", None)
        yield


N = 5000
CONFIGS = {"default": (JaxSortConfig(), {}),
           "4bit_512": (JaxSortConfig(bits_per_pass=4, tile_rows=4),
                        {"bits_per_pass": 4, "tile_elems": 512})}


def _keys(kind):
    rng = np.random.default_rng({"seed0": 0, "seed1": 1, "seed2": 2}.get(
        kind, 9))
    if kind == "duplicates":
        return rng.integers(0, 7, N, dtype=np.uint32) * np.uint32(0x01010101)
    if kind == "all_ones":
        return np.full(N, 0xFFFFFFFF, np.uint32)
    return rng.integers(0, 2**32, N, dtype=np.uint32)


KINDS = ["seed0", "seed1", "seed2", "duplicates", "all_ones"]


def test_default_tile_is_the_jax_default():
    assert cpu.TILE_ELEMS == JaxSortConfig().tile_elems
    assert cpu.BITS_PER_PASS == JaxSortConfig().bits_per_pass


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("kind", KINDS)
def test_numpy_oracle_matches_jax(kind, config):
    jcfg, kw = CONFIGS[config]
    keys = _keys(kind)
    payload = np.arange(N, dtype=np.uint32)
    for shift in range(0, 32, jcfg.bits_per_pass):
        digits = cpu.extract_digit(keys, shift, jcfg.digit_mask)
        np.testing.assert_array_equal(
            digits, jcpu.extract_digit(keys, shift, jcfg.digit_mask))
        counts = cpu.tile_histograms(digits, jcfg.tile_elems, jcfg.radix)
        np.testing.assert_array_equal(
            counts, jcpu.tile_histograms(digits, jcfg.tile_elems, jcfg.radix))
        bases = cpu.scan_bases(counts)
        np.testing.assert_array_equal(bases, jcpu.scan_bases(counts))
        np.testing.assert_array_equal(
            cpu.rank_and_destinations(digits, bases, jcfg.tile_elems),
            jcpu.rank_and_destinations(digits, bases, jcfg.tile_elems))
        got = cpu.radix_pass(keys, shift, payload, **kw)
        want = jcpu.radix_pass(keys, shift, jcfg, payload)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(cpu.sort_u32(keys, **kw),
                                  jcpu.sort_u32(keys, jcfg))
    gk, gp = cpu.sort_pairs(keys, payload, **kw)
    wk, wp = jcpu.sort_pairs(keys, payload, jcfg)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gk, np.sort(keys))
    np.testing.assert_array_equal(gp, np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("kind", KINDS)
def test_native_oracle_matches_jax(kind, config):
    jcfg, kw = CONFIGS[config]
    keys = _keys(kind)
    payload = np.random.default_rng(5).integers(0, 2**32, N, dtype=np.uint32)
    np.testing.assert_array_equal(native.sort_u32(keys, **kw),
                                  jnative.sort_u32(keys, jcfg))
    gk, gp = native.sort_pairs(keys, payload, **kw)
    wk, wp = jnative.sort_pairs(keys, payload, jcfg)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gp, wp)
    for shift in range(0, 32, jcfg.bits_per_pass):
        got_keys, got_counts = native.radix_pass(keys, shift, **kw)
        want_keys, want_counts = jnative.radix_pass(keys, shift, jcfg)
        np.testing.assert_array_equal(got_keys, want_keys)
        np.testing.assert_array_equal(got_counts, want_counts)
        # the C++ histogram is the NumPy oracle's phase 1
        np.testing.assert_array_equal(got_counts, cpu.tile_histograms(
            cpu.extract_digit(keys, shift, jcfg.digit_mask), jcfg.tile_elems,
            jcfg.radix))


def test_native_oracle_takes_a_32_bit_payload():
    keys = _keys("duplicates")
    vals = np.random.default_rng(6).random(N).astype(np.float32)
    gk, gp = native.sort_pairs(keys, vals)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gp, vals[order].view(np.uint32))
    with pytest.raises(TypeError):
        native.sort_pairs(keys, vals.astype(np.float64))
    with pytest.raises(ValueError):
        native.sort_u32(keys, bits_per_pass=3)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_generators_match_jax(seed):
    n = 100_003
    np.testing.assert_array_equal(runtime.gen_uniform(n, seed),
                                  jrt.gen_uniform(n, seed))
    np.testing.assert_array_equal(runtime.gen_permutation(n, seed),
                                  jrt.gen_permutation(n, seed))
    np.testing.assert_array_equal(runtime.gen_skewed(n, seed),
                                  jrt.gen_skewed(n, seed))
    np.testing.assert_array_equal(
        runtime.gen_skewed(n, seed, 0x10, 0x1F, 0.5),
        jrt.gen_skewed(n, seed, 0x10, 0x1F, 0.5))


def test_validate_sort_matches_jax():
    orig = runtime.gen_uniform(200_000, seed=7)
    good = np.sort(orig)
    unsorted = good.copy()
    unsorted[10], unsorted[20] = unsorted[20], unsorted[10]
    forged = good.copy()
    forged[0] += 1
    forged.sort()
    cases = {0: (orig, good), 1: (orig, unsorted), 2: (orig, forged)}
    for code, (a, b) in cases.items():
        assert runtime.validate_sort(a, b) == jrt.validate_sort(a, b) == code
    assert runtime.validate_sort(orig, good[:-1]) == jrt.validate_sort(
        orig, good[:-1]) == 2
    empty = np.zeros(0, np.uint32)
    assert runtime.validate_sort(empty, empty) == 0
