"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and ``sort`` / ``sort_any`` against ``torch.sort``, bit for bit.

Marked ``gpu``; without a CUDA device they skip with a reason (decided in a
fixture, never at import).  On a machine with a card (``--noconftest``
skips tests/conftest.py, which needs JAX for the reference's tests):

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from radx_tpu_torch import SortConfig, sort, sort_any
from radx_tpu_torch.bench import torch_sort_u32
from radx_tpu_torch.kernels import bitonic as tb

pytestmark = pytest.mark.gpu

N = 1 << 20
CFG = SortConfig()
LOG_T = CFG.finish_elems.bit_length() - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _keys(cuda, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(x).to(cuda)


CASES = {
    "chunk_sort": (lambda x: tb.chunk_sort(x, CFG.chunk_elems),
                   lambda x: tb.chunk_sort_ref(x, CFG.chunk_elems)),
    "chunk_sort_invert": (
        lambda x: tb.chunk_sort(x, CFG.chunk_elems, invert=True),
        lambda x: tb.chunk_sort_ref(x, CFG.chunk_elems, invert=True)),
    "chunk_sort_ascending": (
        lambda x: tb.chunk_sort(x, CFG.chunk_elems, ascending=True),
        lambda x: tb.chunk_sort_ref(x, CFG.chunk_elems, ascending=True)),
    **{f"cross_stage<{f}>": (
        lambda x, f=f: tb.cross_stage(x, LOG_T, f, LOG_T + f, f % 2 == 0),
        lambda x, f=f: tb.cross_stage_ref(x, LOG_T, f, LOG_T + f, f % 2 == 0))
       for f in tb.CROSS_FUSION},
    "finish": (lambda x: tb.finish(x, CFG.finish_elems, 20, True),
               lambda x: tb.finish_ref(x, CFG.finish_elems, 20, True)),
    "finish_low_level": (lambda x: tb.finish(x, CFG.finish_elems, 6),
                         lambda x: tb.finish_ref(x, CFG.finish_elems, 6)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, case):
    kernel, ref = CASES[case]
    base = _keys(cuda, N)
    x = base.clone()
    kernel(x)
    want = ref(base)
    torch.cuda.synchronize()
    assert torch.equal(x, want)


@pytest.mark.parametrize(
    "n", [1, 2, 1000, 4097, 1 << 20, 3_000_000, (1 << 22) + 12345]
)
def test_sort_matches_torch_sort(cuda, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)).to(cuda)
    got = sort(keys)
    assert got.dtype == torch.uint32 and got.device == keys.device
    assert torch.equal(got.view(torch.int32),
                       torch_sort_u32(keys).view(torch.int32))


def test_sort_any_matches_torch_sort(cuda):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(
        rng.integers(-(2**31), 2**31, 1 << 18, dtype=np.int64).astype(np.int32)
    ).to(cuda)
    for descending in (False, True):
        want = torch.sort(x, descending=descending).values
        assert torch.equal(sort_any(x, descending), want)
