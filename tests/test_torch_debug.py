"""The port's debug utilities (radx_tpu_torch/utils/debug.py) against the JAX
package's (radx_tpu/utils/debug.py).

``interpret_parity`` runs ``build_fn(False)`` on a device and
``build_fn(True)`` on CPU copies; here both sides are the CPU
(``device="cpu"``), where the port's wrappers run their plain versions, so
the sort must agree with itself bit for bit, and a side that flips one bit
must read as a difference of 1.  On the same numpy build function both
packages return the same ``(ok, max_abs_diff)``.  ``checked`` raises on a
NaN the function introduced and on nothing else.
"""

import numpy as np
import pytest
import torch

from radx_tpu.utils import debug as jdebug
from radx_tpu_torch import filter_columns, sort
from radx_tpu_torch.utils import debug

KEYS = np.random.default_rng(3).integers(0, 2**32, 4096, dtype=np.uint32)


def test_parity_of_sort_on_the_cpu():
    assert debug.interpret_parity(lambda interpret: sort, KEYS,
                                  device="cpu") == (True, 0)


def test_parity_sees_one_flipped_bit():
    def build(interpret):
        def run(keys):
            out = sort(keys).clone()
            if interpret:
                out.view(torch.int32)[100] ^= 1
            return out
        return run

    assert debug.interpret_parity(build, KEYS, device="cpu") == (False, 1)
    assert debug.interpret_parity(build, KEYS, atol=1,
                                  device="cpu") == (True, 1)


def test_parity_over_nested_outputs():
    """``filter_columns`` returns ([columns], count): every leaf counts."""
    mask = (KEYS & 1).astype(np.int32)
    vals = np.arange(KEYS.size, dtype=np.int32)
    assert debug.interpret_parity(lambda interpret: filter_columns, mask,
                                  [KEYS, vals], device="cpu") == (True, 0)


def test_parity_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        debug.interpret_parity(lambda interpret: sort, KEYS)


def test_parity_contract_matches_jax():
    """The same numpy build function through both: a nested output, one
    leaf off by 7 on the interpret side."""
    def build(interpret):
        def run(x):
            x = np.asarray(x)
            return np.sort(x), [x[:3].astype(np.int64) + (7 if interpret
                                                          else 0)]
        return run

    assert (debug.interpret_parity(build, KEYS, device="cpu")
            == jdebug.interpret_parity(build, KEYS) == (False, 7))


def test_checked_raises_on_a_nan_it_made():
    with pytest.raises(FloatingPointError):
        debug.checked(lambda x: x * float("nan"))(torch.ones(4))
    with pytest.raises(FloatingPointError):
        debug.checked(lambda x: (x, [x / 0 * 0]))(torch.zeros(2))


def test_checked_passes_a_nan_that_came_in():
    x = torch.tensor([1.0, float("nan")])
    out = debug.checked(lambda v: v + 1)(x)
    assert torch.isnan(out[1]) and out[0] == 2
    out = debug.checked(lambda v: torch.from_numpy(v) * 2)(
        np.array([np.nan], np.float32))
    assert torch.isnan(out).all()


def test_checked_returns_the_output_unchanged():
    made = (torch.arange(3.0), [torch.tensor(1)])
    assert debug.checked(lambda: made)() is made
    keys = torch.from_numpy(KEYS)
    assert torch.equal(debug.checked(sort)(keys).view(torch.int32),
                       sort(keys).view(torch.int32))
