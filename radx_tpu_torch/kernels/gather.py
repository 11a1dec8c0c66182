"""Gather of int32 value planes by an index plane on Hopper (no Pallas
counterpart).

The JAX package pushes every value plane through its sort network beside
the compare planes, because a gather is slow on a TPU.  The port sorts only
the two compare planes — (key, tie) for the join's tagged union, (key,
index) for the stable sorts — and then fetches the value planes with
``gather_planes(index, sources, mode)``, which returns new int32 planes of
the index's length:

  * ``"index"``: ``out[g][i] = sources[g][index[i]]`` for 1..4 sources;
  * ``"tagged"``: sources (build values, probe values) and the join's tie
    plane: a tie t < 2^30 gives (build[t], 0), 2^30 <= t < 0x7FFFFFFF gives
    (0, probe[t - 2^30]), the pad tie 0x7FFFFFFF gives (0, 0).

An index outside its source's rows gives 0.  On a CUDA tensor one launch of
``gather_planes`` (radx_tpu_torch/csrc/gather.cu: 16-byte index loads, many
random reads in flight a thread, coalesced stores) computes all the planes;
on a CPU tensor the plain PyTorch version runs.  ``LAUNCHES`` /
``PLAIN_CALLS`` count the kernel's launches (by mode) and the plain calls.
"""

from __future__ import annotations

import ctypes

import torch

from radx_tpu_torch.kernels import _build

KERNELS = ("gather_planes", "gather_planes/tagged")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = {"gather_planes_ref": 0}
MAX_PLANES = 4
PROBE_TIE = 1 << 30
PAD_TIE = 0x7FFFFFFF
_KERNEL = {"index": "gather_planes", "tagged": "gather_planes/tagged"}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


def _take(src, index):
    """src[index] where 0 <= index < len(src), else 0."""
    ok = (index >= 0) & (index < src.numel())
    if src.numel() == 0:
        return torch.zeros_like(index)
    return torch.where(ok, src[index.clamp(0, src.numel() - 1).long()], 0)


def gather_planes_ref(index, sources, mode="index"):
    """Plain version of ``gather_planes``."""
    PLAIN_CALLS["gather_planes_ref"] += 1
    if mode == "index":
        return [_take(s, index) for s in sources]
    build, probe = sources
    is_probe = index >= PROBE_TIE
    return [torch.where(is_probe, 0, _take(build, index)),
            torch.where(is_probe & (index != PAD_TIE),
                        _take(probe, index - PROBE_TIE), 0)]


def _validate(index, sources, mode):
    def ok(x):
        return x.dim() == 1 and x.is_contiguous() and x.dtype == torch.int32

    if mode not in _KERNEL:
        raise ValueError(f"mode must be 'index' or 'tagged', got {mode!r}")
    if not ok(index):
        raise ValueError("the index must be a contiguous 1-D int32 tensor")
    if mode == "tagged" and len(sources) != 2:
        raise ValueError("tagged mode takes two sources (build, probe)")
    if not 1 <= len(sources) <= MAX_PLANES:
        raise ValueError(f"gather_planes takes 1..{MAX_PLANES} sources")
    for s in sources:
        if not ok(s) or s.device != index.device:
            raise ValueError("every source must be a contiguous 1-D int32 "
                             "tensor on the index's device")
    if index.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {index.device}")


def gather_planes(index, sources, mode="index"):
    """Int32 planes of ``index``'s length gathered from int32 ``sources``
    by ``index`` (see the module docstring for the two modes)."""
    sources = list(sources)
    _validate(index, sources, mode)
    if index.device.type == "cpu":
        return gather_planes_ref(index, sources, mode)
    n = index.numel()
    outs = [torch.empty(n, dtype=torch.int32, device=index.device)
            for _ in sources]
    if n == 0:
        return outs
    _build.launch(LAUNCHES, _KERNEL[mode], "radx_gather_planes", index.device,
                  index.data_ptr(), n,
                  (ctypes.c_void_p * len(sources))(
                      *[s.data_ptr() for s in sources]),
                  (ctypes.c_int64 * len(sources))(
                      *[s.numel() for s in sources]),
                  (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs]),
                  len(sources), mode == "tagged")
    return outs
