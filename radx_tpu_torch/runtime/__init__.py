"""Host runtime in C++ (``csrc/host/runtime.cc`` via ctypes): seeded
multithreaded key generators and a sort validator — the port of
radx_tpu/runtime."""

from radx_tpu_torch.runtime.native import (  # noqa: F401
    gen_permutation,
    gen_skewed,
    gen_uniform,
    validate_sort,
)
