"""Bit-exact host oracles of the sort, independent of torch — the port of
radx_tpu/oracle.

``cpu`` is the tiled LSD radix sort in NumPy, ``native`` the same in C++
(``csrc/host/oracle.cc``, built with g++ at first use).  The card's sort
is held against them (BASELINE config 1), so its gate does not rest on
``torch.sort``.
"""

from radx_tpu_torch.oracle import cpu, native  # noqa: F401
