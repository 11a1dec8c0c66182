"""The walk of a decoupled look-back, modelled on the CPU.

``csrc/compact.cu`` and ``csrc/segscan.cu`` chain their tiles the same
way: a block publishes its tile's aggregate (flag A), then warp 0 reads its
predecessors' status words ``WINDOW`` at a time, nearest first, until it
meets the word that ends the walk, and the block publishes its inclusive
prefix (flag P).  ``lookback_stop`` is that walk under a visibility of the
status words drawn from a generator; ``compact.compact_lookback`` and
``segscan.segscan_lookback`` build their models of the kernels on it.
"""

from __future__ import annotations

import torch

WINDOW = 32  # status words a look-back read: one warp
EMPTY, AGGREGATE, PREFIX = 0, 1, 2
# What one read of a predecessor's status word may show, read after read
# (the last entry repeats): its aggregate (A), its inclusive prefix (P), or
# A then P, each possibly after empty reads.  Every predecessor publishes A
# and then P; tile 0 publishes P only.
VISIBILITY = ((AGGREGATE,), (PREFIX,), (AGGREGATE, PREFIX),
              (EMPTY, AGGREGATE), (EMPTY, PREFIX),
              (EMPTY, AGGREGATE, PREFIX))


def lookback_stop(t, halts, gen, p_only=None):
    """The kernels' walk back from tile t - 1 (t >= 1): ``WINDOW`` status
    words a read, nearest first, until the nearest word that ends the walk
    (P, or A where ``halts(u)``) has only non-empty words before it; a
    window with an empty word that matters is read again, one without a
    halting word and with no empty word moves back by ``WINDOW``.  What the
    walk sees of predecessor u on its k-th read of a window is
    ``VISIBILITY[c][min(k, len - 1)]``, c drawn from ``gen`` for each
    (window, u); tile 0, and the tiles where ``p_only(u)``, publish P only
    (their A reads show P).  Returns (u, flag) of the word that ended the
    walk."""
    base = t - 1
    while True:
        us = [base - lane for lane in range(WINDOW)]
        picks = torch.randint(len(VISIBILITY), (WINDOW,), generator=gen)
        seen = []
        for u, c in zip(us, picks.tolist()):
            pattern = VISIBILITY[c]
            if u < 0:  # past tile 0 the kernel reads P
                pattern = (PREFIX,)
            elif u == 0 or (p_only is not None and p_only(u)):
                pattern = tuple(PREFIX if f == AGGREGATE else f
                                for f in pattern)
            seen.append(pattern)
        k = 0
        while True:
            flags = [s[min(k, len(s) - 1)] for s in seen]
            halt = [f == PREFIX or (f == AGGREGATE and halts(u))
                    for f, u in zip(flags, us)]
            first = next((i for i, h in enumerate(halt) if h), None)
            if first is not None and EMPTY not in flags[: first + 1]:
                return us[first], flags[first]
            if first is None and EMPTY not in flags:
                break
            k += 1
        base -= WINDOW
