"""The tile partition of ``merge_runs``' CUDA kernel (csrc/merge.cu) on the
CPU, no JAX: ``kernels/merge.merge_runs_model`` runs the kernel's blocks,
their boundary searches, the rings its 16-byte asynchronous loads fill (a
read of a row that is not in its slot, or whose load group has not landed,
fails), each thread's split and serial merge and the stage's 16-byte
stores, and must give ``merge_runs_ref``'s rows and a stable numpy sort's.

  * runs of 0, 1, 15, 16 and 17 rows; one tile, one row less and one more
    at each tile size the kernel uses;
  * windows that start at every offset mod 4 (views of a larger plane), the
    output's too, and the loads and stores that go 16 bytes at a time;
  * all-equal keys, real 0xFFFFFFFF keys, few distinct keys; (key, index)
    with one payload, and four planes;
  * a block that streams more rows of one run than its ring holds, several
    blocks a merge, each row loaded once;
  * the block-wide search against the split of a numpy sort, in its rounds.
"""

import numpy as np
import pytest
import torch

from radx_tpu_torch.kernels import merge as tm

SIGN = -(1 << 31)

torch.set_num_threads(1)


def _held(planes, n, skew, fill=0):
    """Planes of n + 8 rows or more, plane p's row 0 p * skew rows past a
    16-byte boundary, and the index of a row on one."""
    held = torch.full((planes, (n + 11) // 4 * 4 + skew), fill,
                      dtype=torch.int32)
    return held, (4 - (held.data_ptr() >> 2) % 4) % 4


def _run(rng, n, planes, ncmp, keys, offset=0, skew=0):
    """One ascending run as a list of int32 planes, each a view that starts
    ``offset`` rows (plane p: + p * skew) past a 16-byte boundary."""
    x = np.empty((planes, n), np.int64)
    x[0] = {"uniform": lambda: rng.integers(-(2**31), 2**31, n),
            "few": lambda: rng.integers(-3, 3, n),
            "equal": lambda: np.full(n, 0x5EED),
            "ffffffff": lambda: np.where(rng.random(n) < 0.5, 0x7FFFFFFF,
                                         rng.integers(0, 2**31, n))}[keys]()
    for p in range(1, planes):
        x[p] = rng.integers(-(2**31), 2**31, n)
    x = x.astype(np.int32)
    x = x[:, np.lexsort(x[:ncmp][::-1])] if n else x
    held, base = _held(planes, n, skew)
    held[:, base + offset:base + offset + n] = torch.from_numpy(x)
    return [h[base + offset:base + offset + n] for h in held]


def _want(a, b, ncmp, key_xor):
    x = np.concatenate([np.stack([p.numpy() for p in a]),
                        np.stack([p.numpy() for p in b])], axis=1)
    out = x[:, np.lexsort(x[:ncmp][::-1])]  # stable: A's first on a tie
    out[0] ^= np.int32(key_xor)
    return out


def _check(a, b, ncmp, blocks, items=None, out_offset=0, out_skew=0,
           key_xor=SIGN):
    """The model against merge_runs_ref and numpy, into views of larger
    planes (as ``_run`` places them) that must stay untouched around them;
    returns the stats."""
    n = a[0].numel() + b[0].numel()
    held, base = _held(len(a), n, out_skew, fill=7)
    out = [h[base + out_offset:base + out_offset + n] for h in held]
    before = held.clone()
    got, stats = tm.merge_runs_model(a, b, ncmp, key_xor, blocks=blocks,
                                     items=items, out=out)
    want = tm.merge_runs_ref(a, b, ncmp, key_xor=key_xor)
    for g, w, r in zip(got, want, _want(a, b, ncmp, key_xor)):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), r)
    outside = torch.ones_like(held, dtype=torch.bool)
    outside[:, base + out_offset:base + out_offset + n] = False
    assert torch.equal(held[outside], before[outside])
    # each row of each plane loaded once, up to the 16-byte groups' ends
    planes = len(a)
    assert planes * n <= stats["rows_loaded"] <= planes * (n + 16 * blocks)
    assert stats["cp4"] <= planes * 2 * 8 * blocks
    return stats


@pytest.mark.parametrize("na", [0, 1, 15, 16, 17])
@pytest.mark.parametrize("nb", [0, 1, 15, 16, 17])
def test_short_runs(na, nb):
    rng = np.random.default_rng(na * 31 + nb)
    a = _run(rng, na, 2, 1, "few", offset=1)
    b = _run(rng, nb, 2, 1, "few", offset=2)
    _check(a, b, 1, blocks=1)


@pytest.mark.parametrize("planes,ncmp", [(1, 1), (2, 1), (3, 2)])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_one_tile_and_a_row(planes, ncmp, delta):
    """na + nb = one tile of the kernel's size for the plane count, one row
    less, one more (two tiles: the second of one row)."""
    tile = tm.THREADS * tm.ITEMS[planes]
    n = tile + delta
    rng = np.random.default_rng(n + planes)
    na = n // 3
    a = _run(rng, na, planes, ncmp, "uniform", offset=3)
    b = _run(rng, n - na, planes, ncmp, "uniform")
    stats = _check(a, b, ncmp, blocks=1 + (delta > 0))
    # tiles start at multiples of 4 rows: the last one's tail alone
    assert stats["store4"] == planes * (n % 4)


@pytest.mark.parametrize("off_a", range(4))
@pytest.mark.parametrize("off_b", range(4))
def test_windows_at_every_offset(off_a, off_b):
    """Both runs and the output start at every offset mod 4 from a 16-byte
    boundary; two blocks of two tiles of 7 rows a thread, two planes."""
    rng = np.random.default_rng(4 * off_a + off_b)
    tile = tm.THREADS * 7
    a = _run(rng, 2 * tile - 5, 2, 1, "uniform", offset=off_a)
    b = _run(rng, 2 * tile + 9, 2, 1, "uniform", offset=off_b)
    off_out = (off_a + 2 * off_b) % 4
    stats = _check(a, b, 1, blocks=2, out_offset=off_out)
    loaded = stats["rows_loaded"]
    assert 4 * stats["cp16"] >= loaded - 2 * 2 * 2 * 6  # 16 bytes at a time
    if off_out:
        assert 0 < stats["store4"] <= 2 * 5 * 6  # a tile's head and tail
    else:
        assert stats["store4"] <= 2 * 4  # the last tile's tail


@pytest.mark.parametrize("keys,ncmp,planes", [
    ("equal", 1, 1), ("equal", 2, 3), ("ffffffff", 1, 1),
    ("ffffffff", 2, 2), ("few", 2, 3), ("uniform", 2, 3),
    ("uniform", 1, 4), ("few", 2, 4)])
def test_keys_and_planes(keys, ncmp, planes):
    """All-equal keys (A's rows first), real 0xFFFFFFFF keys, few keys;
    lex2 with a payload, four planes; three blocks, each plane of a run at
    its own offset from a 16-byte boundary."""
    rng = np.random.default_rng(len(keys) * 10 + planes)
    tile = tm.THREADS * tm.ITEMS[planes]
    a = _run(rng, tile + 123, planes, ncmp, keys, offset=1, skew=1)
    b = _run(rng, 2 * tile - 77, planes, ncmp, keys, offset=3, skew=2)
    _check(a, b, ncmp, blocks=3, out_offset=2, out_skew=3)


@pytest.mark.parametrize("items", [7, 15])
@pytest.mark.parametrize("layout", ["a_first", "b_first", "interleaved"])
def test_ring_wraps(items, layout):
    """One block merges more rows of one run than its ring holds: all of
    A before B, all of B before A, or uniform keys (one plane, the key
    XOR off)."""
    ring = tm.ring_rows(tm.THREADS * items)
    n = ring + 1000
    rng = np.random.default_rng(items)
    a = _run(rng, n, 1, 1, "uniform", offset=2)
    b = _run(rng, n // 2, 1, 1, "uniform", offset=1)
    if layout != "interleaved":  # A's keys below B's, or above
        lift = 1 << 21 if layout == "b_first" else 0
        a[0].copy_(torch.from_numpy(np.sort(
            rng.integers(0, 1 << 20, n)) + lift))
        b[0].copy_(torch.from_numpy(np.sort(
            rng.integers(1 << 20, 1 << 21, n // 2))))
    _check(a, b, 1, blocks=1, items=items, key_xor=0)


@pytest.mark.parametrize("blocks", [1, 2, 3, 5])
def test_blocks_split_the_tiles(blocks):
    """Five tiles of one plane over 1..5 blocks: each block merges its own
    rows between the splits its search found."""
    tile = tm.THREADS * tm.ITEMS[1]
    rng = np.random.default_rng(blocks)
    a = _run(rng, 2 * tile + 1, 1, 1, "few", offset=3)
    b = _run(rng, 3 * tile - 9, 1, 1, "few", offset=1)
    stats = _check(a, b, 1, blocks=blocks)
    # the ends of the merge need no search; 128 probes a round
    assert stats["rounds"] == (0 if blocks == 1 else 2)


@pytest.mark.parametrize("log_n", [10, 17, 20])
def test_block_search_rounds(log_n):
    """The block-wide search finds the split of every diagonal of a
    numpy sort's merge, in ceil(log_n / 7) rounds or fewer (128 probes a
    round)."""
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    ca = np.sort(rng.integers(0, n // 4, n)).tolist()
    cb = np.sort(rng.integers(0, n // 4, n // 2 + 3)).tolist()
    order = np.argsort(np.concatenate([ca, cb]), kind="stable")
    from_a = np.concatenate([[0], np.cumsum(order < n)])
    for d in [0, 1, n // 3, n, n + 7, len(order) - 1, len(order)]:
        split, rounds = tm.block_splits_model(ca, cb, d)
        assert split == from_a[d]
        assert rounds <= -(-log_n // 7)


def test_items_are_checked():
    a = [torch.zeros(4, dtype=torch.int32)]
    for planes, items in ((4, 15), (1, 9), (2, 8)):
        with pytest.raises(ValueError):
            tm.merge_runs_model(a * planes, a * planes, blocks=1,
                                items=items)
    with pytest.raises(ValueError):
        tm.merge_runs_model(a, a, blocks=2)
    got, _ = tm.merge_runs_model(a * 3, a * 3, 2, blocks=1, items=15)
    assert got[0].numel() == 8
