"""One rank of a multi-process distributed sort — the counterpart of
tools/multihost_worker.py.

    python -m radx_tpu_torch.parallel._worker ADDRESS NUM_PROCS RANK N \\
        [--device cpu|cuda] [--exchange flat|hier] [--pairs] [--out FILE.npz]

Every rank makes the same input from one seed (uniform uint32 keys; with
``--pairs`` keys below 256 and uint32 payloads), joins the group at
ADDRESS (``host:port`` of rank 0; gloo on the CPU, NCCL on a card), sorts
its shard (keys: ``sort_sharded_guarded``, or ``sort_sharded`` for hier;
pairs: stable ``sort_pairs_sharded``),
gathers every rank's rows with ``allgather_result``, checks the valid
prefixes against numpy and prints ``WORKER_OK rank=R``.  Rank 0 writes the
gathered rows, valid counts and overflow flags to ``--out``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


SEED = 1234


def make_input(n: int, pairs: bool, seed: int = SEED):
    """(keys, values or None): the input every rank rebuilds."""
    rng = np.random.default_rng(seed)
    if not pairs:
        return rng.integers(0, 2**32, n, dtype=np.uint32), None
    return (rng.integers(0, 256, n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("address")
    ap.add_argument("num_procs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--exchange", default="flat", choices=("flat", "hier"))
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from radx_tpu_torch.parallel import dist_sort, multihost

    if args.device == "cpu":
        torch.set_num_threads(1)
    multihost.init_multihost(args.address, args.num_procs, args.rank,
                             device=args.device)
    try:
        mesh = multihost.global_mesh()
        keys, vals = make_input(args.n, args.pairs)
        shard = multihost.shard_global(keys, mesh)
        if args.pairs:
            k, v, valid, overflow = dist_sort.sort_pairs_sharded(
                shard, multihost.shard_global(vals, mesh), mesh,
                stable=True, exchange=args.exchange)
            planes = [k, v]
        else:
            if args.exchange == "flat":
                k, valid, overflow = multihost.sort_sharded_guarded(
                    shard, mesh, timeout_s=600.0)
            else:
                k, valid, overflow = dist_sort.sort_sharded(
                    shard, mesh, exchange=args.exchange)
            planes = [k]
        rows = [multihost.allgather_result(p) for p in planes]
        counts = multihost.allgather_result(valid)
        flags = multihost.allgather_result(overflow)
        if flags.any():
            raise RuntimeError("slot overflow")
        got = [dist_sort.collect(r, counts) for r in rows]
        order = np.argsort(keys, kind="stable")
        if not np.array_equal(got[0], keys[order]):
            raise AssertionError("global sort mismatch")
        if args.pairs and not np.array_equal(got[1], vals[order]):
            raise AssertionError("payloads do not follow their keys")
        if args.rank == 0 and args.out:
            np.savez(args.out, *rows, valid=counts, overflow=flags)
        print(f"WORKER_OK rank={args.rank}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
