"""The distributed sort at 16 and 32 shards — the port of
tools/dryrun_scale.py.

    python -m radx_tpu_torch.tools.dryrun_scale [D ...] [--device cpu] [--per-device K]

Runs ``parallel.dryrun.dryrun_multichip`` at each D (default 16 and 32):
an in-process mesh of D shards, all on ``--device`` (default CUDA; ``cpu``
is the counterpart of the JAX tool's CPU backend with D virtual devices),
``--per-device`` keys a shard (default 2^13, the JAX tool's), sorted with
the flat exchange and with the hierarchical one, then stable pairs; every
result bit-exact against numpy, or it raises.  Prints one line per D and
exchange with its waves, then ``DRYRUN_SCALE_OK``.
"""

from __future__ import annotations

import argparse

from radx_tpu_torch.parallel import dist_sort
from radx_tpu_torch.parallel.dryrun import dryrun_multichip


def waves(n_dev: int, exchange: str) -> int:
    """Exchange waves of one sort: D - 1 flat; Dr + Dc - 2 hier."""
    f = dist_sort._hier_factor(n_dev) if exchange == "hier" else None
    return n_dev - 1 if f is None else f[0] + f[1] - 2


def run(n_dev: int, device=None, per_device: int = 1 << 13) -> None:
    dryrun_multichip(n_dev, device, per_device)
    for exchange in ("flat", "hier"):
        print(f"D={n_dev:3d} exchange={exchange:4s} "
              f"waves={waves(n_dev, exchange):3d} n={per_device * n_dev} "
              "OK bit-exact", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("devices", nargs="*", type=int, default=[16, 32])
    ap.add_argument("--device", default=None)
    ap.add_argument("--per-device", type=int, default=1 << 13)
    args = ap.parse_args(argv)
    for d in args.devices:
        run(d, args.device, args.per_device)
    print("DRYRUN_SCALE_OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
