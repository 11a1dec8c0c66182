"""End-to-end query pipeline on the port's columnar Table API — the port of
examples/query_pipeline.py, with the same tables and the same checks.

Sales-style demo: filter rows, aggregate per store, join against a store
dimension table, sort the result; then top_k, distinct and a left join; then
the same query lazily, with one host sync.

    python -m radx_tpu_torch.examples.query_pipeline               # on the card
    python -m radx_tpu_torch.examples.query_pipeline --device cpu

On a CUDA device the lazy pipeline runs under
``torch.cuda.set_sync_debug_mode("error")``, which raises on any operation
that waits for the card (the counterpart of the JAX example's
``jax.transfer_guard_device_to_host("disallow")``); ``collect()`` is the one
sync, after the guard.  On the CPU nothing can wait for a device, so the
guard has nothing to watch and is not set.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from radx_tpu_torch.config import SortConfig
from radx_tpu_torch.ops.table import Table


@contextlib.contextmanager
def no_sync(device: torch.device):
    """Raise on any synchronising CUDA operation inside the block."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _store_sums(st, am, rt, n_stores):
    """NumPy reference: non-returned amount per store (int64)."""
    keep = rt == 0
    return np.bincount(st[keep], weights=am[keep].astype(np.float64),
                       minlength=n_stores).astype(np.int64)


def _not_returned(t) -> torch.Tensor:
    return t.column("returned").view(torch.int32) == 0


def run(n: int = 100_000, n_stores: int = 50, device="cuda",
        cfg: SortConfig | None = None, verbose: bool = False) -> dict:
    """Build the tables from numpy seed 0, run the eager and the lazy
    pipelines, check both against NumPy; returns row counts."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    st = rng.integers(0, n_stores, n).astype(np.uint32)
    am = rng.integers(1, 500, n).astype(np.uint32)
    rt = (rng.random(n) < 0.05).astype(np.uint32)
    sales = Table.from_arrays(store=st, amount=am, returned=rt, device=device)
    stores = Table.from_arrays(
        store=np.arange(n_stores, dtype=np.uint32),
        region=np.arange(n_stores, dtype=np.uint32) % 7, device=device)

    kept = sales.filter(_not_returned(sales), cfg=cfg)
    per_store = kept.groupby("store", "amount", "sum", cfg=cfg)
    with_region = per_store.join(stores, on="store", value="sum",
                                 other_value="region", cfg=cfg)
    top = with_region.sort_by("sum", descending=True, cfg=cfg)

    # selection + dedup operators on the same tables
    best3 = per_store.top_k("sum", 3, cfg=cfg)  # ORDER BY ... LIMIT 3
    regions = stores.distinct("region", cfg=cfg)  # SELECT DISTINCT
    assert best3.num_rows == 3 and regions.num_rows == 7
    # LEFT JOIN: stores with no sales still appear, with sum = 0
    all_stores = stores.join(per_store, on="store", value="region",
                             other_value="sum", how="left", cfg=cfg)
    assert all_stores.num_rows == stores.num_rows

    out = top.to_numpy()
    if verbose:
        print("top 5 stores by non-returned sales:")
        for i in range(min(5, top.num_rows)):
            print(f"  store {out['store'][i]:3d}  region {out['region'][i]}  "
                  f"total {out['sum'][i]}")

    # cross-check against NumPy
    want = _store_sums(st, am, rt, n_stores)
    present = np.unique(st[rt == 0])
    assert top.num_rows == present.size
    assert (want[out["store"]] == out["sum"]).all()
    assert (out["region"] == out["store"] % 7).all()
    assert (np.diff(out["sum"].astype(np.int64)) <= 0).all()
    b3 = best3.to_numpy()
    assert (b3["sum"] == np.sort(out["sum"])[::-1][:3]).all()
    left = all_stores.to_numpy()
    assert (left["sum"] == want[left["store"]]).all()

    # --- the same pipeline, lazily: one host sync -------------------------
    lt = sales.lazy(cfg)
    ls = stores.lazy(cfg)
    mask = _not_returned(sales)
    with no_sync(device):
        kept_l = lt.filter(mask)
        agg = kept_l.groupby("store", "amount", "sum")
        joined = agg.join(ls, on="store", value="sum", other_value="region")
        top_lazy = joined.sort_by("sum", descending=True)
    out_lazy = top_lazy.collect().to_numpy()  # <- the one sync
    for k in out:
        assert (out_lazy[k] == out[k]).all(), k
    if verbose:
        print("lazy pipeline: no sync until collect()"
              + (" — checked by torch.cuda.set_sync_debug_mode('error')"
                 if device.type == "cuda" else ""))

    # the filter -> groupby -> sort query as one function of a LazyTable,
    # on the first 16384 rows
    def query(t):
        kept = t.filter(_not_returned(t))
        return kept.groupby("store", "amount", "sum").sort_by(
            "sum", descending=True)

    m = min(n, 16384)
    slice_ = Table({k: sales.column(k)[:m] for k in ("store", "amount",
                                                     "returned")})
    with no_sync(device):
        q = query(slice_.lazy(cfg))
    lazy_out = q.collect().to_numpy()
    want_m = _store_sums(st[:m], am[:m], rt[:m], n_stores)
    assert (want_m[lazy_out["store"]] == lazy_out["sum"]).all()
    assert (np.diff(lazy_out["sum"].astype(np.int64)) <= 0).all()
    if verbose:
        print("verified against NumPy.")
    return {"rows": n, "stores": n_stores, "groups": top.num_rows,
            "kept": kept.num_rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--stores", type=int, default=50)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    run(args.rows, args.stores, args.device, verbose=True)


if __name__ == "__main__":
    main()
