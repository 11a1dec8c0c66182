"""Sweep the port's tiles on the current card and print a ``TUNING`` row for
it — the port of tools/autotune.py.

    python -m radx_tpu_torch.tools.autotune [log2n] [--json out.json]

Runs every group of ``bench.sweep_tiles`` at n = 2^log2n keys (default
26), each result gated before it is timed, and picks the tiles of each
tunable (``PICKED``) by the time of its metrics, summed where there are
two.  The fastest tiles replace the ``SortConfig`` default only where they
beat the default's time by more than the larger of the two spreads of the
repeats; otherwise the default stays.  The optima of the metrics in
``REPORTED`` are printed beside the picks and decide nothing: the radix
sort shares the keys-only tiles, and the join's union and ``sort_multi``
sort their two compare planes on the stable tiles (then gather their
value planes), which the stable sorts pick.

Prints one line per swept row, then one JSON object: ``device_kind``,
``tuning_entry`` (the row for ``radx_tpu_torch.config.TUNING``), and per
tunable its default, winner and pick with their times.
"""

from __future__ import annotations

import argparse
import json

from radx_tpu_torch import bench
from radx_tpu_torch.config import SortConfig, device_kind

_KEYS = ("chunk_elems", "finish_elems")
_RIDER = ("rider_chunk_elems", "rider_finish_elems")
_STABLE = ("stable_chunk_elems", "stable_finish_elems")

# tunable -> (metrics whose times are summed, SortConfig fields)
PICKED = {
    "keys": (("sort_u32_keys_per_s",), _KEYS),
    "rider": (("groupby_sum_rows_per_s",), _RIDER),
    "lex2_lex3": (("argsort_rows_per_s", "sort_pairs_u32_pairs_per_s"),
                  _STABLE),
    "topk": (("top_k_k1024_keys_per_s",), ("topk_chunk_elems",)),
}
REPORTED = {
    "radix": (("sort_radix_u32_keys_per_s",), _KEYS),
    "lex2_join": (("join_union_sort_rows_per_s",), _STABLE),
    **{f"sort_multi_{m}": ((f"sort_multi_{m}_payloads_rows_per_s",),
                            _STABLE)
       for m in range(3, 7)},
}
GROUPS = ("keys", "radix", "rider", "lex", "lex_wide", "topk")


def _times(rows, metrics, fields) -> dict:
    """tiles -> (summed ms, largest spread) over the rows of ``metrics``,
    for the tiles that every one of them measured."""
    acc: dict = {}
    for r in rows:
        base = r["metric"].rsplit("_n", 1)[0]
        if base in metrics:
            tiles = tuple(r[f] for f in fields)
            ms, spread, k = acc.get(tiles, (0.0, 0.0, 0))
            acc[tiles] = (ms + r["ms"], max(spread, r["spread_pct"]), k + 1)
    return {t: (ms, sp) for t, (ms, sp, k) in acc.items() if k == len(metrics)}


def pick(rows, metrics, fields, default: SortConfig | None = None) -> dict:
    """The default tiles, the fastest tiles and the pick: the fastest where
    they beat the default by more than the larger spread, else the
    default."""
    times = _times(rows, metrics, fields)
    if not times:
        raise ValueError(f"no sweep rows for {metrics}")
    default = default or SortConfig()
    d_tiles = tuple(getattr(default, f) for f in fields)
    win = min(times, key=lambda t: times[t][0])
    out = {"fields": list(fields), "default": list(d_tiles),
           "winner": list(win), "winner_ms": times[win][0],
           "winner_spread_pct": times[win][1]}
    chosen = win
    if d_tiles in times:
        d_ms, d_sp = times[d_tiles]
        gain = 100.0 * (d_ms / times[win][0] - 1)
        out.update(default_ms=d_ms, default_spread_pct=d_sp, gain_pct=gain)
        if gain <= max(d_sp, times[win][1]):
            chosen = d_tiles
    out["pick"] = list(chosen)
    return out


def tune(rows) -> dict:
    """The TUNING row and the picks of a sweep's rows."""
    picks = {k: pick(rows, *v) for k, v in PICKED.items()}
    entry = {f: v for p in picks.values() for f, v in zip(p["fields"],
                                                          p["pick"])}
    reported = {k: pick(rows, *v) for k, v in REPORTED.items()
                if _times(rows, *v)}
    return {"tuning_entry": entry, "picked": picks, "reported": reported}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log2n", nargs="?", type=int, default=26)
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    rows = bench.sweep_tiles(1 << args.log2n, GROUPS)
    for r in rows:
        print(json.dumps({k: v for k, v in r.items() if k != "device"}),
              flush=True)
    result = {"device_kind": device_kind(), "n": 1 << args.log2n,
              "nvidia_smi": rows[0]["device"]["nvidia_smi"], **tune(rows)}
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
