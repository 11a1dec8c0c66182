"""Scaling model of the distributed sort (BASELINE config 5) on rates
measured on the card — the port of tools/scaling_model.py.

    python -m radx_tpu_torch.tools.scaling_model [--model] [--trace [PATH]] [--audit]
        [--device cuda] [--rates FILE] [--save FILE] [--L 8388608]

One card cannot measure a link, so, as the JAX tool did, the evidence for
config 5 is a model built from single-device rates plus link rates:

  * ``--model`` (the default): ``model(rates, links, L)`` — the weak- and
    strong-scaling table per device count D = 2..256, flat (D - 1 waves)
    and hierarchical ((Dr - 1) + (Dc - 1) waves) exchange, over each link
    of ``links``.  It is the JAX tool's arithmetic unchanged.  The rates
    come from ``measure_rates`` on the card (the local ``sort`` of
    permutation keys at L = 2^22 .. 2^30, and one level of the pairwise
    merge that merges a shard's arrivals, ``kernels/merge.merge_runs`` of
    two runs of 2^21 keys), each gated on its output and timed with CUDA
    events; the merge term charges ceil(log2 D) pairwise levels a shard,
    the levels the port runs (hier's two phases, Dr x Dc powers of two,
    have as many).  They are written to ``--save``
    (default ``.traces/scaling_rates.json``).  ``--rates FILE`` reads such
    a file instead, so the table prints without a card
    (``h100_rates.json`` beside this module is one, from an H100).
  * ``--audit``: ``sort_sharded`` on 8 shards of the one card, flat and
    hierarchical (4 x 2), under a transport that counts, per shard, the
    exchange waves, the bytes of each run a wave sends and the bytes it
    receives in one phase.  The model charges whole slots, the port sends
    runs at their own length: the counts must show the model's waves, no
    run above the model's block, no phase above its receive bytes, and an
    output row of exactly those bytes, or the tool exits 1.  Then one
    calibration line: the model's compute terms
    for that geometry, D x (t_sort(L) + t_merge), beside the measured wall
    time of the 8-shard mesh on the card, where every wave passes a block
    by reference and costs no transfer.
  * ``--trace [PATH]``: a Chrome trace (``utils.timing.trace``) of the
    warm 8-shard sort, 2^15 keys a shard (default
    ``.traces/dist_sort_8shard.json``).

The links are data: ``LINKS`` maps a name to (GB/s one way, seconds of
fixed cost a wave).  The defaults are an H100's fabric at the JAX tool's 75%
of the published rate; their per-wave costs are assumed (``LINK_SOURCES``).
Nothing here claims a scaling: the mesh on one card shares that card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import pathlib

import numpy as np
import torch

from radx_tpu_torch.parallel import dist_sort
from radx_tpu_torch.parallel.mesh import Mesh

CAPACITY = 4  # dist_sort's default slot capacity (x the mean run)
HEADROOM = 1.2  # the model's keys exchanged and merged a shard, h x L
DERATE = 0.75  # achievable share of a published link rate
# name -> (GB/s one way, seconds of fixed cost a wave)
LINKS = {
    "NVL": (450 * DERATE, 5e-6),
    "IB": (50 * DERATE, 15e-6),
}
LINK_SOURCES = {
    "NVL": "NVLink 4 within an H100 node: 900 GB/s both ways, 450 one way "
           "(NVIDIA H100 data sheet) x 0.75; per-wave 5 us ASSUMED (the "
           "order of NCCL's small-message send/recv latency over NVLink), "
           "not measured",
    "IB": "InfiniBand NDR between nodes, one 400 Gb/s adapter a GPU, 50 GB/s "
          "(NVIDIA ConnectX-7 / DGX H100 data sheets) x 0.75; per-wave 15 us "
          "ASSUMED (the order of NCCL's small-message send/recv latency "
          "across an InfiniBand hop), not measured",
}
DEVICE_COUNTS = (2, 4, 8, 16, 32, 64, 128, 256)
SORT_SIZES = tuple(1 << k for k in (22, 23, 24, 26, 28, 29, 30))
MERGE_RUN = 1 << 21  # the merge-level rate: two runs of 2^21 keys
DEFAULT_L = 1 << 23
MESH = 8  # shards of the one card in the audit, calibration and trace
TRACE_PER_SHARD = 1 << 15  # the JAX tool's trace size
DEFAULT_RATES = pathlib.Path(".traces") / "scaling_rates.json"
DEFAULT_TRACE = pathlib.Path(".traces") / "dist_sort_8shard.json"


def pow2pad(x) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def interp_rate(sort_rates: dict, L: int) -> float:
    """The local sort's G keys/s at L keys: linear in log2 L between the
    measured sizes, clamped to the ends."""
    ks = sorted(sort_rates)
    if L <= ks[0]:
        return sort_rates[ks[0]]
    if L >= ks[-1]:
        return sort_rates[ks[-1]]
    i = bisect.bisect_left(ks, L)
    a, b = ks[i - 1], ks[i]
    fa, fb = sort_rates[a], sort_rates[b]
    t = (math.log2(L) - math.log2(a)) / (math.log2(b) - math.log2(a))
    return fa + t * (fb - fa)


def phases(D: int, L: int, exchange: str, capacity: int = CAPACITY):
    """The exchange's phases at D shards of L keys: [(group size, slot
    keys)].  Flat: one phase of D; hier: the Dr x Dc factorisation of
    ``dist_sort._hier_factor``, a phase along each."""
    if exchange == "flat":
        return [(D, pow2pad(capacity * L / D))]
    d_r, d_c = dist_sort._hier_factor(D)
    return [(d_r, pow2pad(capacity * L / d_r)),
            (d_c, pow2pad(capacity * L / d_c))]


def geometry(D: int, L: int, exchange: str, capacity: int = CAPACITY) -> dict:
    """What the model says one shard of a keys-only sort moves: the waves
    of each phase, the bytes of the block a wave sends in each phase
    (slot x 4) and the receive footprint (the power-of-two number of runs
    the merge holds x slot x 4, the larger phase)."""
    ph = phases(D, L, exchange, capacity)
    return {"waves": [g - 1 for g, _ in ph],
            "block_bytes": [slot * 4 for _, slot in ph],
            "recv_bytes": max(pow2pad(g) * slot for g, slot in ph) * 4}


def model(rates: dict, links: dict | None = None, L: int = DEFAULT_L,
          capacity: int = CAPACITY, headroom: float = HEADROOM) -> list:
    """Weak / strong scaling rows at L keys a shard, keys only (4 B a key).

    ``rates``: {"sort": {L: G keys/s}, "merge_per_level": G keys/s};
    ``links``: {name: (GB/s, per-wave seconds)}.  A row: D, link,
    exchange, waves, t_sort / t_exch / t_merge / t_total seconds, the
    weak and strong efficiencies, bytes on the wire a key and the receive
    buffer's bytes."""
    links = LINKS if links is None else links
    sort_rates, r_merge = rates["sort"], rates["merge_per_level"]
    t1 = L / (interp_rate(sort_rates, L) * 1e9)
    rows = []
    for link, (bw, t_wave) in links.items():
        for D in DEVICE_COUNTS:
            t_merge = math.ceil(math.log2(D)) * headroom * L / (r_merge * 1e9)
            t1_total = (D * L) / (interp_rate(sort_rates, D * L) * 1e9)
            for exchange in ("flat", "hier") if D >= 4 else ("flat",):
                geo = geometry(D, L, exchange, capacity)
                t_exch = sum(w * (b / (bw * 1e9) + t_wave) for w, b in
                             zip(geo["waves"], geo["block_bytes"]))
                # each key crosses the wire once a phase
                exch_bytes = len(geo["waves"]) * headroom * L
                t_total = t1 + max(t_exch, t_merge) + min(t_exch, t_merge) * 0.2
                rows.append({
                    "D": D, "link": link, "exchange": exchange,
                    "waves": sum(geo["waves"]), "t_sort": t1,
                    "t_exch": t_exch, "t_merge": t_merge, "t_total": t_total,
                    "eff_w": t1 / t_total, "eff_s": t1_total / (D * t_total),
                    "bytes_per_key": 4 * exch_bytes / L,
                    "recv_bytes": geo["recv_bytes"],
                })
    return rows


def table(rows: list, L: int) -> list[str]:
    """The rows as the JAX tool prints them (its header and columns)."""
    lines = [f"weak-scaling model, L = {L} keys/device (keys-only, 4 B/key)",
             f"{'D':>4} {'link':>5} {'exch':>5} {'waves':>5} {'t_sort':>8} "
             f"{'t_exch':>8} {'t_merge':>8} {'t_total':>8} {'eff_w':>6} "
             f"{'eff_s':>6} {'B/key':>6} {'recvMB':>7}"]
    for r in rows:
        lines.append(
            f"{r['D']:>4} {r['link']:>5} {r['exchange']:>5} {r['waves']:>5} "
            f"{r['t_sort']*1e3:8.2f} {r['t_exch']*1e3:8.2f} "
            f"{r['t_merge']*1e3:8.2f} {r['t_total']*1e3:8.2f} "
            f"{r['eff_w']:6.1%} {r['eff_s']:6.1%} {r['bytes_per_key']:6.1f} "
            f"{r['recv_bytes']/1e6:7.1f}")
    return lines


# --- on the card ----------------------------------------------------------------


def _card(device) -> torch.device:
    """The CUDA device to measure on; raises without one (no CPU
    fallback: a rate is a measurement of the card)."""
    from radx_tpu_torch.utils import timing

    dev = timing.require_cuda() if device is None else torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"rates are measured on a CUDA device, not {dev}")
    return dev


def _permutation(n: int, gen) -> torch.Tensor:
    return torch.randperm(n, generator=gen, device=gen.device).to(torch.int32)


def measure_rates(device=None) -> dict:
    """The model's rates measured on the card: ``radx_tpu_torch.sort`` of
    permutation keys at each L of ``SORT_SIZES`` (G keys/s), and one
    pairwise merge level, ``merge_runs`` of two ascending runs of a
    permutation of 2 x ``MERGE_RUN`` keys into the output, un-biasing the
    keys as the distributed sort's last merge does (G keys/s).  Each output
    is checked first (the sort against 0 .. L-1, the merge against
    ``torch.sort``), then timed with CUDA events (``utils.timing.time_op``:
    the least of the repeats), after a warm-up of at least 2^28 keys: a
    fresh process finds the card below its clocks.  A merge of 2^22 keys
    takes tens of microseconds, so it runs 32 times a repeat."""
    from radx_tpu_torch import sort, tuned
    from radx_tpu_torch.kernels import merge
    from radx_tpu_torch.utils import timing

    dev = _card(device)
    cfg = tuned()
    gen = torch.Generator(device=dev).manual_seed(0)
    sort_rates = {}
    for L in SORT_SIZES:
        keys = _permutation(L, gen).view(torch.uint32)
        if not torch.equal(sort(keys, cfg).view(torch.int32),
                           torch.arange(L, dtype=torch.int32, device=dev)):
            raise RuntimeError(f"sort of {L} permutation keys is wrong")
        iters = max(1, min(8, (1 << 26) // L))
        m = timing.time_op(lambda k: sort(k, cfg), keys, name=f"sort {L}",
                           iters=iters, repeats=5 if L <= 1 << 26 else 3,
                           warmup=max(2, (1 << 28) // L))
        sort_rates[L] = m.items_per_s / 1e9
        del keys
        torch.cuda.empty_cache()
    x = _permutation(2 * MERGE_RUN, gen)
    a, b = ([torch.sort(r).values] for r in x.chunk(2))
    out = torch.empty_like(x)

    def level(o):
        merge.merge_runs(a, b, 1, out=[o], key_xor=-(1 << 31))

    level(out)
    if not torch.equal(out ^ (-(1 << 31)), torch.sort(x).values):
        raise RuntimeError("merge_runs of the two runs is wrong")
    m = timing.time_op(level, out, name="merge level", iters=32, repeats=5,
                       warmup=32)
    info = timing.device_info()
    return {"sort": sort_rates, "merge_per_level": m.items_per_s / 1e9,
            "card": info["name"], "nvidia_smi": info["nvidia_smi"]}


def save_rates(rates: dict, path) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    out = dict(rates, sort={str(k): v for k, v in rates["sort"].items()})
    path.write_text(json.dumps(out, indent=1) + "\n")


def load_rates(path) -> dict:
    """Rates written by ``save_rates`` (an earlier measuring run)."""
    rates = json.loads(pathlib.Path(path).read_text())
    rates["sort"] = {int(k): float(v) for k, v in rates["sort"].items()}
    return rates


class CountingTransport:
    """A mesh transport that counts what the exchange moves, per shard and
    phase: the waves, the bytes of each run a wave sends, and the bytes the
    shard receives.  A phase ends at the wave that pairs the shard with the
    peers of the phase's first wave swapped (the last shift of a group
    sends where the first one received from).  Everything else passes
    through."""

    def __init__(self, inner):
        self.inner = inner
        self.whole, self.size, self.local = inner.whole, inner.size, inner.local
        self.phases = {i: [] for i in self.local}  # closed phases a shard
        self.open = dict.fromkeys(self.local)

    def device(self, i):
        return self.inner.device(i)

    def all_gather(self, parts):
        return self.inner.all_gather(parts)

    def max(self, parts):
        return self.inner.max(parts)

    def wave(self, sends):
        got = self.inner.wave(sends)
        for i, (dst, src, planes, _rows), recv in zip(self.local, sends, got):
            ph = self.open[i]
            if ph is None:
                ph = self.open[i] = {"first": (dst, src), "waves": 0,
                                     "block_bytes": [], "recv_bytes": 0}
            ph["waves"] += 1
            ph["block_bytes"].append(sum(p.numel() * p.element_size()
                                         for p in planes))
            ph["recv_bytes"] += sum(p.numel() * p.element_size()
                                    for p in recv)
            if (dst, src) == ph["first"][::-1]:
                del ph["first"]
                self.phases[i].append(ph)
                self.open[i] = None
        return got


class _CountingMesh(Mesh):
    """A mesh whose transport is counted (the last one made is
    ``counter``)."""

    def transport(self):
        self.counter = CountingTransport(super().transport())
        return self.counter


def audit(D: int = MESH, L: int = DEFAULT_L, exchange: str = "flat", *,
          device=None) -> dict:
    """Run ``sort_sharded`` of D x L permutation keys on a mesh of D
    shards of one device (default CUDA) under ``CountingTransport``,
    check the sort, and return the counted numbers beside the model's
    (``geometry``).  The model charges whole slots; the port sends each
    run at its own length, so ``agrees`` holds where every shard counted
    the model's waves, no run above the model's block, at most the
    model's receive bytes in a phase, and the output row (n_runs x slot
    keys, the merge's footprint that the model charges) of exactly the
    model's receive bytes.  ``counted``: the largest of each number over
    the shards."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    keys = _permutation(D * L, gen).view(torch.uint32)
    mesh = _CountingMesh([dev] * D)
    rows, valid, overflow = dist_sort.sort_sharded(keys, mesh,
                                                   exchange=exchange)
    got = dist_sort.collect(rows, valid)
    if bool(overflow.any()) or not np.array_equal(
            got, np.arange(D * L, dtype=np.uint32)):
        raise RuntimeError(f"sort_sharded ({exchange}, D = {D}) is wrong")
    want = geometry(D, L, exchange)
    c = mesh.counter
    shards = [c.phases[i] for i in c.local]
    counted = {
        "waves": [p["waves"] for p in shards[0]],
        "block_bytes": [max(max(ph[p]["block_bytes"]) for ph in shards)
                        for p in range(len(shards[0]))],
        "recv_bytes": max(p["recv_bytes"] for ph in shards for p in ph),
        "phase_open": any(c.open[i] is not None for i in c.local)}
    row_bytes = rows.shape[1] * rows.element_size()
    agrees = (all([p["waves"] for p in ph] == want["waves"] for ph in shards)
              and all(b <= w for b, w in zip(counted["block_bytes"],
                                             want["block_bytes"]))
              and counted["recv_bytes"] <= want["recv_bytes"]
              and row_bytes == want["recv_bytes"]
              and not counted["phase_open"])
    return {"D": D, "L": L, "exchange": exchange, "device": str(dev),
            "counted": counted, "row_bytes": row_bytes, "model": want,
            "agrees": agrees}


def calibrate(rates: dict, L: int = DEFAULT_L, device=None) -> dict:
    """The model's compute terms for ``MESH`` shards of L keys, D x
    (t_sort(L) + t_merge), beside the wall time of the flat exchange's
    mesh on one card (CUDA events around ``sort_sharded``, least of 3),
    where the shards run one after another and a wave moves nothing.  A
    reading, not a gate: the ratio says how far the model's ``HEADROOM x
    L`` merge term is from the port's merge of the runs at their own
    length (and the output row's pads)."""
    from radx_tpu_torch.utils import timing

    dev = _card(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    keys = _permutation(MESH * L, gen).view(torch.uint32)
    mesh = Mesh([dev] * MESH)
    t = timing.time_cuda(lambda: dist_sort.sort_sharded(keys, mesh),
                         iters=1, repeats=3, warmup=1)
    t_sort = L / (interp_rate(rates["sort"], L) * 1e9)
    t_merge = (math.ceil(math.log2(MESH)) * HEADROOM * L
               / (rates["merge_per_level"] * 1e9))
    modelled = MESH * (t_sort + t_merge)
    return {"D": MESH, "L": L, "exchange": "flat", "t_sort_s": t_sort,
            "t_merge_s": t_merge, "modelled_s": modelled,
            "measured_s": t.seconds, "spread_pct": t.spread_pct,
            "measured_over_modelled": t.seconds / modelled}


def trace(path=DEFAULT_TRACE, device=None):
    """A Chrome trace of ``sort_sharded`` on ``MESH`` shards of one card,
    ``TRACE_PER_SHARD`` uniform keys each (numpy seed 0), warm; returns
    the path."""
    from radx_tpu_torch.utils import timing

    dev = _card(device)
    keys = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2**32, MESH * TRACE_PER_SHARD, dtype=np.uint32)).to(dev)
    mesh = Mesh([dev] * MESH)
    dist_sort.sort_sharded(keys, mesh)
    torch.cuda.synchronize()
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with timing.trace(path):
        dist_sort.sort_sharded(keys, mesh)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", action="store_true")
    ap.add_argument("--trace", nargs="?", const=str(DEFAULT_TRACE))
    ap.add_argument("--audit", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--rates", default=None,
                    help="JSON of rates from an earlier run (no measuring)")
    ap.add_argument("--save", default=str(DEFAULT_RATES),
                    help="where a measuring run writes its rates")
    ap.add_argument("--L", type=int, default=DEFAULT_L)
    args = ap.parse_args(argv)
    do_model = args.model or not (args.trace or args.audit)
    on_card = args.device is None or torch.device(args.device).type == "cuda"
    rates = None
    if do_model or (args.audit and on_card):
        if args.rates:
            rates = load_rates(args.rates)
            print(f"rates from {args.rates}")
        else:
            rates = measure_rates(args.device)
            save_rates(rates, args.save)
            print(f"rates measured, written to {args.save}")
        print(f"card: {rates['card']}; nvidia-smi: {rates['nvidia_smi']}")
        print("rates (G keys/s): sort " + json.dumps(
            {str(k): v for k, v in rates["sort"].items()})
            + f"; merge level {rates['merge_per_level']}")
    if do_model:
        for name, (bw, t_wave) in LINKS.items():
            print(f"link {name}: {bw} GB/s, {t_wave * 1e6:g} us a wave "
                  f"({LINK_SOURCES[name]})")
        print("\n".join(table(model(rates, L=args.L), args.L)))
    rc = 0
    if args.audit:
        for exchange in ("flat", "hier"):
            a = audit(MESH, args.L, exchange, device=args.device)
            print("audit " + json.dumps(a))
            if not a["agrees"]:
                print(f"FAIL: the counted exchange ({exchange}) departs "
                      "from the model's")
                rc = 1
        if on_card:
            print("calibration " + json.dumps(
                calibrate(rates, args.L, device=args.device)))
    if args.trace:
        print(f"trace written to {trace(args.trace, device=args.device)}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
