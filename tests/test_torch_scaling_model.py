"""The port's scaling model of config 5 (radx_tpu_torch/tools/scaling_model.py)
against the JAX tool (tools/scaling_model.py, loaded from its path; it needs
no JAX), and its exchange audit on meshes of CPU shards.

  * parity: fed the JAX tool's own rates, link rates and per-wave times,
    ``model`` prints the JAX table line for line (tolerance 0: the same
    text);
  * audit: ``sort_sharded`` under the counting transport at D = 4, 8, 16,
    flat and hierarchical, counts the model's waves, runs within its bytes
    a wave and phases within its receive bytes, and an output row of those
    bytes; where the port's slot floor (128 keys) departs from the model's
    formula, the audit says so;
  * the rates are measured on a card only; a rates file prints the table
    without one.
"""

import importlib.util
import json
import math
import pathlib

import pytest
import torch

from radx_tpu_torch.tools import scaling_model as sm

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_scaling_model", ROOT / "tools" / "scaling_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_model_prints_the_jax_table(jax_tool, capsys):
    jax_tool.model()
    want = capsys.readouterr().out.splitlines()
    rates = {"sort": dict(jax_tool.R_SORT),
             "merge_per_level": jax_tool.R_MERGE_PER_LEVEL}
    # the JAX tool's links and its assumed per-wave times, as arguments
    links = {"ICI": (jax_tool.ICI_V5E, 10e-6), "DCN": (jax_tool.DCN, 100e-6)}
    rows = sm.model(rates, links, L=1 << 23, capacity=4,
                    headroom=jax_tool.CAPACITY_OVER_MEAN)
    print("\n".join(sm.table(rows, 1 << 23)))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 2 + 2 * (8 + 7)
    assert got == want


def test_merge_passes_are_the_ports():
    """The merge term charges the pairwise levels the port runs a shard:
    ceil(log2 D) of ``merge_runs`` over the group of D runs, and as many
    for hier's two phases (Dr x Dc = D, powers of two), each a level of
    HEADROOM x L keys at the measured rate."""
    rates = {"sort": {1 << 23: 5.0}, "merge_per_level": 50.0}
    rows = {(r["D"], r["exchange"]): r for r in
            sm.model(rates, {"NVL": (300.0, 5e-6)}, L=1 << 23)}
    one = sm.HEADROOM * (1 << 23) / 50e9
    for D in sm.DEVICE_COUNTS:
        assert rows[D, "flat"]["t_merge"] == pytest.approx(
            math.log2(D) * one)
        if D >= 4:
            d_r, d_c = sm.dist_sort._hier_factor(D)
            assert rows[D, "hier"]["t_merge"] == pytest.approx(
                (math.log2(d_r) + math.log2(d_c)) * one)


def test_interp_rate_matches_jax(jax_tool):
    for L in (1 << 20, 1 << 22, 3 << 22, 1 << 25, 1 << 26, 1 << 31):
        assert sm.interp_rate(jax_tool.R_SORT, L) == jax_tool.interp_rate(L)


@pytest.mark.parametrize("exchange", ["flat", "hier"])
@pytest.mark.parametrize("n_dev", [4, 8, 16])
def test_audit_counts_the_model(n_dev, exchange):
    """1024 keys a shard: every slot above the port's 128-key floor.  The
    waves and the output row are the model's; the runs travel at their own
    length, so each block is at most the model's slot and about the mean
    run, and a phase receives at most the model's footprint."""
    a = sm.audit(n_dev, 1024, exchange, device="cpu")
    want = sm.geometry(n_dev, 1024, exchange)
    assert a["model"] == want
    assert a["counted"]["waves"] == want["waves"]
    assert a["row_bytes"] == want["recv_bytes"]
    phases = sm.phases(n_dev, 1024, exchange)
    for got, bound, (group, _) in zip(a["counted"]["block_bytes"],
                                      want["block_bytes"], phases):
        assert 1024 * 4 // group <= got <= bound
    assert a["counted"]["recv_bytes"] <= want["recv_bytes"]
    assert a["agrees"] and not a["counted"]["phase_open"]
    f = sm.dist_sort._hier_factor(n_dev)
    total = n_dev - 1 if exchange == "flat" else f[0] + f[1] - 2
    assert sum(a["counted"]["waves"]) == total


def test_audit_reports_a_departure_from_the_model():
    """At 64 keys a shard over 4 shards the model's slot is 4 x 64 / 4 = 64
    keys; the port's slots are at least 128 (``dist_sort.MIN_SLOT``), so
    its output row is twice the model's receive footprint, while every run
    stays within the model's block."""
    a = sm.audit(4, 64, "flat", device="cpu")
    assert not a["agrees"]
    assert a["model"]["block_bytes"] == [64 * 4]
    assert a["counted"]["block_bytes"][0] <= 64 * 4
    assert a["row_bytes"] == 4 * 128 * 4 == 2 * a["model"]["recv_bytes"]


def test_rates_are_measured_on_a_card_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sm.measure_rates()
    with pytest.raises(RuntimeError):
        sm.measure_rates("cpu")
    with pytest.raises(RuntimeError):
        sm.trace("unused.json")


def test_rates_file_prints_the_table_without_a_card(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rates = {"sort": {1 << 22: 6.0, 1 << 26: 5.0, 1 << 30: 4.0},
             "merge_per_level": 30.0, "card": "NVIDIA H100 80GB HBM3",
             "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}
    path = tmp_path / "rates.json"
    sm.save_rates(rates, path)
    assert json.loads(path.read_text())["sort"]["4194304"] == 6.0
    assert sm.load_rates(path) == rates
    assert sm.main(["--model", "--rates", str(path), "--L", "4194304"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "card: NVIDIA H100 80GB HBM3; nvidia-smi: NVIDIA H100 80GB HBM3, " \
        "700.00 W" in out
    for name in sm.LINKS:
        assert any(ln.startswith(f"link {name}:") and "ASSUMED" in ln
                   for ln in out)
    table = sm.table(sm.model(rates, L=1 << 22), 1 << 22)
    assert out[-len(table):] == table
    assert len(table) == 2 + len(sm.LINKS) * (8 + 7)


def test_audit_command_on_cpu_shards(capsys):
    """``--audit --device cpu``: flat and hier at D = 8, no rates needed
    (the calibration reads the card and is skipped on the CPU)."""
    assert sm.main(["--audit", "--device", "cpu", "--L", "1024"]) == 0
    lines = [json.loads(ln.split(" ", 1)[1]) for ln in
             capsys.readouterr().out.splitlines() if ln.startswith("audit ")]
    assert [a["exchange"] for a in lines] == ["flat", "hier"]
    assert all(a["agrees"] and a["D"] == 8 for a in lines)


def test_the_committed_h100_rates_print_the_table(capsys):
    """``tools/h100_rates.json``, measured by this tool on an H100, holds
    every size the tool measures and prints the table on the CPU."""
    path = pathlib.Path(sm.__file__).with_name("h100_rates.json")
    rates = sm.load_rates(path)
    assert set(rates["sort"]) == set(sm.SORT_SIZES)
    assert rates["card"].startswith("NVIDIA H100") and "W" in rates[
        "nvidia_smi"]
    assert sm.main(["--rates", str(path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-len(sm.LINKS) * 15 - 2].startswith("weak-scaling model")
