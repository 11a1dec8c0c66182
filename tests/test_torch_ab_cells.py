"""radx_tpu_torch/tools/ab_cells.py: the runs in turns and their summary,
against two fake checkouts whose ``benchmark.run`` prints a fixed last line
(no card, no JAX)."""

import json
import subprocess
import sys

import pytest

from radx_tpu_torch.tools import ab_cells

FAKE_RUN = """import json, sys
rate = {rate}
print(json.dumps({{"ok": {ok}, "workloads": {{"q3": {{
    "correct": {ok}, "rows_per_s": rate, "peak_device_gib": {peak}}}}}}}))
sys.exit({rc})
"""


def _checkout(root, rate, peak, ok=True, rc=0):
    (root / "benchmark").mkdir(parents=True)
    (root / "benchmark" / "__init__.py").write_text("")
    (root / "benchmark" / "run.py").write_text(
        FAKE_RUN.format(rate=rate, peak=peak, ok=ok, rc=rc))
    return str(root)


def _runs(rates, peak=1.0):
    return [{"q3": {"rows_per_s": r, "peak_device_gib": peak}} for r in rates]


def test_summarize_gain_needs_nine_tenths_and_the_spread():
    parent = _runs([100, 101, 99, 100, 100, 102, 98, 100, 100, 100], 5.0)
    change = _runs([130, 131, 129, 130, 99, 130, 130, 130, 130, 130], 4.0)
    s = ab_cells.summarize(parent, change)["q3"]
    assert s["pairs"] == 10 and s["change_wins"] == 9
    assert s["parent_rows_per_s"]["median"] == 100
    assert s["change_over_parent"] == pytest.approx(1.3)
    assert s["gain"]
    assert (s["parent_peak_gib"], s["change_peak_gib"]) == (5.0, 4.0)
    # eight wins of ten: no gain, whatever the medians
    change[3] = _runs([90])[0]
    assert not ab_cells.summarize(parent, change)["q3"]["gain"]
    # within the parent's own spread: no gain
    wide = _runs([80, 120, 80, 120, 100, 80, 120, 100, 100, 100])
    near = _runs([x + 1 for x in (80, 120, 80, 120, 100, 80, 120, 100, 100,
                                  100)])
    assert not ab_cells.summarize(wide, near)["q3"]["gain"]


def test_cli_runs_in_turns(tmp_path):
    parent = _checkout(tmp_path / "parent", 100.0, 5.0)
    change = _checkout(tmp_path / "change", 130.0, 4.0)
    out = subprocess.run(
        [sys.executable, ab_cells.__file__, "--parent",
         parent, "--change", change, "--cells", "q3", "--pairs", "3",
         "--out", str(tmp_path / "logs")],
        capture_output=True, text=True, check=True).stdout.splitlines()
    lines = [json.loads(x) for x in out]
    assert [(x["pair"], x["side"]) for x in lines[:6]] == [
        (0, "parent"), (0, "change"), (1, "change"), (1, "parent"),
        (2, "parent"), (2, "change")]
    assert lines[-1]["cell"] == "q3" and lines[-1]["change_wins"] == 3
    assert len(list((tmp_path / "logs").iterdir())) == 6


def test_cli_fails_on_a_failed_run(tmp_path):
    parent = _checkout(tmp_path / "parent", 100.0, 5.0)
    change = _checkout(tmp_path / "change", 130.0, 4.0, ok=False, rc=1)
    proc = subprocess.run(
        [sys.executable, ab_cells.__file__, "--parent",
         parent, "--change", change, "--cells", "q3", "--pairs", "1"],
        capture_output=True, text=True)
    assert proc.returncode == 1 and "failed" in proc.stderr
