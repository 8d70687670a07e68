"""On the card (``python -m pytest -m cuda evdbench/tests``): each cell's
run at its own size is correct and reports its metrics, and the same run
with the TF32 control in the entry's place comes out not correct."""
import json

import pytest

from bench_small import ROOT

from evdbench import harness

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, card):
    result, checks = harness.run_cell(name, 2 ** 31 + 101, 1.0, False)
    assert result["correct"] is True, checks
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    assert {m["name"] for m in harness.find_cell(name).end_to_end} == set(result["metrics"])


def test_control_fails_at_the_cells_size(card):
    name = "dense-fp32.tridiag.n4096"
    result, checks = harness.run_cell(name, 5, 0.1, False, entry="sytrd_tf32")
    assert result["correct"] is False, checks
    assert result["attempted"] >= harness.find_cell(name).traffic["check_samples"]
