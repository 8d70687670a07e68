"""The harness on the CPU: runs of each cell at small sizes on the port's
plain versions, a cell added as files only, the trace reduction on a
synthetic trace, the result line, and a run that finds no card."""
import hashlib
import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from bench_small import ROOT, small_cell

from evdbench import harness, trace

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_small_run_of_each_cell(name, traced, cpu):
    cell = small_cell(name)
    result, checks = harness.run_cell(name, 2 ** 31 + 11, 0.5, traced, device=cpu, cell=cell)
    assert RESULT_KEYS <= set(result) and list(result)[-1] == "checks"
    assert result["correct"] is True and result["attempted"] >= 1
    assert set(checks) == set(cell.limits) and all(c["value"] <= c["limit"] for c in checks.values())
    wanted = cell.per_layer if traced else cell.end_to_end
    for m in wanted:
        if traced and m["source"] == "device_trace" and "idle" in m["name"]:
            continue  # a CPU run traces no device operation
        assert result["metrics"][m["name"]]["unit"] == m["unit"]
        assert result["metrics"][m["name"]]["value"] >= 0
    assert set(result["metrics"]) <= {m["name"] for m in wanted}
    assert result["device"]["platform"] == "cpu"
    if traced:
        assert result["device"]["window_s"] > 0 and "breakdown" in result


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_as_files_only(tmp_path, cpu):
    shutil.copytree(ROOT / "evdbench", tmp_path / "evdbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "evdbench")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    traffic = json.loads((tmp_path / "evdbench/traffic/tridiag.n4096.json").read_text())
    (tmp_path / "evdbench/traffic/tridiag.n48.json").write_text(json.dumps(dict(traffic, n=48, pool=2)))
    limits = (tmp_path / "evdbench/limits/dense-fp32.tridiag.n4096.json").read_text()
    (tmp_path / "evdbench/limits/dense-fp32.tridiag.n48.json").write_text(limits)
    name = "dense-fp32.tridiag.n48"
    spec["workloads"].append({"name": name, "config": "dense-fp32", "traffic": "tridiag.n48", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "dense-fp32.tridiag.n4096" in m.get("workloads", []) and m["name"] != "solve_p95_ms":
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(tmp_path / "evdbench")
    assert {k: after[k] for k in before} == before  # no file that was there changed

    cell = harness.find_cell(name, tmp_path)
    assert cell.traffic["n"] == 48
    result, _ = harness.run_cell(name, 7, 0.3, False, device=cpu, root=tmp_path)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"solve_ms", "setup_s"}
    result, _ = harness.run_cell(name, 7, 0.3, True, device=cpu, root=tmp_path)
    assert {"band_reduce_ms", "chase_ms", "kernel_launches.solve"} <= set(result["metrics"])


def test_missing_files_are_named(tmp_path):
    with pytest.raises(FileNotFoundError, match="no entries file 'nope'"):
        harness.load_module("entries", "nope", tmp_path)
    with pytest.raises(KeyError, match="no workload"):
        harness.find_cell("no.such.cell")


def test_idle_share_and_breakdown_of_a_synthetic_trace():
    ms = 1_000_000
    tr = trace.Trace(
        window=(0, 100 * ms),
        device=[trace.DeviceOp(10 * ms, 20 * ms, "void ns::kernel_a<float, 8>(float*, int)", 1),
                trace.DeviceOp(15 * ms, 30 * ms, "kernel_b", 2),
                trace.DeviceOp(50 * ms, 60 * ms, "void ns::kernel_a<float, 8>(float*, int)", 3),
                trace.DeviceOp(95 * ms, 120 * ms, "kernel_c", 4),     # runs past the window
                trace.DeviceOp(130 * ms, 140 * ms, "kernel_d", 5)],   # after it
        host=[trace.HostOp(0, 100 * ms, "outer"),
              trace.HostOp(2 * ms, 12 * ms, "aten::first"),
              trace.HostOp(5 * ms, 6 * ms, "cudaLaunchKernel", True, 1),
              trace.HostOp(16 * ms, 17 * ms, "cudaLaunchKernel", True, 2),
              trace.HostOp(40 * ms, 48 * ms, "aten::second"),
              trace.HostOp(45 * ms, 46 * ms, "cudaLaunchKernel", True, 3),
              trace.HostOp(70 * ms, 71 * ms, "cudaLaunchKernel", True, 4)],
    )
    s = trace.summarize(tr)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.035)  # 10-30, 50-60, 95-100
    assert dict(s.device_ops) == pytest.approx({"ns::kernel_a": 0.02, "kernel_b": 0.015, "kernel_c": 0.005})
    assert dict(s.idle_gaps) == pytest.approx({"aten::first": 0.010, "aten::second": 0.020, "outer": 0.035})
    read = harness.load_module("metrics", "device_idle_pct.solve").read
    run = harness.Run(0, 0.1, 1, [0.1], {}, {}, {}, s)
    assert read(run) == pytest.approx(65.0)
    run.trace = trace.Summary(0.0, 0.1, [], [])
    assert read(run) is None  # no device operation traced: nothing to read


def _main(monkeypatch, result, checks, bad=()):
    spec = harness.importlib.util.spec_from_file_location("evdbench_run", ROOT / "evdbench" / "run.py")
    run = harness.importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: (result, checks))
    monkeypatch.setattr(harness, "forbidden_modules", lambda: list(bad))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "0"])
    return rc, out.getvalue(), err.getvalue()


def test_result_is_the_last_line_and_the_checks_close_stderr(monkeypatch):
    checks = {"resid": {"value": 1e-6, "limit": 1e-5}, "eig": {"value": 2e-7, "limit": 1e-5}}
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"solve_ms": {"value": 75.1, "unit": "ms"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 1},
              "card": "NVIDIA H100 80GB HBM3, 700.00 W", "readings": {}, "checks": checks}
    rc, out, err = _main(monkeypatch, result, checks)
    assert rc == 0
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert err.strip().splitlines()[-2:] == ["check resid 1e-06 limit 1e-05", "check eig 2e-07 limit 1e-05"]
    rc, out, err = _main(monkeypatch, result, checks, bad=["repro"])
    assert rc != 0 and out == "" and "repro" in err


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "evdbench/run.py", "--workload", "dense-fp32.tridiag.n4096",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "needs 1 CUDA card" in out.stderr
