"""The benchmark of the PyTorch / CUDA port: one run of one cell.

Everything that belongs to one cell is found by name from data:

* ``BENCHMARK.json`` at the checkout's root: the cells, configurations and
  metrics;
* ``evdbench/configs/<config>.json`` (the file the configuration names):
  the matrices, made by ``evdbench/inputs/<config["inputs"]>.py``;
* ``evdbench/traffic/<traffic>.json``: the sizes of a call, the entry
  ``evdbench/entries/<traffic["entry"]>.py`` that the window drives, and
  how many calls the check and the trace take;
* ``evdbench/reference/<entry.CHECK>.py``: the plain check of what the
  entry returns, and ``evdbench/limits/<cell>.json`` its limits;
* ``evdbench/metrics/<metric>.py``: one reader a metric.

So a cell, a configuration or a metric is added as files and entries of
``BENCHMARK.json``, without an edit to a file that is there.

A run: the inputs from the seed on the card, one warm call (``setup_s``
ends there), then calls back to back for ``seconds``, each closed by a
synchronize, the window running until the call in flight at its end
completes.  A reservoir drawn from the seed keeps ``check_samples`` calls'
outputs.  With ``trace`` the profiler records the first ``trace_calls``
calls of the window, and ``span_calls`` calls after it time the entry's
stages between CUDA events.  Then the peak memory is read, the program's
state freed, the inputs made again from the seed, and the reference
judges the kept outputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import trace as tracing

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    """The run needs a CUDA card it does not have."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT):
    """``evdbench/<kind>/<name>.py`` under ``root``, loaded by its path."""
    path = root / "evdbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {name!r}: {path} is missing")
    mod_name = f"evdbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Optional[dict]
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its files."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    wl = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    limits_path = root / "evdbench" / "limits" / f"{name}.json"
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=name,
        chips=wl["chips"],
        config=load_json(root / cfg["file"]),
        traffic=load_json(root / "evdbench" / "traffic" / f"{wl['traffic']}.json"),
        limits=load_json(limits_path) if limits_path.is_file() else None,
        end_to_end=e2e,
        per_layer=per_layer,
    )


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    calls: int
    call_s: List[float]
    launches: Dict[str, int]          # CUDA launches of each kernel op over the window
    facts: dict                       # the entry's sizes and blocking
    spans: Dict[str, List[float]]     # seconds of each stage span (traced runs)
    trace: Optional[tracing.Summary]  # the traced calls (traced runs)


class Spans:
    """``with spans(name):`` times a stage between CUDA events on the
    current stream (on the CPU, by the host's clock)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.marks.append((name, start, end))
        else:
            t = time.perf_counter()
            yield
            self.marks.append((name, t, time.perf_counter()))

    def seconds(self) -> Dict[str, List[float]]:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, List[float]] = {}
        for name, a, b in self.marks:
            out.setdefault(name, []).append(a.elapsed_time(b) / 1e3 if self.cuda else b - a)
        return out


@dataclasses.dataclass
class Window:
    calls: int
    window_s: float
    call_s: List[float]
    kept: list
    launches: Dict[str, int]
    trace: Optional[tracing.Trace]


def measure(entry, seconds: float, keep: int, seed: int, device, trace_calls: int = 0) -> Window:
    """Calls back to back for ``seconds`` and at least ``keep`` calls (the
    call in flight at the end completes), each closed by a synchronize; a
    reservoir drawn from the seed keeps ``keep`` calls' outputs; with
    ``trace_calls`` the profiler records the first ones."""
    import torch
    from repro_torch.kernels import cuda_lib

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rng = random.Random(seed)
    kept, call_s = [], []
    prof = span = traced = None
    if trace_calls:  # the profiler's own start-up stays out of the window
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        span = torch.profiler.record_function(tracing.WINDOW)
    before = cuda_lib.device_launch_counts()
    sync()
    start = time.perf_counter()
    i = 0
    while True:
        if span is not None and i == 0:
            span.__enter__()
        t0 = time.perf_counter()
        out = entry.call(i)
        sync()
        t1 = time.perf_counter()
        call_s.append(t1 - t0)
        item = entry.keep(i, out)
        del out
        if len(kept) < keep:
            kept.append(item)
        else:
            j = rng.randrange(i + 1)
            if j < keep:
                kept[j] = item
        del item
        i += 1
        if prof is not None and traced is None and (i == trace_calls or t1 - start >= seconds):
            span.__exit__(None, None, None)
            prof.stop()
            traced = tracing.from_profiler(prof)
            prof = span = None
        if t1 - start >= seconds and i >= keep:
            break
    after = cuda_lib.device_launch_counts()
    return Window(calls=i, window_s=t1 - start, call_s=call_s, kept=kept,
                  launches={op: after[op] - before[op] for op in after}, trace=traced)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t0: Optional[float] = None,
             device=None, root: Path = ROOT, cell: Optional[Cell] = None, entry: Optional[str] = None):
    """One run of cell ``name``: ``(result, checks)``, the result line's
    object and the numbers compared, each with its limit.

    With ``device=None`` the run needs the cell's cards and raises
    :class:`NoCard` without them; it never falls back to the CPU.  The
    tests pass ``device=torch.device("cpu")`` to drive the rest of a run
    on the port's plain versions.  ``entry`` names an entry file to drive
    in place of the traffic's own: the correctness control's."""
    t0 = time.perf_counter() if t0 is None else t0
    phases: Dict[str, float] = {}

    def phase(label: str) -> None:
        phases[label] = time.perf_counter() - t0

    import torch

    phase("torch")
    cell = cell or find_cell(name, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoCard(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}")
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = seed % 2 ** 63
    traffic = cell.traffic
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    inputs_mod = load_module("inputs", cell.config["inputs"], root)
    entry_mod = load_module("entries", entry or traffic["entry"], root)
    check_mod = load_module("reference", entry_mod.CHECK, root)
    torch.empty(0, device=device)
    sync()
    phase("context")

    inputs = inputs_mod.make(cell.config, traffic, seed, device)
    entry = entry_mod.Entry(inputs, cell.config, traffic, device)
    sync()
    phase("inputs")
    for i in range(traffic.get("warm_calls", 1)):
        out = entry.call(i)
        del out
    sync()
    phase("warm")
    setup_s = time.perf_counter() - t0

    win = measure(entry, seconds, traffic["check_samples"], seed, device,
                  traffic.get("trace_calls", 1) if trace else 0)
    spans: Dict[str, List[float]] = {}
    if trace and hasattr(entry, "spans"):
        sp = Spans(device)
        for i in range(traffic.get("span_calls", 3)):
            entry.spans(i, sp)
        spans = sp.seconds()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = tracing.summarize(win.trace) if win.trace is not None else None
    readings = Run(setup_s=setup_s, window_s=win.window_s, calls=win.calls, call_s=win.call_s,
                   launches=win.launches, facts=entry.facts, spans=spans, trace=summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"], root).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The reference runs on the outputs alone, from inputs made again.
    del entry, inputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check_mod.check(inputs_mod.make(cell.config, traffic, seed, device), win.kept, traffic, seed)
    limits = cell.limits or {}
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim} for k, lim in limits.items()}
    correct = bool(checks) and bool(win.kept) and all(c["value"] <= c["limit"] for c in checks.values())

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 1,
           "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = summary.busy_s if summary else 0.0
        dev["window_s"] = summary.window_s if summary else 0.0
    result = {"correct": correct, "attempted": win.calls, "failed": 0, "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    result["card"] = power_limit() if cuda else "cpu"
    result["setup_phases"] = phases
    result["readings"] = numbers
    result["checks"] = checks
    return result, checks


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
