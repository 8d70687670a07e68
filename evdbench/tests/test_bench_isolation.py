"""Nothing the benchmark runs loads JAX or the JAX package, and its plain
reference loads nothing of the port either.  Module names are compared by
their whole top-level name: ``repro_torch`` is not ``repro``."""
import subprocess
import sys

from bench_small import ROOT

from evdbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_modules(code: str) -> set:
    """The top-level names of ``sys.modules`` after ``code`` runs in a
    fresh interpreter with the checkout and ``src`` on the path."""
    prog = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split()[-1000:])


def test_harness_and_the_program_it_drives_load_no_jax():
    code = """
from evdbench import harness, trace
import json
spec = json.load(open(harness.ROOT / "BENCHMARK.json"))
for w in spec["workloads"]:
    cell = harness.find_cell(w["name"])
    harness.load_module("inputs", cell.config["inputs"])
    entry = harness.load_module("entries", cell.traffic["entry"])
    harness.load_module("reference", entry.CHECK)
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.load_module("metrics", m["name"])
import evdbench.control
import repro_torch.solver, repro_torch.core, repro_torch.kernels.cuda_lib
"""
    mods = _top_level_modules(code)
    assert "repro_torch" in mods and "evdbench" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = """
import pathlib, importlib
for f in sorted(pathlib.Path({root!r}, "evdbench", "reference").glob("*.py")):
    importlib.import_module("evdbench.reference." + f.stem)
import evdbench.yardstick.work, evdbench.yardstick.peaks
""".format(root=str(ROOT))
    mods = _top_level_modules(code)
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.solver", "reprox", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "repro.solver", sys)
    assert "repro" in harness.forbidden_modules()
