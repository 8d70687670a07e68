"""Small copies of the benchmark's cells for CPU runs of the tests."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Sizes a CPU run of the port's plain versions holds in a few seconds.
SMALL = {
    "dense-fp32.tridiag.n4096": {"n": 64, "pool": 3},
    "dense-fp32.tridiag.n16384": {"n": 96, "pool": 2},
}


def small_cell(name, root=ROOT, **traffic):
    """Cell ``name`` of ``root`` at the CPU test's size (the same files,
    with the sizes above, then ``traffic``, in place of the cell's)."""
    from evdbench import harness

    cell = harness.find_cell(name, root)
    cell.traffic = {**cell.traffic, **SMALL.get(name, {}), **traffic}
    return cell
