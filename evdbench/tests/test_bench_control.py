"""The check's two sides at a size a CPU test holds, each a whole run of
the cell but for the look for a card: the program's plain versions come
out correct under each cell's limits, the TF32 control in the entry's
place (``entries/sytrd_tf32``) comes out not correct, and so does a run
whose timed path is broken underneath.

The limits are the cells' own (``evdbench/limits``), set from readings on
the card at the cells' sizes; ``evdbench/control.py`` takes those."""
import pytest
import torch

from bench_small import small_cell

from evdbench import harness

DENSE = "dense-fp32.tridiag.n4096"
LARGE = "dense-fp32.tridiag.n16384"
SIZES = {DENSE: {"n": 256, "pool": 2, "check_samples": 2}, LARGE: {"n": 384, "pool": 1, "check_samples": 1}}


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 5])
@pytest.mark.parametrize("name", [DENSE, LARGE])
def test_program_passes_and_control_fails(name, seed, cpu):
    cell = small_cell(name, **SIZES[name])
    result, checks = harness.run_cell(name, seed, 0.1, False, device=cpu, cell=cell)
    assert result["correct"] is True, checks
    assert result["attempted"] >= cell.traffic["check_samples"]
    result, checks = harness.run_cell(name, seed, 0.1, False, device=cpu, cell=cell, entry="sytrd_tf32")
    assert result["correct"] is False, checks
    assert set(checks) == set(cell.limits) and result["attempted"] >= cell.traffic["check_samples"]


def _unchanged_dense(real):
    def broken(A, **kw):
        d, e, (kind, (refl, log)) = real(A, **kw)
        refl.T.zero_()
        log.taus.zero_()
        return torch.diagonal(A).clone(), torch.diagonal(A, -1).clone(), (kind, (refl, log))
    return broken


def _altered_dense(real):
    def broken(A, **kw):
        d, e, rest = real(A, **kw)
        e[e.shape[0] // 2] *= 1.01
        return d, e, rest
    return broken


FAULTS = [
    (DENSE, _unchanged_dense),   # the state returned unchanged
    (DENSE, _altered_dense),     # an answer altered where it is produced
    (LARGE, _unchanged_dense),
    (LARGE, _altered_dense),
]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch, cpu):
    """A whole run but for the look for a card, the program's entry broken
    underneath: ``correct`` comes out false (one chip: no exchange between
    chips to leave out; one matrix a call: no half of a batch)."""
    from repro_torch import solver

    cell = small_cell(name)
    result, _ = harness.run_cell(name, 3, 0.2, False, device=cpu, cell=cell)
    assert result["correct"] is True
    monkeypatch.setattr(solver, "tridiagonalize", fault(solver.tridiagonalize))
    result, checks = harness.run_cell(name, 3, 0.2, False, device=cpu, cell=cell)
    assert result["correct"] is False, checks
