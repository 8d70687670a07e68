"""Entry of the correctness control: the plain one-stage tridiagonalization
of ``reference/sytrd.py`` in the program's place, every trailing update a
TF32 product (one precision below the configuration's float32).

A run with this entry in place of the cell's (``harness.run_cell(...,
entry="sytrd_tf32")``, as ``evdbench/control.py`` runs it) goes through the
same window, reservoir and check as the program, and has to come out not
correct.  It keeps (d, e) and its reflectors in the form ``reference/tridiag``
reads as ``"householder"``.
"""
from __future__ import annotations

from evdbench.reference import sytrd

CHECK = "tridiag"


class Entry:
    def __init__(self, inputs: dict, config: dict, traffic: dict, device):
        self.pool = inputs["pool"]
        self.facts = {"n": self.pool[0].shape[-1]}

    def call(self, i: int):
        return sytrd.tridiagonalize(self.pool[i % len(self.pool)], tf32=True)

    def keep(self, i: int, out) -> dict:
        d, e, V, tau = out
        return {"input": i % len(self.pool), "form": "householder", "d": d, "e": e, "V": V, "tau": tau}
