"""Entry: ``repro_torch.solver.tridiagonalize(A, return_reflectors=True)``.

One dense matrix a call, the pool cycled, blocking from the port's own
table (``resolve_blocking``, as the call resolves it).  What a call
returns, the tridiagonal (d, e) and the reflectors of Q1 and Q2, is kept
as plain tensors for ``reference/tridiag``.  Traced runs also time the
call and its two stages, each between CUDA events: ``band_reduce`` as
``tridiagonalize`` calls it, then ``band_to_tridiag`` on its band.
"""
from __future__ import annotations

CHECK = "tridiag"


class Entry:
    def __init__(self, inputs: dict, config: dict, traffic: dict, device):
        from repro_torch.solver import resolve_blocking

        self.pool = inputs["pool"]
        n = self.pool[0].shape[-1]
        dec = resolve_blocking(n, device_type=device.type)
        self.b, self.nb = dec.b, dec.nb
        self.facts = {"n": n, "b": dec.b, "nb": dec.nb}

    def _input(self, i: int):
        return self.pool[i % len(self.pool)]

    def call(self, i: int):
        from repro_torch import solver

        return solver.tridiagonalize(self._input(i), return_reflectors=True)

    def keep(self, i: int, out) -> dict:
        d, e, (kind, data) = out
        if kind != "two_stage":
            raise RuntimeError(f"tridiagonalize took the {kind!r} path, not the two-stage one")
        refl, log = data
        return {"input": i % len(self.pool), "d": d, "e": e, "V1": refl.V, "T1": refl.T, "b1": refl.b,
                "vs": log.vs, "taus": log.taus, "row0": log.row0, "n": log.n, "b2": log.b}

    def spans(self, i: int, span) -> None:
        from repro_torch import core, solver

        A = self._input(i)
        with span("call"):
            solver.tridiagonalize(A, return_reflectors=True)
        with span("band_reduce"):
            band, _ = core.band_reduce(A[None], self.b, self.nb, return_reflectors=True)
        with span("chase"):
            core.band_to_tridiag(band, self.b, return_log=True)
