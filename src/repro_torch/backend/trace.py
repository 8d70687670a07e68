"""What the port's host code may ask of a tensor that may be fake.

The dry-run runs steps on ``FakeTensorMode`` tensors (shapes, dtypes and
devices, no values).  Three places on Shampoo's refresh path read a value
on the host: the refresh branch on the step, the Jacobi sweeps' early exit,
and the CUDA QR re-factor's choice of matrices.  Each asks :func:`is_fake`
for the path it takes on fake tensors.  A loop whose trip count depends on
values runs inside :func:`data_dependent`, which tells every walk in
progress (``repro_torch.analysis.walk.StepWalk``) where its trips, their
FLOPs and their bytes went: the counterpart of the JAX walk's
``unknown_trip_whiles``.

A fake tensor op costs the host ~0.3 ms, and the refresh's plain stages are
Python loops of tiny ops (48 bisection steps over every row, the Jacobi
rounds, the plain chase's wavefronts and back-transform's sweeps): ~0.4 M
ops a bucket.  A loop whose trips all run the same ops on tensors of the
same shapes runs one trip on fake tensors, which every walk counts as many
times as the loop has trips (:func:`repeated`), as the JAX walk multiplies
a while loop's body by its trip count; the same holds for the lanes of a
loop over a bucket (:func:`map_lanes`: the chunks of a bucket over
``kernels.limits.bucket_chunk``, and the oracles ``chase="sequential"`` and
``backtransform="scan"``, which run a matrix at a time), whose one result
stands for every lane and is held once a lane.  The kernels' operators take
a whole bucket a call.  These two also branch on :func:`is_fake`:
on real tensors they run every trip, so a real run is bitwise what it was,
and a fake run counts what running every trip counts
(tests/test_torch_library.py holds the two against each other).

A collective (``repro_torch.parallel.comm``) runs inside
:func:`collective`: what its backend does to the step's tensors (gloo
copies a reduce-scatter's result into place; NCCL runs no op) is the
collective's, which the walk counts in the collective term, not as ops.

``NAMESPACE`` is the namespace of the port's operators (kernels A-E,
``repro_torch.kernels.library``), which the walk counts.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Iterator, List

import torch

__all__ = ["NAMESPACE", "is_fake", "data_dependent", "Loop", "repeated", "map_lanes", "collective"]

NAMESPACE = "repro_torch"

# The walks in progress (analysis.walk.StepWalk), innermost last.
listeners: List = []


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor, which has no values to read."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


class Loop:
    """A data-dependent loop in progress: call :meth:`trip` once a trip."""

    def __init__(self, site: str):
        self.site = site

    def trip(self) -> None:
        for walk in listeners:
            walk.loop_trip(self.site)


@contextlib.contextmanager
def data_dependent(site: str, fake: str) -> Iterator[Loop]:
    """Run a loop whose trips depend on values; ``site`` is its place in
    the code and ``fake`` what it runs on fake tensors (its bound, or no
    trip)."""
    for walk in listeners:
        walk.loop_enter(site, fake)
    try:
        yield Loop(site)
    finally:
        for walk in listeners:
            walk.loop_exit(site)


@contextlib.contextmanager
def repeated(n: int, like: torch.Tensor) -> Iterator[range]:
    """``range(n)``, the trips of a loop whose every trip runs the same ops
    on tensors of the same shapes; when ``like`` is fake, ``range(1)``,
    counted ``n`` times by every walk in progress."""
    if n <= 1 or not is_fake(like):
        yield range(n)
        return
    for walk in listeners:
        walk.scale(n)
    try:
        yield range(1)
    finally:
        for walk in listeners:
            walk.unscale(n)


def map_lanes(fn: Callable, items: Iterable, like: torch.Tensor) -> list:
    """``[fn(x) for x in items]`` for a bucket's lanes, each the same ops on
    the same shapes; when ``like`` is fake, ``fn`` runs on the first lane
    alone, every walk in progress counts it once a lane and holds what it
    returns once a lane, and that result stands for every lane."""
    items = list(items)
    k = len(items)
    if k <= 1 or not is_fake(like):
        return [fn(x) for x in items]
    for walk in listeners:
        walk.scale(k, hold=True)
    try:
        out = fn(items[0])
    finally:
        for walk in listeners:
            walk.unscale(k, hold=True)
    return [out] * k


@contextlib.contextmanager
def collective() -> Iterator[None]:
    """A collective in progress: every walk in progress counts none of the
    ops run inside it."""
    for walk in listeners:
        walk.mute(1)
    try:
        yield
    finally:
        for walk in listeners:
            walk.mute(-1)
