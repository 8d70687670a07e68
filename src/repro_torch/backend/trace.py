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

The recorder of spans and counters.  ``with span(name, like):`` marks a
stage of the port (the executor's stages, ``tridiagonalize``, the
Rayleigh-Ritz root), and the registry wraps every op it hands out in a span
``op.<op>``.  A span records only while recording is on: while a
``torch.profiler`` session is active, or inside :func:`recording`.  Off, a
span is a flag check and returns a shared no-op.  On, it opens
``torch.profiler.record_function`` (the op spans under the name
``repro_torch.op.<op>``), and keeps a :class:`Record`: its name, its
parent, the call (every span of one top-level call shares it), and the
host's start and end in ns on the profiler's clock (the epoch clock,
``time.time_ns``), so a gap of a device trace can be matched to the spans
around it.  A stage span on a CUDA tensor also records a pair of CUDA
events on the current stream, resolved when read.  While recording,
:func:`count` adds to a counter (every :func:`data_dependent` loop counts
its entries and trips), and :func:`device_counters` hands a launcher a
zeroed int64 tensor for a kernel to add to (kernel B's wait and op
cycles), kept with the innermost span and read when the session is.  A
span that finds recording on after it was off starts a new session;
:func:`session` returns the newest, its device times resolved.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import torch

__all__ = [
    "NAMESPACE", "is_fake", "data_dependent", "Loop", "repeated", "map_lanes", "collective",
    "Record", "Session", "recording", "is_recording", "span", "traced_op", "count",
    "device_counters", "session",
]

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
        count(self.site + ".trips")


@contextlib.contextmanager
def data_dependent(site: str, fake: str) -> Iterator[Loop]:
    """Run a loop whose trips depend on values; ``site`` is its place in
    the code and ``fake`` what it runs on fake tensors (its bound, or no
    trip)."""
    for walk in listeners:
        walk.loop_enter(site, fake)
    count(site + ".entries")
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


# ------------------------------------------------------------ the recorder
MAX_RECORDS = 1 << 18  # spans a session keeps; past it, spans are counted as dropped


@dataclasses.dataclass
class Record:
    """One span: ``parent`` is the index of the enclosing span in the
    session's records (None at the top), ``call`` the top-level call it
    belongs to; host times in ns on the profiler's clock; ``device_ms``
    between the span's CUDA events (None without them)."""

    name: str
    parent: Optional[int]
    call: int
    start_ns: int
    end_ns: int = 0
    device_ms: Optional[float] = None
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def host_us(self) -> float:
        return (self.end_ns - self.start_ns) / 1e3

    @property
    def ms(self) -> float:
        """Device time where the span has it, else host time."""
        return self.device_ms if self.device_ms is not None else (self.end_ns - self.start_ns) / 1e6


class Session:
    """What one stretch of recording kept: the spans in the order they
    opened, the counters summed over the session, and the spans dropped
    past ``MAX_RECORDS``."""

    def __init__(self, ident: int):
        self.id = ident
        self.records: List[Record] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self._events: List[tuple] = []   # (record, start event, end event), unresolved
        self._tensors: List[tuple] = []  # (record or None, counter names, int64 tensor), unread

    def _add(self, rec: Optional[Record], name: str, k: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + k
        if rec is not None:
            rec.counters[name] = rec.counters.get(name, 0) + k

    def _resolve(self) -> None:
        open_ = []
        for rec, start, end in self._events:
            if not rec.end_ns:  # still open: its end event is not recorded yet
                open_.append((rec, start, end))
                continue
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
        self._events = open_
        for rec, names, t in self._tensors:
            for name, k in zip(names, t.tolist()):
                self._add(rec, name, int(k))
        self._tensors.clear()

    def spans(self, name: str) -> List[Record]:
        return [r for r in self.records if r.name == name]

    def ms(self, name: str) -> List[float]:
        """Each ``name`` span's device time (host time where it has none)."""
        return [r.ms for r in self.spans(name)]

    def host_us(self, name: str) -> List[float]:
        return [r.host_us for r in self.spans(name)]

    def totals_ms(self) -> Dict[str, float]:
        """Milliseconds summed by span name, the op spans left out."""
        out: Dict[str, float] = {}
        for r in self.records:
            if not r.name.startswith("op."):
                out[r.name] = out.get(r.name, 0.0) + r.ms
        return out


_forced = 0                # open recording() contexts
_was_on = False            # recording was on at the last look
_current = Session(0)
_ids = itertools.count(1)  # sessions and calls
_local = threading.local()  # each thread's open spans and its call


def _on() -> bool:
    """Whether recording is on; starts a new session when it was off."""
    global _was_on, _current
    on = _forced > 0 or torch.autograd._profiler_enabled()
    if on and not _was_on:
        _current = Session(next(_ids))
    _was_on = on
    return on


def is_recording() -> bool:
    return _on()


class recording:
    """Record spans and counters while open, without a profiler."""

    def __enter__(self) -> "recording":
        global _forced
        _on()  # notes whether recording was off: then the next look starts a session
        _forced += 1
        _on()
        return self

    def __exit__(self, *exc) -> None:
        global _forced
        _forced -= 1
        _on()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The span of recording off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "label", "like", "rec", "rf", "end_event")

    def __init__(self, name: str, like: Optional[torch.Tensor], label: Optional[str] = None):
        self.name, self.label, self.like = name, label or name, like
        self.rec = self.rf = self.end_event = None

    def __enter__(self) -> None:
        sess, stack = _current, _stack()
        parent = stack[-1] if stack else None
        if parent is None:
            _local.call = next(_ids)
        if len(sess.records) >= MAX_RECORDS:
            sess.dropped += 1
            stack.append(parent)
            return
        self.rf = torch.profiler.record_function(self.label)
        self.rf.__enter__()
        rec = Record(self.name, None if parent is None else parent[0], _local.call, time.time_ns())
        like = self.like
        if (like is not None and like.is_cuda and not is_fake(like)
                and not torch.cuda.is_current_stream_capturing()):
            start, self.end_event = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            sess._events.append((rec, start, self.end_event))
        sess.records.append(rec)
        self.rec = rec
        stack.append((len(sess.records) - 1, rec))

    def __exit__(self, *exc) -> None:
        _stack().pop()
        if self.rec is None:
            return
        if self.end_event is not None:
            self.end_event.record()
        self.rec.end_ns = time.time_ns()
        self.rf.__exit__(*exc)


def span(name: str, like: Optional[torch.Tensor] = None):
    """A span around a stage: ``with span("chase", A): ...``.  ``like`` is a
    tensor of the stage; on a CUDA one the span is timed between CUDA events
    too."""
    if not _on():
        return _OFF
    return _Span(name, like)


def traced_op(op: str, fn: Callable) -> Callable:
    """``fn`` (a registry op) with each call in a span ``op.<op>`` (host
    time only), named ``repro_torch.op.<op>`` in a profiler's trace."""
    name = "op." + op
    label = f"{NAMESPACE}.{name}"

    @functools.wraps(fn)
    def call(*args, **kw):
        if not _on():
            return fn(*args, **kw)
        with _Span(name, None, label):
            return fn(*args, **kw)

    return call


def _innermost() -> Optional[Record]:
    stack = getattr(_local, "stack", None)
    return stack[-1][1] if stack and stack[-1] is not None else None


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name`` of the session and of the innermost
    span, while recording."""
    if _on():
        _current._add(_innermost(), name, int(k))


def device_counters(names: Sequence[str], device) -> Optional[torch.Tensor]:
    """While recording, a zeroed int64 tensor of ``len(names)`` entries on
    ``device`` for a kernel to add to, counted under ``names`` with the
    innermost span when the session is read; else None."""
    if not _on():
        return None
    t = torch.zeros(len(names), dtype=torch.int64, device=device)
    _current._tensors.append((_innermost(), tuple(names), t))
    return t


def session() -> Session:
    """The newest session, its device times and counters resolved."""
    _current._resolve()
    return _current
