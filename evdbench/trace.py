"""Reduce a profiler trace of the measured calls to what the per-layer
metrics read: the device's busy time in the traced window, the device
operations that took most time, and the idle gaps by what the host was
doing when the operation that ended each gap was launched.

The reduction works on plain tuples, so the tests feed it synthetic
traces; :func:`from_profiler` makes them from a ``torch.profiler`` run.
Times are nanoseconds on the trace's clock.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "evdbench.window"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    start: int
    end: int
    name: str
    correlation: int = -1


@dataclasses.dataclass(frozen=True)
class HostOp:
    start: int
    end: int
    name: str
    runtime: bool = False    # a CUDA runtime call (cudaLaunchKernel, ...)
    correlation: int = -1


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]
    device: List[DeviceOp]
    host: List[HostOp]


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]   # name, seconds: the 10 largest sums
    idle_gaps: List[Tuple[str, float]]    # host label, seconds: the 10 largest sums


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    arguments, at most 96 characters."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in name:  # drop template arguments and the argument list
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:96]


def busy_intervals(ops: Sequence[DeviceOp], window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The union of the device operations' intervals, clipped to the window."""
    lo, hi = window
    spans = sorted((max(op.start, lo), min(op.end, hi)) for op in ops if op.end > lo and op.start < hi)
    merged: List[List[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _innermost(host: Sequence[HostOp], times: Sequence[int]) -> List[Optional[str]]:
    """For each time (ascending), the name of the innermost host operation
    (not a runtime call) that contains it, by a sweep over the nested
    intervals."""
    ops = sorted((h for h in host if not h.runtime), key=lambda h: (h.start, -h.end))
    out: List[Optional[str]] = []
    stack: List[HostOp] = []
    k = 0
    for t in times:
        while k < len(ops) and ops[k].start <= t:
            while stack and stack[-1].end < ops[k].start:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(stack[-1].name if stack else None)
    return out


def summarize(tr: Trace, top: int = 10) -> Summary:
    lo, hi = tr.window
    ops = [op for op in tr.device if op.end > lo and op.start < hi]
    merged = busy_intervals(ops, tr.window)
    busy = sum(e - s for s, e in merged)
    by_name: Dict[str, int] = {}
    for op in ops:
        key = short_name(op.name)
        by_name[key] = by_name.get(key, 0) + (min(op.end, hi) - max(op.start, lo))
    # Each gap ends where a merged busy interval starts; label it by the
    # host operation that launched the device operation starting there.
    launch_at = {h.correlation: h.start for h in tr.host if h.runtime}
    first_op: Dict[int, DeviceOp] = {}
    for op in sorted(ops, key=lambda o: o.start):
        first_op.setdefault(max(op.start, lo), op)
    gaps: List[Tuple[int, Optional[int]]] = []  # (length, launch time of the op ending it)
    prev = lo
    for s, e in merged:
        if s > prev:
            gaps.append((s - prev, launch_at.get(first_op[s].correlation)))
        prev = e
    timed = sorted((t, i) for i, (_, t) in enumerate(gaps) if t is not None)
    names = _innermost(tr.host, [t for t, _ in timed])
    label = {i: (nm or "(no host op)") for (_, i), nm in zip(timed, names)}
    idle: Dict[str, int] = {}
    for i, (length, _) in enumerate(gaps):
        key = label.get(i, "(launch not traced)")
        idle[key] = idle.get(key, 0) + length
    if hi > prev:
        idle["(after the last operation)"] = idle.get("(after the last operation)", 0) + hi - prev
    return Summary(
        busy_s=busy / 1e9,
        window_s=(hi - lo) / 1e9,
        device_ops=[(k, v / 1e9) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[(k, v / 1e9) for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    )


def _is_runtime(ev) -> bool:
    """A CUDA runtime or driver call on the host (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ...): by its activity type where the profiler
    gives one, else by its name."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() in ("cuda_runtime", "cuda_driver")
    return re.match(r"^cu(da)?[A-Z]", ev.name()) is not None


def from_profiler(prof) -> Trace:
    """The traced window, device operations and host operations of a
    stopped ``torch.profiler.profile``.  The window is the
    ``record_function(WINDOW)`` span the harness opens around the traced
    calls; host operations are those of its thread, with every runtime
    call.  A device-side event that bears a host event's name is an
    annotation's shadow (``record_function`` spans), not an operation."""
    events = prof.profiler.kineto_results.events()
    window, thread = None, None
    host_names = set()
    for ev in events:
        if ev.device_type().name == "CPU":
            host_names.add(ev.name())
            if ev.name() == WINDOW:
                window, thread = (ev.start_ns(), ev.end_ns()), ev.start_thread_id()
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    device, host = [], []
    for ev in events:
        kind = ev.device_type().name
        if kind == "CUDA":
            if ev.name() not in host_names:
                device.append(DeviceOp(ev.start_ns(), ev.end_ns(), ev.name(), ev.correlation_id()))
        elif kind == "CPU" and ev.name() != WINDOW:
            # Runtime calls carry the CUPTI correlation of what they
            # launched, and their own thread numbering: keep them all.
            runtime = _is_runtime(ev)
            if runtime or ev.start_thread_id() == thread:
                host.append(HostOp(ev.start_ns(), ev.end_ns(), ev.name(), runtime, ev.correlation_id()))
    return Trace(window=window, device=device, host=host)
