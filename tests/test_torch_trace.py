"""The recorder of spans and counters (``repro_torch.backend.trace``).

On the CPU: the spans each entry point records (names, parents, calls, in
the order they opened), that recording off records nothing and opens no
``record_function``, that a span's host start is its profiler event's,
that two traced benchmark runs in one process each read their own session,
and the counters (``data_dependent``'s entries and trips, a launcher's
device counters, the buffer's drops).  The tests marked ``cuda`` hold the
same on the card, with the spans' CUDA events:

    python -m pytest -m cuda tests/test_torch_trace.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backend import trace  # noqa: E402
from repro_torch.core.band_reduction import build_stage_schedule  # noqa: E402
from repro_torch.solver import EvdConfig, plan, resolve_blocking, solve_many, tridiagonalize  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, B, NB = 32, 4, 8
BLOCKS = len(build_stage_schedule(N, B, NB).entries)


def _sym(n, seed, device="cpu"):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return torch.as_tensor(a + a.T, device=device)


def _tree(sess):
    """(name, parent's name, call) of each span, in the order they opened,
    the calls numbered from 0 in the order they began."""
    calls = {}
    out = []
    for r in sess.records:
        parent = None if r.parent is None else sess.records[r.parent].name
        out.append((r.name, parent, calls.setdefault(r.call, len(calls))))
    return out


def _two_stage(top, call=0, eigenvectors=True):
    """The spans of one two-stage solve of n = 32 (b = 4, nb = 8) on the
    CPU under ``top`` (``tridiagonalize``, or ``chunk`` inside ``solve``)."""
    out = [("band_reduce", top, call)] + [("op.fused_panel_update", "band_reduce", call)] * BLOCKS
    out += [("chase", top, call), ("op.bulge_wavefront", "chase", call)]
    if top == "tridiagonalize":
        return out
    out += [("bisection", top, call)]
    if eigenvectors:
        out += [("inverse_iteration", top, call), ("q2", top, call), ("q2_regroup", "q2", call),
                ("op.backtransform_wy", "q2", call), ("q1", top, call)]
    return out


def test_spans_of_tridiagonalize():
    A = _sym(N, 0)
    with trace.recording():
        tridiagonalize(A, b=B, nb=NB, return_reflectors=True)
        tridiagonalize(A, b=B, nb=NB)
    sess = trace.session()
    want = [("tridiagonalize", None, 0)] + _two_stage("tridiagonalize")
    want += [("tridiagonalize", None, 1)] + _two_stage("tridiagonalize", 1)
    assert _tree(sess) == want
    assert all(r.end_ns >= r.start_ns > 0 and r.device_ms is None for r in sess.records)
    assert sess.dropped == 0


@pytest.mark.parametrize("method", ["two_stage", "direct", "jacobi"])
def test_spans_of_a_plan(method):
    A = _sym(N, 1)
    pl = plan(N, torch.float32, EvdConfig(method=method, b=B, nb=NB), device="cpu")
    with trace.recording():
        w, V = pl(A)
        pl.eigvals(A)
    sess = trace.session()
    head = [("solve", None, 0), ("chunk", "solve", 0)]
    if method == "two_stage":
        body = _two_stage("chunk")
        values = _two_stage("chunk", 1, eigenvectors=False)
    elif method == "direct":
        body = [("direct_tridiag", "chunk", 0), ("bisection", "chunk", 0), ("inverse_iteration", "chunk", 0),
                ("q1", "chunk", 0)]
        values = [("direct_tridiag", "chunk", 1), ("bisection", "chunk", 1)]
    else:
        body, values = [("jacobi", "chunk", 0)], [("jacobi", "chunk", 1)]
    assert _tree(sess) == head + body + [("solve", None, 1), ("chunk", "solve", 1)] + values
    if method == "jacobi":
        site = "core/jacobi.py:jacobi_eigh"
        assert sess.counters[site + ".entries"] == 2 and sess.counters[site + ".trips"] >= 2
        chunk = sess.spans("jacobi")[0]
        assert chunk.counters[site + ".entries"] == 1 and chunk.counters[site + ".trips"] >= 1
    else:
        assert not sess.counters  # the QR polish's loop runs on CUDA tensors only


def test_spans_of_solve_many():
    """Each bucket one ``solve`` (its own call), in the order solve_many
    runs them; the inverse root adds its ``ritz_root``."""
    leaves = [_sym(N, 2), _sym(24, 3), _sym(N, 4)]
    cfg = EvdConfig(b=B, nb=NB)
    with trace.recording():
        solve_many(leaves, cfg, device="cpu")
    sess = trace.session()
    tops = [(r.name, r.call) for r in sess.records if r.parent is None]
    assert [name for name, _ in tops] == ["solve", "solve"]
    assert len({call for _, call in tops}) == 2
    assert len(sess.spans("chunk")) == 2 and len(sess.spans("op.backtransform_wy")) == 2
    stack = torch.stack([_sym(N, 5), _sym(N, 6)])
    with trace.recording():
        solve_many(stack @ stack.mT, cfg, op="inverse_pth_root", p=4, device="cpu")
    tree = _tree(trace.session())
    assert tree[:2] == [("solve", None, 0), ("chunk", "solve", 0)]
    assert tree[-1] == ("ritz_root", None, 1)
    assert [t for t in tree if t[0] in ("solve", "ritz_root")] == [("solve", None, 0), ("ritz_root", None, 1)]


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with recording off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.is_recording()
    before = trace.session()
    n_before = len(before.records)
    A = _sym(N, 7)
    tridiagonalize(A, b=B, nb=NB)
    plan(N, torch.float32, EvdConfig(b=B, nb=NB), device="cpu")(A)
    plan(N, torch.float32, EvdConfig(method="jacobi"), device="cpu")(A)
    trace.count("x")
    assert trace.device_counters(("x",), "cpu") is None
    assert trace.span("y", A) is trace.span("z")  # the one shared no-op
    after = trace.session()
    assert after is before and len(after.records) == n_before and "x" not in after.counters


def _starts_match_events(sess, prof):
    """Each span's host start against its own profiler event's: the
    spans' and the host events' starts by name (the op spans' events are
    ``repro_torch.op.<op>``), in order; returns the names."""
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name == "CPU":
            events.setdefault(ev.name(), []).append(ev.start_ns())
    labels = {}
    for r in sess.records:
        label = f"{trace.NAMESPACE}.{r.name}" if r.name.startswith("op.") else r.name
        labels.setdefault(label, []).append(r.start_ns)
    for label, starts in labels.items():
        got = sorted(events.get(label, []))
        assert len(got) == len(starts), label
        assert max(abs(a - b) for a, b in zip(sorted(starts), got)) < 1e6, label
    return set(labels)


def test_span_starts_at_its_profiler_event():
    """Each recorded span's host start is within 1 ms of the start of its
    own ``record_function`` event in the profiler's trace (the op spans
    under ``repro_torch.op.<op>``)."""
    from torch.profiler import ProfilerActivity, profile

    A = _sym(N, 8)
    pl = plan(N, torch.float32, EvdConfig(b=B, nb=NB), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.is_recording()
        pl(A)
    names = _starts_match_events(trace.session(), prof)
    assert {"solve", "band_reduce", "repro_torch.op.fused_panel_update", "q1"} <= names


def test_two_traced_runs_read_their_own_sessions():
    """Two traced runs of the benchmark's cells at CPU sizes in one process:
    each reads the new per-layer metrics from its own session."""
    sys.path[:0] = [str(ROOT)]
    try:
        from evdbench import harness
    finally:
        sys.path.remove(str(ROOT))
    cpu = torch.device("cpu")
    seen = []
    for name, n in (("dense-fp32.tridiag.n4096", 64), ("dense-fp32.tridiag.n16384", 96)):
        cell = harness.find_cell(name)
        cell.traffic = {**cell.traffic, "n": n, "pool": 2}
        result, _ = harness.run_cell(name, 2 ** 31 + 5, 0.3, True, device=cpu, cell=cell)
        sess = trace.session()
        calls = sess.spans("tridiagonalize")
        assert calls and len(calls) <= cell.traffic["trace_calls"]
        metrics = result["metrics"]
        assert metrics["band_reduce_span_ms"]["value"] == pytest.approx(float(np.median(sess.ms("band_reduce"))))
        assert metrics["chase_span_ms"]["value"] == pytest.approx(float(np.median(sess.ms("chase"))))
        assert metrics["kernel_a_host_us"]["value"] == pytest.approx(
            float(np.mean(sess.host_us("op.fused_panel_update"))))
        # Every kernel-A span of the session is one of this run's traced calls.
        dec = resolve_blocking(n, device_type="cpu")
        blocks = len(build_stage_schedule(n, dec.b, dec.nb).entries)
        assert len(sess.spans("op.fused_panel_update")) == len(calls) * blocks
        seen.append(sess)
    assert seen[0].id != seen[1].id


def test_data_dependent_counts_entries_and_trips():
    with trace.recording():
        with trace.span("outer"):
            for trips in (3, 1):
                with trace.data_dependent("site/a", "no trip") as loop:
                    for _ in range(trips):
                        loop.trip()
        with trace.data_dependent("site/a", "no trip"):
            pass
    sess = trace.session()
    assert sess.counters == {"site/a.entries": 3, "site/a.trips": 4}
    assert sess.spans("outer")[0].counters == {"site/a.entries": 2, "site/a.trips": 4}
    with trace.data_dependent("site/a", "no trip") as loop:  # off: counts nothing
        loop.trip()
    assert trace.session() is sess and sess.counters["site/a.entries"] == 3


def test_device_counters_and_a_full_buffer(monkeypatch):
    with trace.recording():
        with trace.span("launch"):
            t = trace.device_counters(("k.a", "k.b"), "cpu")
            t += torch.tensor([5, 7])
        trace.count("k.a", 2)
    sess = trace.session()
    assert sess.counters == {"k.a": 7, "k.b": 7}
    assert sess.spans("launch")[0].counters == {"k.a": 5, "k.b": 7}
    monkeypatch.setattr(trace, "MAX_RECORDS", 2)
    with trace.recording():
        for _ in range(4):
            with trace.span("s"):
                pass
    sess = trace.session()
    assert len(sess.records) == 2 and sess.dropped == 2


def test_a_session_starts_when_recording_turns_on():
    with trace.recording():
        with trace.recording():  # nested: the same session
            with trace.span("a"):
                pass
            first = trace.session()
        with trace.span("b"):
            pass
    assert trace.session() is first and [r.name for r in first.records] == ["a", "b"]
    with trace.recording():
        pass
    assert trace.session() is not first and not trace.session().records


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with `python -m pytest -m cuda tests/test_torch_trace.py` on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_on_the_card(cuda_device):
    """On the card: the stage spans carry device times (CUDA events), the
    op spans host times only, and under the profiler each span starts
    within 1 ms of its own event."""
    from torch.profiler import ProfilerActivity, profile

    n = 512
    A = _sym(n, 9, cuda_device)
    tridiagonalize(A, return_reflectors=True)  # build and warm
    with trace.recording():
        tridiagonalize(A, return_reflectors=True)
    sess = trace.session()
    assert [r.name for r in sess.records if not r.name.startswith("op.")] == ["tridiagonalize", "band_reduce", "chase"]
    stages = [r for r in sess.records if not r.name.startswith("op.")]
    assert all(r.device_ms is not None and r.device_ms > 0 for r in stages)
    assert all(r.device_ms is None for r in sess.records if r.name.startswith("op."))
    top = sess.spans("tridiagonalize")[0].device_ms
    assert sess.spans("band_reduce")[0].device_ms + sess.spans("chase")[0].device_ms <= top * 1.001
    assert sess.counters["kernel_b.ops"] > 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tridiagonalize(A, return_reflectors=True)
        torch.cuda.synchronize()
    names = _starts_match_events(trace.session(), prof)
    assert {"tridiagonalize", "chase", "repro_torch.op.bulge_wavefront"} <= names


@pytest.mark.cuda
@pytest.mark.parametrize("count,n,b", [(1, 512, 8), (3, 300, 8), (2, 257, 4)])
def test_kernel_b_wait_counter_on_the_card(cuda_device, count, n, b):
    """Kernel B's counters on the card: the op count exact over a bucket,
    cycles above 0, T and the log bitwise those of a call without them."""
    from repro_torch.kernels.bulge import bulge_wavefront_cuda

    i = torch.arange(n, device=cuda_device)
    bands = torch.stack([_sym(n, n + k, cuda_device) for k in range(count)])
    bands[:, (i[:, None] - i[None, :]).abs() > b] = 0.0
    T0, l0 = bulge_wavefront_cuda(bands, b, return_log=True)
    with trace.recording():
        T1, l1 = bulge_wavefront_cuda(bands, b, return_log=True)
        T2 = bulge_wavefront_cuda(bands, b)
    c = trace.session().counters
    assert c["kernel_b.ops"] == 2 * count * sum((n - 3 - s) // b + 1 for s in range(n - 2))
    assert c["kernel_b.wait_cycles"] > 0 and c["kernel_b.op_cycles"] > 0
    assert torch.equal(T0, T1) and torch.equal(T0, T2)
    assert torch.equal(l0.vs, l1.vs) and torch.equal(l0.taus, l1.taus) and torch.equal(l0.row0, l1.row0)


@pytest.mark.cuda
def test_kernel_a_row_walk_counter_on_the_card(cuda_device):
    """Kernel A counts the panels whose GEMV walks whole rows (the range of m
    where the symmetric product is slower): one count a panel of each such
    call of a solve, none outside a recording."""
    from repro_torch.kernels import fused_panel

    n = 1024
    A = _sym(n, 10, cuda_device)
    dec = resolve_blocking(n, device_type="cuda")
    rows = fused_panel._lib()[2]
    want = sum(e.q for e in build_stage_schedule(n, dec.b, dec.nb).entries if rows(e.m))
    tridiagonalize(A)
    with trace.recording():
        tridiagonalize(A)
    assert trace.session().counters.get("kernel_a.gemv_rowwalk_panels", 0) == want
    assert not rows(128) and not rows(1 << 14)
