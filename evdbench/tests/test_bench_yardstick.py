"""The frozen work formulas equal the port's ``kernels/work.py`` at every
cell's shapes, as of the commit that froze them."""
import json

import pytest

from bench_small import ROOT

from evdbench.yardstick import peaks, work as frozen


def same(a, b):
    return (a.bytes, a.flops) == (b.bytes, b.flops)


def _cells():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        yield w["name"], json.loads((ROOT / "evdbench" / "traffic" / f"{w['traffic']}.json").read_text())["n"]


@pytest.mark.parametrize("name,n", list(_cells()))
def test_frozen_formulas_equal_the_ports(name, n):
    from repro_torch.core.band_reduction import build_stage_schedule
    from repro_torch.kernels import work
    from repro_torch.solver import resolve_blocking

    dec = resolve_blocking(n, device_type="cuda")
    b, nb = dec.b, dec.nb
    blocks = peaks.dbr_blocks(n, b, nb)
    assert blocks == [(e.m, e.w) for e in build_stage_schedule(n, b, nb).entries]
    for m, w in blocks:
        for bt in (1, 2):
            assert same(frozen.fused_panel_update(m, w, b, batch=bt), work.fused_panel_update(m, w, b, batch=bt))
            assert same(frozen.syr2k(m - w, w, batch=bt), work.syr2k(m - w, w, batch=bt))
        assert same(frozen.panel_qr(m - b, b), work.panel_qr(m - b, b))
    for bt in (1, 2):
        for log in (True, False):
            assert same(frozen.bulge_wavefront(n, b, log=log, batch=bt), work.bulge_wavefront(n, b, log=log, batch=bt))
    assert frozen.chase_ops(n, b) == work.chase_ops(n, b)
    from repro_torch.core.backtransform import _sweep_shape

    S, K = _sweep_shape(n, b)
    assert same(frozen.backtransform_wy(n, n, S, K, b, batch=2), work.backtransform_wy(n, n, S, K, b, batch=2))


def test_bound_is_the_larger_of_bytes_and_operations():
    w = frozen.Work(3.35e12, ((67e12, "fp32"),))
    assert peaks.bound_s(w) == pytest.approx(1.0)
    w = frozen.Work(0.0, ((494.7e12, "tf32x3"),))
    assert peaks.bound_s(w) == pytest.approx(3.0)
