"""The panel QR: plain version and the launcher of kernel E.

:func:`panel_qr_body` (port of ``repro.kernels.panel.panel_qr_body``) is the
column recurrence of ``csrc/panel_qr_cluster.cuh`` written as tensor code: b
Householder steps, then the ``larft`` T recurrence.  With LAPACK signs
(beta = -sign(alpha)·|x|) it is the plain version of kernel A's panel phase
(``csrc/fused_panel.cu``); with ``lapack_sign=False`` (beta = +|x|) it is
the plain version of kernel E, :func:`panel_qr_cuda` (``csrc/panel.cu``),
which replaces ``repro.kernels.panel.panel_qr_pallas``.  Both kernels run
the same QR across the CTAs of one thread-block cluster, each CTA a slice
of the panel's rows; :func:`cluster_size` is kernel E's rule for its size.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib
from .limits import limit

__all__ = ["panel_qr_body", "panel_qr_cuda", "panel_qr_cuda_cluster", "cluster_size", "launch_plan", "MAX_B"]

MAX_B = 32
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P]
_PLAN_ARGTYPES = [_I, _I, _I, _I, ctypes.POINTER(_I)]
# Kernel E takes a CTA per _ROWS_PER_CTA panel rows, up to 16: its time is
# ~28 us of exchanges plus a pass over the slice per step, and on the H100
# the fastest cluster (chip_smoke.py phase 2 sweeps 1-16 CTAs) held about
# 128 rows a CTA from m = 256 to m = 2048, and was 16 CTAs above.
_ROWS_PER_CTA = 128


def panel_qr_body(A: torch.Tensor, b: int, *, lapack_sign: bool = True):
    """Householder QR of the (m, b) panel ``A``.  Returns ``(V, T, taus, R)``.

    ``lapack_sign=True`` is LAPACK ``larfg`` (the sign the fused first stage
    uses); ``False`` is the JAX package's historical beta = +|x|.
    """
    m = A.shape[0]
    A = A.clone()
    dtype, dev = A.dtype, A.device
    rows = torch.arange(m, device=dev)
    V = torch.zeros((m, b), dtype=dtype, device=dev)
    taus = torch.zeros((b,), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    for j in range(b):
        colv = A[:, j]
        alpha = colv[j]
        sigma = torch.where(rows > j, colv * colv, 0.0).sum()
        mu = torch.sqrt(alpha * alpha + sigma)
        degenerate = sigma == 0
        if lapack_sign:
            sign_a = torch.where(alpha >= 0, 1.0, -1.0).to(dtype)
            beta_nd = -sign_a * mu
            safe_beta = torch.where(beta_nd == 0, one, beta_nd)
            tau = torch.where(degenerate, 0.0, (beta_nd - alpha) / safe_beta)
            beta = torch.where(degenerate, alpha, beta_nd)
            denom = alpha - beta_nd
            v0_safe = torch.where(denom == 0, one, denom)
        else:
            safe_denom = torch.where(alpha + mu == 0, one, alpha + mu)
            v0 = torch.where(alpha <= 0, alpha - mu, -sigma / safe_denom)
            v0_safe = torch.where(degenerate, one, v0)
            tau = torch.where(
                degenerate, 0.0, 2.0 * v0_safe * v0_safe / (sigma + v0_safe * v0_safe)
            )
            beta = torch.where(degenerate, alpha, mu)
        v = torch.where(rows == j, 1.0, torch.where(rows > j, colv / v0_safe, 0.0))
        wv = v @ A[:, j:]
        A[:, j:] -= tau * torch.outer(v, wv)
        A[:, j] = torch.where(rows == j, beta, torch.where(rows < j, A[:, j], 0.0))
        V[:, j] = v
        taus[j] = tau
    VtV = V.T @ V
    T = torch.zeros((b, b), dtype=dtype, device=dev)
    for j in range(b):
        if j:
            T[:j, j] = -taus[j] * (T[:j, :j] @ VtV[:j, j])
        T[j, j] = taus[j]
    return V, T, taus, A[:b, :].clone()


@functools.cache
def _lib(fn_name: str = "panel_qr_launch"):
    fn = getattr(cuda_lib.library("panel"), fn_name)
    fn.argtypes = _ARGTYPES if fn_name == "panel_qr_launch" else _PLAN_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def cluster_size(m: int) -> int:
    """CTAs of kernel E's cluster for an (m, b) panel: at least
    ``_ROWS_PER_CTA`` rows each, at most ``PANEL_QR_CLUSTER``."""
    return max(1, min(limit("PANEL_QR_CLUSTER"), -(-m // _ROWS_PER_CTA)))


# (device, m, b, PANEL_QR_SMEM, CTAs asked) -> launch_plan's answer.
_PLANS: dict = {}


def launch_plan(m: int, b: int, cluster: int):
    """``(CTAs, in_smem)``: the cluster size kernel E runs an (m, b) panel
    with on the current card when asked for ``cluster`` CTAs (``cluster``,
    or 8 where the card cannot co-schedule more), and whether its slices
    fit shared memory.  Asks the card once per shape (needs the card)."""
    smem = limit("PANEL_QR_SMEM")
    key = (torch.cuda.current_device(), m, b, smem, cluster)
    plan = _PLANS.get(key)
    if plan is None:
        in_smem = ctypes.c_int()
        cs = _lib("panel_qr_plan")(m, b, smem, cluster, ctypes.byref(in_smem))
        if cs < 1:
            raise RuntimeError(f"panel_qr: no launch plan for ({m}, {b}) on {cluster} CTAs")
        plan = _PLANS[key] = (cs, bool(in_smem.value))
    return plan


def panel_qr_cuda(panel: torch.Tensor):
    """Kernel E: Householder QR (beta = +|x|) of a float32 CUDA panel
    (m, b), m >= b, b <= 32.  Returns new ``(V, T, taus, R)``, the contract
    of ``panel_qr_body(panel, b, lapack_sign=False)``."""
    _check(panel)
    return panel_qr_cuda_cluster(panel, cluster_size(panel.shape[0]))


def _check(panel: torch.Tensor) -> None:
    if not panel.is_cuda:
        raise ValueError(f"panel_qr_cuda needs a CUDA tensor, got {panel.device}")
    if panel.dtype != torch.float32:
        raise ValueError(f"panel_qr_cuda takes float32, got {panel.dtype}")
    if panel.ndim != 2 or not (1 <= panel.shape[1] <= MAX_B) or panel.shape[0] < panel.shape[1]:
        raise ValueError(f"expected an (m, b) panel with m >= b and 1 <= b <= {MAX_B}, got {tuple(panel.shape)}")


def panel_qr_cuda_cluster(panel: torch.Tensor, cluster: int):
    """:func:`panel_qr_cuda` on a cluster of ``cluster`` CTAs (1 to 16; 8
    where the card cannot co-schedule more) instead of :func:`cluster_size`'s."""
    _check(panel)
    if not 1 <= cluster <= 16:
        raise ValueError(f"cluster must be 1 to 16 CTAs, got {cluster}")
    m, b = panel.shape
    panel = panel.contiguous()
    kw = dict(dtype=torch.float32, device=panel.device)
    V = torch.empty((m, b), **kw)
    T = torch.empty((b, b), **kw)
    taus = torch.empty((b,), **kw)
    R = torch.empty((b, b), **kw)
    with torch.cuda.device(panel.device):
        cs, in_smem = launch_plan(m, b, cluster)
        # The slices' global workspace, only where they leave shared memory.
        work = None if in_smem else torch.empty((m + cs, b), **kw)
        err = _lib()(
            panel.data_ptr(), m, b, V.data_ptr(), T.data_ptr(), taus.data_ptr(), R.data_ptr(),
            None if work is None else work.data_ptr(), limit("PANEL_QR_SMEM"), cs,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "panel_qr")
    cuda_lib.count("panel_qr", 1)
    return V, T, taus, R
