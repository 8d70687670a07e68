"""repro_torch.core — the symmetric EVD pipeline of the port.

``__all__`` is the JAX package's ``repro.core.__all__``: the Householder
helpers, panel QR, band reduction (DBR), bulge chasing, the blocked
back-transform, the direct and Jacobi baselines, the tridiagonal solvers and
the keyword wrappers over the plan API (``eigh`` ... ``inverse_pth_root``).
"""
from .householder import (
    house,
    apply_house_left,
    apply_house_right,
    apply_house_both,
    larft,
    wy_apply_left,
    wy_apply_right,
)
from .panel_qr import panel_qr, panel_qr_geqrf, panel_qr_householder
from .band_reduction import band_reduce, BandReflectors, apply_q_left, form_q
from .bulge_chasing import (
    ChaseLog,
    band_to_tridiag,
    chase_sequential,
    chase_wavefront,
    apply_q2,
    extract_tridiag,
    num_wavefronts,
    max_active_sweeps,
)
from .backtransform import (
    apply_q2_blocked,
    apply_q_left_blocked,
    backtransform_wy_xla,
    merge_band_reflectors,
    sweep_major_log,
)
from .direct_tridiag import direct_tridiagonalize, DirectReflectors, apply_q_direct
from .jacobi import jacobi_eigh, round_robin_pairs
from .tridiag_eig import (
    sturm_count,
    eigvalsh_tridiag,
    eigvalsh_tridiag_range,
    eigvecs_inverse_iteration,
    eigh_tridiag,
)
from .eigh import (
    tridiagonalize,
    eigh,
    eigvalsh,
    eigh_batched,
    eigvalsh_batched,
    inverse_pth_root,
)

__all__ = [
    "house",
    "apply_house_left",
    "apply_house_right",
    "apply_house_both",
    "larft",
    "wy_apply_left",
    "wy_apply_right",
    "panel_qr",
    "panel_qr_geqrf",
    "panel_qr_householder",
    "band_reduce",
    "BandReflectors",
    "apply_q_left",
    "form_q",
    "ChaseLog",
    "band_to_tridiag",
    "chase_sequential",
    "chase_wavefront",
    "apply_q2",
    "extract_tridiag",
    "num_wavefronts",
    "max_active_sweeps",
    "apply_q2_blocked",
    "apply_q_left_blocked",
    "backtransform_wy_xla",
    "merge_band_reflectors",
    "sweep_major_log",
    "direct_tridiagonalize",
    "DirectReflectors",
    "apply_q_direct",
    "jacobi_eigh",
    "round_robin_pairs",
    "sturm_count",
    "eigvalsh_tridiag",
    "eigvalsh_tridiag_range",
    "eigvecs_inverse_iteration",
    "eigh_tridiag",
    "tridiagonalize",
    "eigh",
    "eigvalsh",
    "eigh_batched",
    "eigvalsh_batched",
    "inverse_pth_root",
]
