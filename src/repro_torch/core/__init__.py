"""The two-stage symmetric EVD pipeline of the port (fused and unfused generations)."""
from .householder import house, larft, wy_apply_left, wy_apply_right
from .panel_qr import panel_qr_geqrf, panel_qr_householder
from .band_reduction import (
    BandReflectors,
    StageEntry,
    StageSchedule,
    apply_q_left,
    band_reduce,
    build_stage_schedule,
    form_q,
)
from .bulge_chasing import (
    ChaseLog,
    band_to_tridiag,
    chase_wavefront,
    chase_wavefront_slices,
    extract_tridiag,
    max_active_sweeps,
    num_wavefronts,
)
from .tridiag_eig import eigvalsh_tridiag_range, eigvecs_inverse_iteration, sturm_count
from .backtransform import (
    apply_q2_blocked,
    apply_q_left_blocked,
    backtransform_wy_xla,
    merge_band_reflectors,
    sweep_major_log,
)

__all__ = [
    "house",
    "larft",
    "wy_apply_left",
    "wy_apply_right",
    "panel_qr_geqrf",
    "panel_qr_householder",
    "BandReflectors",
    "StageEntry",
    "StageSchedule",
    "apply_q_left",
    "band_reduce",
    "build_stage_schedule",
    "form_q",
    "ChaseLog",
    "band_to_tridiag",
    "chase_wavefront",
    "chase_wavefront_slices",
    "extract_tridiag",
    "max_active_sweeps",
    "num_wavefronts",
    "eigvalsh_tridiag_range",
    "eigvecs_inverse_iteration",
    "sturm_count",
    "apply_q2_blocked",
    "apply_q_left_blocked",
    "backtransform_wy_xla",
    "merge_band_reflectors",
    "sweep_major_log",
]
