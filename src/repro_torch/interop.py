"""Carry the JAX package's state across, as numpy arrays and plain dicts.

For the EVD, the carried state is the factor structures one stage hands
the next (``BandReflectors``, ``ChaseLog``, ``EvdConfig``, ``PadPolicy``);
for training, the model's weights and the optimizer's state.  These
functions turn what the JAX package produced (converted by the caller to
numpy arrays, dicts and NamedTuples, e.g. with ``jax.tree_util.tree_map(
np.asarray, tree)``) into the port's objects, and the port's trees back to
numpy, so a test can start both packages from one state.  Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from .core.band_reduction import BandReflectors
from .optim.adamw import AdamWState
from .optim.shampoo import ShampooState
from .core.bulge_chasing import ChaseLog, max_active_sweeps
from .solver.batch import PadPolicy
from .solver.config import EvdConfig, Spectrum
from .tree import tree_map

__all__ = [
    "band_reflectors",
    "chase_log",
    "evd_config",
    "pad_policy",
    "model_params",
    "to_numpy",
    "adamw_state",
    "shampoo_state",
]

# The JAX registry's backend names and their counterparts here.
_BACKENDS = {None: None, "jnp": "torch", "pallas": "cuda"}

Device = Union[str, torch.device]


def _t(x, device: Device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def band_reflectors(d: Mapping, device: Device = "cpu") -> BandReflectors:
    """``{"V", "T", "b", "blocks", "Tm"}`` -> :class:`BandReflectors`."""
    Tm = d.get("Tm")
    return BandReflectors(
        V=_t(d["V"], device),
        T=_t(d["T"], device),
        b=int(d["b"]),
        blocks=tuple((int(p0), int(q)) for p0, q in d.get("blocks", ())),
        Tm=None if Tm is None else tuple(_t(t, device) for t in Tm),
    )


def chase_log(d: Mapping, device: Device = "cpu") -> ChaseLog:
    """``{"vs", "taus", "row0", "n", "b"}`` -> :class:`ChaseLog`.

    A wavefront log of the JAX Pallas kernel has ``S*G >= A`` slots per
    wavefront; the slots past ``A = max_active_sweeps(n, b)`` must be
    inactive (``row0 == n``, ``tau == 0``) and are dropped.  The logs of
    JAX's ``chase_wavefront`` and ``chase_wavefront_slices`` have exactly A
    slots and pass unchanged.
    """
    n, b = int(d["n"]), int(d["b"])
    vs, taus, row0 = np.asarray(d["vs"]), np.asarray(d["taus"]), np.asarray(d["row0"])
    if vs.ndim == 3 and n >= 3:
        A = max_active_sweeps(n, b)
        extra_row0, extra_tau = row0[:, A:], taus[:, A:]
        if not ((extra_row0 == n).all() and (extra_tau == 0).all()):
            raise ValueError(f"log slots past A={A} must be inactive")
        vs, taus, row0 = vs[:, :A], taus[:, :A], row0[:, :A]
    return ChaseLog(
        vs=_t(vs, device),
        taus=_t(taus, device),
        row0=_t(row0, device, torch.int32),
        n=n,
        b=b,
    )


def evd_config(d: Mapping) -> EvdConfig:
    """``dataclasses.asdict(jax_config)`` -> :class:`EvdConfig`.

    The JAX backend names map to the port's: ``jnp`` -> ``torch`` (the plain
    versions), ``pallas`` -> ``cuda`` (the kernels).
    """
    fields = dict(d)
    spec = fields.pop("spectrum", None)
    backend: Optional[str] = fields.pop("backend", None)
    if backend not in _BACKENDS:
        raise ValueError(f"unknown JAX backend {backend!r}")
    return EvdConfig(
        backend=_BACKENDS[backend],
        spectrum=Spectrum(**spec) if spec is not None else Spectrum(),
        **fields,
    )


def pad_policy(d: Mapping) -> PadPolicy:
    """``dataclasses.asdict(jax_pad_policy)`` -> :class:`PadPolicy` (same
    fields and validation; ``donate`` is carried and ignored by the port)."""
    fields = dict(d)
    sizes = fields.pop("bucket_sizes", None)
    return PadPolicy(bucket_sizes=None if sizes is None else tuple(sizes), **fields)


def model_params(tree: Any, device: Device = "cpu"):
    """The JAX params tree (nested dicts of numpy arrays, stacked units and
    all) -> the port's tree: the same names, shapes and dtypes."""
    return tree_map(lambda a: _t(a, device), tree)


def to_numpy(tree: Any):
    """A port tree (params, gradients or optimizer state) -> numpy arrays,
    the same structure."""
    return tree_map(lambda t: torch.as_tensor(t).detach().cpu().numpy(), tree)


def _fields(state) -> dict:
    return state._asdict() if hasattr(state, "_asdict") else dict(state)


def adamw_state(state: Any, device: Device = "cpu") -> AdamWState:
    """JAX ``AdamWState`` (or a dict of its fields), as numpy -> the port's."""
    f = _fields(state)
    return AdamWState(step=_t(f["step"], device, torch.int32), mu=model_params(f["mu"], device),
                      nu=model_params(f["nu"], device))


def shampoo_state(state: Any, device: Device = "cpu") -> ShampooState:
    """JAX ``ShampooState`` (or a dict of its fields), as numpy -> the
    port's: step, momentum and diagonal trees, the (NB, bs, bs) statistics
    and preconditioner stacks."""
    f = _fields(state)
    return ShampooState(
        step=_t(f["step"], device, torch.int32),
        mu=model_params(f["mu"], device),
        nu=model_params(f["nu"], device),
        **{k: _t(f[k], device) for k in ("stats_l", "stats_r", "pre_l", "pre_r")},
    )
