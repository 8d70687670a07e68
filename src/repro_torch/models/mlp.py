"""Dense MLPs: SwiGLU / GeGLU / plain GELU (port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamMeta

__all__ = ["mlp_meta", "mlp_forward"]


def mlp_meta(cfg: ModelConfig, pdtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {
            "w_gate": ParamMeta((d, f), pdtype, ("embed", "mlp")),
            "w_up": ParamMeta((d, f), pdtype, ("embed", "mlp")),
            "w_down": ParamMeta((f, d), pdtype, ("mlp", "embed")),
        }
    return {
        "w_up": ParamMeta((d, f), pdtype, ("embed", "mlp")),
        "w_down": ParamMeta((f, d), pdtype, ("mlp", "embed")),
    }


def mlp_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        # jax.nn.gelu's default is the tanh approximation.
        act = F.silu(g) if cfg.mlp_act == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(x @ p["w_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt)
