"""Dense MLPs: SwiGLU / GeGLU / plain GELU (port of ``repro.models.mlp``).

Under a sharding resolver each rank holds its column block of ``w_gate`` /
``w_up`` and its row block of ``w_down`` (the ``mlp`` axis): the hidden
activations stay local and the output's partial sums are reduced."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel import hints

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
    x = hints.tp_input(x, ("act_batch", "act_res_seq", None), "act_mlp")
    dt = x.dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        # jax.nn.gelu's default is the tanh approximation.
        act = F.silu(g) if cfg.mlp_act == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(x @ p["w_up"].to(dt), approximate="tanh")
    h = hints.shard_hint(h, ("act_batch", None, "act_mlp"))
    out = h @ p["w_down"].to(dt)
    return hints.shard_hint(out, ("act_batch", "act_res_seq", None), partial="act_mlp")
