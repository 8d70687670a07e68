#!/usr/bin/env python3
"""How far rounding moves the float32 logits of the random-weight LMs, by
depth: the yardstick for chip_smoke.py's serving gates.

    python3 scripts/serve_sensitivity.py [ARCH ...]   # from the root of a checkout; needs one card

For llama3.2-3b (batch 8 x 96 tokens) and granite-moe-3b-a800m (batch 4 x
48), or the archs named (mamba2-370m batch 4 x 132, recurrentgemma-2b
batch 2 x 96, others 4 x 48), at full width, random weights from seed 0
and the first L = 1, 2, 4, 8, 16 and all layers (recurrentgemma: whole
units), prints beside the card's name and power limit, each relative to
the largest logit of the float32 ``forward``:

* the float32 decode (``decode_step`` teacher-forced over the same tokens)
  against it;
* the same forward with flash (and SSD) chunks a third as long, and on
  half the batch (cuBLAS sums in another order);
* the forward with its embedding table moved by one ulp (each entry up
  or down at random);
* the bf16-activation decode against it: mean and max;
* for granite-moe, the float32 decode again with the forward replaying the
  decode's expert choices (``chip_smoke._moe_routing``), and how many
  (token, layer) choices the forward would have made otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("llama3.2-3b", 8, 96), ("granite-moe-3b-a800m", 4, 48))
SHAPES = {"mamba2-370m": (4, 132), "recurrentgemma-2b": (2, 96)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serve_sensitivity: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import forward, model_params, pattern_unit
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    replace = dataclasses.replace

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    cells = [(a, *SHAPES.get(a, (4, 48))) for a in sys.argv[1:]] or CELLS
    for arch, B, T in cells:
        cfg = get_config(arch)
        params = model_params(cfg, torch.Generator(device="cuda").manual_seed(0), model_axis=1, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (B, T), generator=gen, device="cuda", dtype=torch.int32)
        ulp = torch.randint(0, 2, params["embed"].shape, generator=gen, device="cuda") * 2.0 - 1
        unit = len(pattern_unit(cfg)[0])
        for L in [d * unit for d in (1, 2, 4, 8, 16) if d * unit < cfg.n_layers] + [cfg.n_layers]:
            c = replace(cfg, n_layers=L, dtype="float32", moe_impl="dense", attn_chunk=T, attn_kv_chunk=T)
            dec_cfg = replace(c, moe_impl=cfg.moe_impl)
            p = dict(params, units=tree_map(lambda t: t[: L // unit], params["units"]))
            with torch.inference_mode():
                f, _ = forward(p, c, tokens=toks)
                fc, _ = forward(p, replace(c, attn_chunk=T // 3, attn_kv_chunk=T // 3, ssm_chunk=T // 3),
                                tokens=toks)
                fh, _ = forward(p, c, tokens=toks[: B // 2])
                fu, _ = forward(dict(p, embed=p["embed"] * (1 + ulp * 2.0 ** -23)), c, tokens=toks)
                routing = []
                with cs._moe_routing(torch, record=routing) if cfg.n_experts else contextlib.nullcontext():
                    dec = cs._decode_logits(torch, p, dec_cfg, toks.clone(), T)
                d16 = cs._decode_logits(torch, p, replace(dec_cfg, dtype="bfloat16"), toks.clone(), T)
                line = (f"{arch} L={L}: decode32 vs forward {rel(dec, f):.3e}; forward with chunk {T // 3} vs "
                        f"{T} {rel(fc, f):.3e}; on {B // 2} rows vs {B} {rel(fh, f[: B // 2]):.3e}; embedding "
                        f"moved 1 ulp {rel(fu, f):.3e}; bf16 decode mean "
                        f"{float((d16 - f).abs().mean()) / float(f.abs().max()):.3e} max {rel(d16, f):.3e}")
                if cfg.n_experts:
                    flips = [0]
                    with cs._moe_routing(torch, replay=routing, n_layers=L, flips=flips):
                        fr, _ = forward(p, c, tokens=toks)
                    line += (f"; with the decode's routing replayed: decode32 vs forward {rel(dec, fr):.3e}, "
                             f"{flips[0]} of {B * T * L} choices replayed over the forward's own")
            print(line, flush=True)
            del f, fc, fh, fu, dec, d16, p
        del params, ulp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
