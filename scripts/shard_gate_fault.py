#!/usr/bin/env python3
"""Whether chip_smoke.py phase 12's float32 weight gate fails a wrong sharded step.

    python3 scripts/shard_gate_fault.py      # from the root of a checkout; needs a card

Four gloo ranks share the card on a (2, 2) ("data", "model") mesh, as in
phase 12.  Each runs phase 12's float32 llama3.2-3b case (1 layer,
8 x 128, ``make_policy(mesh, cfg, fsdp=True, sequence_parallel=True)``)
through ``chip_smoke._shard_case`` twice: as the port computes it, and
with a planted fault, the norm scales' gradient sum over the model axis
dropped (``hints.shared_param`` for ``"act_res_seq"`` made the identity
inside this process only), so each model rank keeps the gradient of its
own rows of the sequence.  Prints both runs' tightest leaves under
phase 12's two float32 gates (``chip_smoke.shard_leaf_gate`` on the
weights and on the momentum) and exits 0 only if the right step passes
both and the wrong one fails them.  Prints the card's name and power
limit first.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _rank():
    import torch

    import chip_smoke as cs
    from repro_torch.launch import make_local_mesh
    from repro_torch.parallel import hints, make_policy, resolve_attn_mode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_local_mesh(2)
    arch, layers, batch, seq = cs.SHARD_DENSE
    mode = resolve_attn_mode(cs._shard_cfg(arch, layers, "float32"), 2)
    cfg = cs._shard_cfg(arch, layers, "float32", attn_shard_mode=mode)
    policy = make_policy(mesh, cfg, fsdp=True, sequence_parallel=True)
    out = {}
    for key in ("right", "fault"):
        if key == "fault":
            shared = hints.shared_param
            hints.shared_param = lambda p, work: p if work == "act_res_seq" else shared(p, work)
        rec = cs._shard_case(torch, f"shard_gate_fault {key}", cfg, policy, batch, seq, 1, momentum=True)
        out[key] = {k: rec[k] for k in ("losses", "ref_losses", "leaf_gate", "mu_gate") if k in rec}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("shard_gate_fault: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.parallel import run_ranks

    print(f"card: {cs.card_line()}; torch {torch.__version__} CUDA {torch.version.cuda}")
    res = run_ranks(_rank, cs.SHARD_RANKS, backend="gloo", device_type="cuda", timeout_s=600)[0]
    verdict = {}
    for key, rec in res.items():
        loss_rel = abs(rec["losses"][0] - rec["ref_losses"][0]) / abs(rec["ref_losses"][0])
        print(f"{key}: loss rel {loss_rel:.3e} (tol {cs.TOL_SHARD_LOSS:.0e})")
        for gate in ("leaf_gate", "mu_gate"):
            rows = rec[gate]
            verdict[key, gate] = all(r["err"] < r["tol"] for r in rows)
            what = "weights, err against one process" if gate == "leaf_gate" else "momentum, err against float64"
            print(f"  {gate} ({what}) passes: {verdict[key, gate]}; "
                  f"tightest leaves (path, err, one process vs float64, tol):")
            for r in rows[:4]:
                print(f"    {r['path']}  {r['err']:.3e}  {r['noise']:.3e}  {r['tol']:.3e}")
    ok = all(verdict["right", g] and not verdict["fault", g] for g in ("leaf_gate", "mu_gate"))
    print(f"both gates pass the right step and fail the wrong one: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
