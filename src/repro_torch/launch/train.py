"""End-to-end training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \
        --steps 200 --batch 8 --seq 128 --optimizer shampoo [--device cpu]

The JAX launcher's flags and composition: config, random weights from
``--seed``, ``warmup_cosine``, AdamW or ``shampoo(ShampooOptions(block_size
=32, update_interval=10))``, the synthetic stream, ``make_train_step`` and
``TrainLoop`` with checkpoints every quarter of the run.  It runs on the
card (``--device cuda``, the default, which raises without one) or, when
asked, on the CPU.  ``--optimizer shampoo`` runs the EVD solver in the
loop: on the card its refresh is kernels A, B and C.  ``--model-axis`` > 1
(a device mesh) is not ported yet.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "shampoo"])
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--model-axis", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from repro_torch.backend import probe
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.models import model_params
    from repro_torch.optim import ShampooOptions, adamw, shampoo, warmup_cosine
    from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step

    if args.model_axis > 1:
        raise NotImplementedError(
            "--model-axis > 1 shards the model over a device mesh, which is not ported yet: "
            "ROADMAP Queue 1 item 12(b) (model sharding)"
        )
    dev = probe.resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_params(cfg, gen, model_axis=args.model_axis, device=dev)

    sched = warmup_cosine(args.lr, warmup=max(args.steps // 20, 1), total=args.steps)
    if args.optimizer == "shampoo":
        opt = shampoo(sched, opts=ShampooOptions(block_size=32, update_interval=10))
    else:
        opt = adamw(sched)
    opt_state = opt.init(params)

    dc = DataConfig(
        vocab=cfg.vocab,
        seq_len=args.seq,
        global_batch=args.batch,
        seed=args.seed,
        frontend_dim=cfg.frontend_dim if cfg.frontend else 0,
    )
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    loop = TrainLoop(
        step_fn,
        lambda s: synthetic_batch(dc, s, device=dev),
        TrainLoopConfig(
            total_steps=args.steps,
            ckpt_every=max(args.steps // 4, 1),
            log_every=args.log_every,
            ckpt_dir=args.ckpt_dir,
        ),
    )
    params, opt_state, history = loop.run(params, opt_state)
    print(f"[train] {cfg.name} on {probe.device_name(dev)}: {len(history)} steps, "
          f"loss {history[0]:.4f} -> {history[-1]:.4f}")
    return history


if __name__ == "__main__":
    main()
