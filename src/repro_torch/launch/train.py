"""End-to-end training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \
        --steps 200 --batch 8 --seq 128 --optimizer shampoo [--device cpu]

The JAX launcher's flags and composition: config, random weights from
``--seed``, ``warmup_cosine``, AdamW or ``shampoo(ShampooOptions(block_size
=32, update_interval=10))``, the synthetic stream, ``make_train_step`` and
``TrainLoop`` with checkpoints every quarter of the run.  It runs on the
card (``--device cuda``, the default, which raises without one) or, when
asked, on the CPU.  ``--optimizer shampoo`` runs the EVD solver in the
loop: on the card its refresh is kernels A, B and C.

``--model-axis m`` shards the model over ``make_local_mesh(model=m)``, a
``(world // m, m)`` mesh over ``("data", "model")`` of the initialized
world: ``make_policy(mesh, cfg, fsdp=True)``, ``attn_shard_mode`` /
``moe_shard_mode`` from ``resolve_attn_mode`` / ``resolve_moe_mode`` (as
the JAX dry-run sets them), the weights cut by ``shard_params``, each rank
fed its rows of the global batch.  The launcher joins a world that is
already initialized (``torchrun``'s, from ``WORLD_SIZE`` / ``RANK``, or one
from ``repro_torch.parallel.run_ranks``); the backend is picked, NCCL when
every rank has a card of its own and gloo otherwise
(``comm.init_world``).  Only rank 0 logs and writes checkpoints.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-3b \
        --smoke --steps 20 --model-axis 2 [--device cpu]
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

    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.backend import probe
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model_meta, model_params
    from repro_torch.parallel import comm, make_policy, resolve_attn_mode, resolve_moe_mode, shard_params
    from repro_torch.optim import ShampooOptions, adamw, shampoo, warmup_cosine
    from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_step
    from repro_torch.train.step import init_opt_state

    dev = probe.resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sharded = comm.init_world(dev.type)
    if args.model_axis > 1 and not sharded:
        raise RuntimeError(
            f"--model-axis {args.model_axis} shards the model over ranks, and no torch.distributed world is "
            f"initialized: start one rank per device, e.g. torchrun --nproc-per-node {args.model_axis} -m "
            "repro_torch.launch.train ... (or call main() from ranks of repro_torch.parallel.run_ranks)")
    rank = dist.get_rank() if sharded else 0
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    policy = None
    if sharded:
        mesh = make_local_mesh(args.model_axis, device_type=dev.type)
        cfg = dataclasses.replace(cfg, attn_shard_mode=resolve_attn_mode(cfg, args.model_axis),
                                  moe_shard_mode=resolve_moe_mode(cfg, args.model_axis))
        policy = make_policy(mesh, cfg, fsdp=True)
    params = model_params(cfg, gen, model_axis=args.model_axis, device=dev)
    if policy is not None:
        params = shard_params(params, policy.param_shardings(model_meta(cfg, args.model_axis)))

    sched = warmup_cosine(args.lr, warmup=max(args.steps // 20, 1), total=args.steps)
    if args.optimizer == "shampoo":
        opt = shampoo(sched, opts=ShampooOptions(block_size=32, update_interval=10))
    else:
        opt = adamw(sched)
    opt_state = init_opt_state(opt, params)

    dc = DataConfig(
        vocab=cfg.vocab,
        seq_len=args.seq,
        global_batch=args.batch,
        seed=args.seed,
        frontend_dim=cfg.frontend_dim if cfg.frontend else 0,
    )
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches, policy=policy)
    rows = lambda b: b
    if policy is not None:  # this rank's rows of the global batch
        res = policy.resolver()
        n, i = res.size("act_batch"), res.index("act_batch")
        if args.batch % n:
            raise ValueError(f"--batch {args.batch} is not divisible by the {n} data-parallel ranks")
        rows = lambda b: {k: v[i * args.batch // n:(i + 1) * args.batch // n] for k, v in b.items()}
    loop = TrainLoop(
        step_fn,
        lambda s: rows(synthetic_batch(dc, s, device=dev)),
        TrainLoopConfig(
            total_steps=args.steps,
            ckpt_every=max(args.steps // 4, 1),
            log_every=args.log_every,
            ckpt_dir=args.ckpt_dir,
        ),
        log_fn=print if rank == 0 else (lambda msg: None),
    )
    params, opt_state, history = loop.run(params, opt_state)
    if rank == 0:
        where = f" on {dist.get_world_size()} ranks, model axis {args.model_axis}" if sharded else ""
        print(f"[train] {cfg.name} on {probe.device_name(dev)}{where}: {len(history)} steps, "
              f"loss {history[0]:.4f} -> {history[-1]:.4f}")
    return history


if __name__ == "__main__":
    main()
