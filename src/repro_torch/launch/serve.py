"""Batched serving launcher: prefill + greedy decode over a request batch
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke \
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Random weights from ``--seed``, a batch of random prompts, a cache of
``prompt_len + gen`` positions (ring buffers of the window for
sliding-window layers), then the prompt fed by teacher-forced decode
steps (which fill the cache) and ``gen`` tokens generated greedily, all
through ``make_serve_step`` under ``torch.inference_mode()``.  Prints the
JAX launcher's three lines.  It runs on the card (``--device cuda``, the
default, which raises without one) or, when asked, on the CPU.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from repro_torch.backend import probe
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import cache_init, model_params
    from repro_torch.train import make_serve_step

    dev = probe.resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_params(cfg, gen, model_axis=1, device=dev)

    max_len = args.prompt_len + args.gen
    cache = cache_init(cfg, args.batch, max_len, device=dev)
    serve_step = make_serve_step(cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=dev, dtype=torch.int32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        # Prefill by teacher-forced decode steps (cache-populating).
        sync()
        t0 = time.perf_counter()
        for t in range(args.prompt_len):
            nxt, cache = serve_step(params, cache, prompts[:, t : t + 1])
        sync()
        t_prefill = time.perf_counter() - t0

        # Greedy generation.
        generated = []
        tok = nxt[:, None]
        t0 = time.perf_counter()
        for _ in range(args.gen):
            nxt, cache = serve_step(params, cache, tok)
            tok = nxt[:, None]
            generated.append(nxt)
        sync()
        t_gen = time.perf_counter() - t0

    out = torch.stack(generated, dim=1)
    print(f"[serve] {cfg.name}: batch={args.batch} prompt={args.prompt_len} gen={args.gen}")
    print(f"[serve] prefill {t_prefill*1e3:.1f} ms, "
          f"decode {t_gen/args.gen*1e3:.2f} ms/token/batch")
    print("[serve] sample generations:", out[:2].tolist())
    return out


if __name__ == "__main__":
    main()
