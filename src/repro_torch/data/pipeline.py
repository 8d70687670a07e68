"""Deterministic, stateless synthetic data pipeline (port of
``repro.data.pipeline``).

A batch is a pure function of (seed, step): a CPU ``torch.Generator``
seeded from the pair draws it, so a resumed run replays the exact stream
from any step (no loader state in checkpoints), and the card and the CPU
see the same tokens.  The streams are the JAX package's: repeated runs
(copy structure), arithmetic progressions mod V (positional structure) and
squared-uniform noise (Zipf-like), one per row.  The draws are torch's, not
threefry, so the tokens match the JAX package's in distribution only.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Union

import torch

from repro_torch.backend import probe

__all__ = ["DataConfig", "synthetic_batch", "host_batches", "batch_for"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_dim: int = 0  # > 0: emit precomputed frame/patch embeddings


def _generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))


def synthetic_batch(dc: DataConfig, step, device: Optional[Union[str, torch.device]] = None):
    """The batch of ``step`` on ``device`` (default ``"cuda"``, which raises
    without a card: pass ``device="cpu"``).  Returns dict(tokens, labels
    [, embeds]); tokens and labels are (B, S) int32."""
    dev = probe.resolve_device(device)
    g = _generator(dc.seed, int(step))
    B, S, V = dc.global_batch, dc.seq_len, dc.vocab

    # Stream A: repeated runs (copy structure).
    run_tok = torch.randint(0, V, (B, S // 8 + 1), generator=g)
    runs = run_tok.repeat_interleave(8, dim=1)[:, :S]
    # Stream B: arithmetic progression mod V (positional structure).
    start = torch.randint(0, V, (B, 1), generator=g)
    stride = torch.randint(1, 7, (B, 1), generator=g)
    arith = (start + stride * torch.arange(S)[None, :]) % V
    # Stream C: Zipf-ish noise via squared uniform.
    u = torch.rand((B, S), generator=g)
    noise = torch.clamp((u * u * V).to(torch.int64), max=V - 1)

    sel = torch.randint(0, 3, (B, 1), generator=g)
    tokens = torch.where(sel == 0, runs, torch.where(sel == 1, arith, noise)).to(torch.int32)
    # Next-token targets; the last position wraps (its loss weight is 0).
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    batch = {"tokens": tokens, "labels": labels}
    if dc.frontend_dim:
        batch["embeds"] = torch.randn((B, S, dc.frontend_dim), generator=g).to(torch.bfloat16)
    return {k: v.to(dev) for k, v in batch.items()}


def batch_for(dc: DataConfig, step: int):
    """Host-side convenience (numpy) — the same stream as synthetic_batch."""
    batch = synthetic_batch(dc, step, device="cpu")
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in batch.items()}


def host_batches(dc: DataConfig, start_step: int = 0) -> Iterator[dict]:
    """Resumable host iterator (start_step = checkpointed step)."""
    step = start_step
    while True:
        yield batch_for(dc, step)
        step += 1
