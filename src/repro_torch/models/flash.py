"""Flash attention (chunked, online softmax) with a memory-exact backward.

Port of ``repro.models.flash`` in plain torch (the JAX module has no Pallas
kernel either).  The forward walks the key/value chunks with running
(max, sum, acc) statistics and saves only the output and the per-row
logsumexp; the backward (a ``torch.autograd.Function``) recomputes
P = exp(q k^T - lse) chunk by chunk, as ``_flash_bwd`` does, so no S x S
probabilities are kept.

Layout: q is pre-chunked (B, nq, cq, Hkv, G, hd) and pre-scaled; k/v are
(B, Skv, Hkv, hd).  Causal and sliding-window masks come from positions.
Fully-masked tiles still run.  ``softcap`` applies in the forward only;
the backward ignores its derivative, as the JAX package's does.  Dtype
casts follow the JAX module: scores and statistics in float32, the
probabilities and dS rounded to the value / key dtype before their
products (which are summed in float32).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention"]

NEG_INF = -1e30


def _mask(q_pos, k_pos, window: Optional[int]):
    """(nq, cq, ck) additive mask: causal, and within ``window`` if set."""
    ok = k_pos[None, None, :] <= q_pos[:, :, None]
    if window is not None:
        ok &= k_pos[None, None, :] > (q_pos[:, :, None] - window)
    return torch.where(ok, 0.0, NEG_INF)


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``, held in float32 for a float32 product."""
    return x.to(dtype).to(torch.float32)


def _scores(qf, k_j, q_pos, k_pos, window, softcap):
    s = torch.einsum("bnqhgk,bchk->bnhgqc", qf, k_j)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s + _mask(q_pos, k_pos, window)[None, :, None, None]


def _fwd_scan(q, k, v, ck: int, window: Optional[int], softcap: Optional[float]):
    """Returns (out fp32 (B,nq,hkv,G,cq,hd), lse fp32 (B,nq,hkv,G,cq))."""
    B, nq, cq, hkv, G, hd = q.shape
    nk = k.shape[1] // ck
    qf = q.to(torch.float32)
    dev = q.device
    q_pos = torch.arange(nq * cq, device=dev).reshape(nq, cq)
    m = torch.full((B, nq, hkv, G, cq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, nq, hkv, G, cq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nq, hkv, G, cq, hd), dtype=torch.float32, device=dev)
    for ik in range(nk):
        k_j = k[:, ik * ck : (ik + 1) * ck].to(torch.float32)
        v_j = v[:, ik * ck : (ik + 1) * ck].to(torch.float32)
        k_pos = ik * ck + torch.arange(ck, device=dev)
        s = _scores(qf, k_j, q_pos, k_pos, window, softcap)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bnhgqc,bchk->bnhgqk", _rounded(p, v.dtype), v_j)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    return acc / l_safe[..., None], m + torch.log(l_safe)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ck, window, softcap):
        out, lse = _fwd_scan(q, k, v, ck, window, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ck, ctx.window = ck, window
        return out.permute(0, 1, 4, 2, 3, 5).to(q.dtype)  # (B, nq, cq, hkv, G, hd)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        ck, window = ctx.ck, ctx.window
        B, nq, cq, hkv, G, hd = q.shape
        nk = k.shape[1] // ck
        dev = q.device
        qf = q.to(torch.float32)
        qk = _rounded(q, k.dtype)
        go = g.to(torch.float32).permute(0, 1, 3, 4, 2, 5)  # (B, nq, hkv, G, cq, hd)
        go_v = _rounded(go, v.dtype)
        D = torch.sum(go * out, dim=-1)  # rowsum(dO * O)
        q_pos = torch.arange(nq * cq, device=dev).reshape(nq, cq)
        dq = torch.zeros((B, nq, cq, hkv, G, hd), dtype=torch.float32, device=dev)
        dks, dvs = [], []
        for ik in range(nk):
            k_j = k[:, ik * ck : (ik + 1) * ck].to(torch.float32)
            v_j = v[:, ik * ck : (ik + 1) * ck].to(torch.float32)
            k_pos = ik * ck + torch.arange(ck, device=dev)
            s = _scores(qf, k_j, q_pos, k_pos, window, None)
            p = torch.exp(s - lse[..., None])  # exact probabilities
            dp = torch.einsum("bnhgqk,bchk->bnhgqc", go, v_j)
            ds = _rounded(p * (dp - D[..., None]), k.dtype)
            dq = dq + torch.einsum("bnhgqc,bchk->bnqhgk", ds, _rounded(k_j, k.dtype))
            dks.append(torch.einsum("bnhgqc,bnqhgk->bchk", ds, qk))
            dvs.append(torch.einsum("bnhgqc,bnhgqk->bchk", _rounded(p, v.dtype), go_v))
        dk = torch.cat(dks, dim=1)
        dv = torch.cat(dvs, dim=1)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(q, k, v, ck: int, window: Optional[int], softcap: Optional[float]):
    """q: (B, nq, cq, Hkv, G, hd) pre-scaled; k/v: (B, Skv, Hkv, hd).

    Returns (B, nq, cq, Hkv, G, hd) in q.dtype."""
    return _Flash.apply(q, k, v, ck, window, softcap)
