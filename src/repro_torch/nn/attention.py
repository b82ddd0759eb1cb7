"""Attention of the port: the multi-head subset Whisper trains with.

The reference keeps attention in XLA (it has no Pallas kernel), so plain
torch is a faithful port: projections with biases (:func:`gqa_specs`),
the un-chunked softmax (:func:`mha_direct`) and the masked online-softmax
form (:func:`mha_chunked`, O(block_q·block_kv) live logits, each key
block recomputed on the backward pass as the reference's
``jax.checkpoint`` does). Sliding windows, MLA and KV caches are not
ported yet (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .spec import ParamSpec

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


def gqa_specs(d: int, n_heads: int, kv_heads: int, head_dim: int,
              *, bias: bool = False) -> dict:
    s = {
        "wq": ParamSpec((d, n_heads, head_dim),
                        ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv_heads, head_dim),
                        ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv_heads, head_dim),
                        ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((n_heads, head_dim, d),
                        ("heads", "head_dim", "embed")),
    }
    if bias:
        s["bq"] = ParamSpec((n_heads, head_dim), ("heads", "head_dim"),
                            init="zeros")
        s["bk"] = ParamSpec((kv_heads, head_dim), ("kv_heads", "head_dim"),
                            init="zeros")
        s["bv"] = ParamSpec((kv_heads, head_dim), ("kv_heads", "head_dim"),
                            init="zeros")
        s["bo"] = ParamSpec((d,), ("embed",), init="zeros")
    return s


def _mask(q_pos, kv_pos):
    """Causal mask ``kv_pos <= q_pos`` (all-global attention: the
    reference's window term is always true). ``(Sq, Skv)``."""
    return kv_pos[None, :] <= q_pos[:, None]


def mha_direct(q, k, v, q_pos, kv_pos, *, scale=None):
    """Un-chunked attention. q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd);
    heads grouped ``G = H // KV`` per key head."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgh,btkh->bkgqt", qg.to(acc), k.to(acc)) * scale
    logits = torch.where(_mask(q_pos, kv_pos), logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,btkh->bkgqh", p.to(v.dtype).to(acc), v.to(acc))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1])
    return out.to(q.dtype)


def _kv_block(q_i, k_j, v_j, mask, m, l, acc, scale):
    logits = torch.einsum("bqkgh,btkh->bkgqt", q_i, k_j) * scale
    logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(-1))
    p = torch.exp(logits - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum("bkgqt,btkh->bkgqh", p, v_j)
    return m_new, l_new, acc_new


def mha_chunked(q, k, v, q_pos, kv_pos, *, block_q: int = 512,
                block_kv: int = 1024, scale=None):
    """Masked online-softmax attention over ``(block_q, block_kv)`` tiles,
    in fp32 (fp64 for fp64 inputs); padded queries see nothing and padded
    keys are never seen."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    dv = v.shape[-1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    acc = torch.promote_types(q.dtype, torch.float32)
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    nq, nkv = -(-Sq // bq), -(-Skv // bkv)
    qp = F.pad(q.to(acc), (0, 0, 0, 0, 0, nq * bq - Sq))
    kp = F.pad(k.to(acc), (0, 0, 0, 0, 0, nkv * bkv - Skv))
    vp = F.pad(v.to(acc), (0, 0, 0, 0, 0, nkv * bkv - Skv))
    qpos = F.pad(q_pos, (0, nq * bq - Sq), value=-1)
    kpos = F.pad(kv_pos, (0, nkv * bkv - Skv), value=INT32_MAX)
    outs = []
    for i in range(nq):
        q_i = qp[:, i * bq:(i + 1) * bq].reshape(B, bq, KV, G, hd)
        m = qp.new_full((B, KV, G, bq), NEG_INF)
        l = qp.new_zeros((B, KV, G, bq))
        o = qp.new_zeros((B, KV, G, bq, dv))
        for j in range(nkv):
            mask = _mask(qpos[i * bq:(i + 1) * bq],
                         kpos[j * bkv:(j + 1) * bkv])
            args = (q_i, kp[:, j * bkv:(j + 1) * bkv],
                    vp[:, j * bkv:(j + 1) * bkv], mask, m, l, o, scale)
            if torch.is_grad_enabled():
                m, l, o = checkpoint(_kv_block, *args, use_reentrant=False)
            else:
                m, l, o = _kv_block(*args)
        outs.append(o / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs, dim=1)                  # (B, nq, KV, G, bq, dv)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * bq, H, dv)[:, :Sq]
    return out.to(q.dtype)
