"""Attention of the port: grouped-query attention with sliding windows,
the training path of Whisper and Hymba.

The reference keeps attention in XLA (it has no Pallas kernel), so plain
torch is a faithful port: projections with optional biases
(:func:`gqa_specs`), RoPE, the window mask ``causal ∧ (global ∨ dist <
window)``, the un-chunked softmax (:func:`mha_direct`) and the masked
online-softmax form (:func:`mha_chunked`, O(block_q·block_kv) live
logits, each key block recomputed on the backward pass as the
reference's ``jax.checkpoint`` does), and :func:`gqa_apply` without a
cache. KV caches (decode) and MLA are not ported yet (ROADMAP Queue 1
item 9).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import apply_rope, rope_table
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


def _window_mask(q_pos, kv_pos, window, is_global):
    """``causal ∧ (global ∨ within the sliding window)``, ``(Sq, Skv)``:
    ``kv_pos <= q_pos`` and ``q_pos − kv_pos < window`` unless the layer
    is global. ``window=None`` is all-global."""
    causal = kv_pos[None, :] <= q_pos[:, None]
    if window is None or is_global:
        return causal
    return causal & (q_pos[:, None] - kv_pos[None, :] < window)


def mha_direct(q, k, v, q_pos, kv_pos, *, window=None, is_global=True,
               scale=None):
    """Un-chunked attention. q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd);
    heads grouped ``G = H // KV`` per key head; the mask of
    :func:`_window_mask`."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgh,btkh->bkgqt", qg.to(acc), k.to(acc)) * scale
    logits = torch.where(_window_mask(q_pos, kv_pos, window, is_global),
                         logits, NEG_INF)
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


def mha_chunked(q, k, v, q_pos, kv_pos, *, window=None, is_global=True,
                block_q: int = 512, block_kv: int = 1024, scale=None):
    """Masked online-softmax attention over ``(block_q, block_kv)`` tiles,
    in fp32 (fp64 for fp64 inputs), under the mask of
    :func:`_window_mask`; padded queries see nothing and padded keys are
    never seen."""
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
            mask = _window_mask(qpos[i * bq:(i + 1) * bq],
                                kpos[j * bkv:(j + 1) * bkv], window,
                                is_global)
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


@dataclasses.dataclass
class AttnConfig:
    """The reference's ``AttnConfig`` fields that :func:`gqa_apply` reads
    (its qk-norm, bias flag and decode-cache sharding are not ported)."""

    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    rope_base: float = 10000.0
    window: int = 0                     # 0 = always global
    block_q: int = 512
    block_kv: int = 1024


def gqa_apply(p, x: torch.Tensor, cfg: AttnConfig, *, positions,
              is_global: bool = True, cache=None):
    """GQA attention over x (B, S, d) with RoPE and the sliding-window mask
    of :func:`_window_mask`: the un-chunked softmax up to 1024 positions,
    :func:`mha_chunked` beyond, as in the reference. Returns ``(out,
    None)``; a decode ``cache`` is not ported yet and raises."""
    if cache is not None:
        raise NotImplementedError(
            "gqa_apply with a KV cache (decode) is not ported yet: Hymba "
            "serving, ROADMAP Queue 1 item 9")
    S = x.shape[1]
    hd = cfg.head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    cos, sin = rope_table(positions, hd, cfg.rope_base)
    q = apply_rope(q, cos, sin, hd)
    k = apply_rope(k, cos, sin, hd)
    window = cfg.window if cfg.window > 0 else INT32_MAX
    if S > 1024:
        out = mha_chunked(q, k, v, positions, positions, window=window,
                          is_global=is_global, block_q=cfg.block_q,
                          block_kv=cfg.block_kv)
    else:
        out = mha_direct(q, k, v, positions, positions, window=window,
                         is_global=is_global)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if "bo" in p:
        y = y + p["bo"].to(x.dtype)
    return y, None
