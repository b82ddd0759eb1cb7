"""Core layers of the port: norms, embeddings, RoPE, the plain and gated
MLPs and the NCHW convolution layer (the ones RWKV6, Whisper and Hymba
use).

Functional style, as in the reference: ``<layer>_specs(...)`` returns a
ParamSpec tree, ``<layer>_apply(params, ...)`` reads the materialized
parameters (any mapping of name → tensor).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .spec import ParamSpec


def rmsnorm_specs(d: int, *, plus_one: bool = False) -> dict:
    # gemma convention: scale parameterized around zero, applied as (1+scale)
    return {"scale": ParamSpec((d,), ("embed",),
                               init="zeros" if plus_one else "ones")}


def rmsnorm_apply(p, x: torch.Tensor, *, eps: float = 1e-6,
                  plus_one: bool = False) -> torch.Tensor:
    """RMS norm in fp32 over the last axis, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = p["scale"].float()
    if plus_one:
        scale = scale + 1.0
    return (y * scale).to(x.dtype)


def embedding_specs(vocab: int, d: int) -> dict:
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), init="embed")}


def embedding_apply(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def rope_table(positions: torch.Tensor, rot_dim: int,
               base: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (…,) → (…, rot_dim/2), fp32."""
    if rot_dim % 2:
        raise ValueError(f"rot_dim must be even, got {rot_dim}")
    inv = 1.0 / (base ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                       device=positions.device) / rot_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """Rotate the first ``rot_dim`` features of ``x`` (…, S, H, hd),
    half-split (NeoX) convention; cos/sin are (…, S, rot_dim/2) and
    broadcast over the head axis."""
    if rot_dim == 0:
        return x
    rot, rest = x[..., :rot_dim], x[..., rot_dim:]
    half = rot_dim // 2
    x1, x2 = rot[..., :half], rot[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, rest], dim=-1)


def layernorm_specs(d: int) -> dict:
    return {
        "scale": ParamSpec((d,), ("embed",), init="ones"),
        "bias": ParamSpec((d,), ("embed",), init="zeros"),
    }


def layernorm_apply(p, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in fp32 over the last axis (population variance), cast
    back to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """``x @ w (+ b)`` in ``x``'s dtype: the MLP's linear map."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def mlp_specs(d: int, ff: int, *, bias: bool = True) -> dict:
    """Plain 2-layer MLP (whisper)."""
    s = {
        "w_in": ParamSpec((d, ff), ("embed", "ff")),
        "w_out": ParamSpec((ff, d), ("ff", "embed")),
    }
    if bias:
        s["b_in"] = ParamSpec((ff,), ("ff",), init="zeros")
        s["b_out"] = ParamSpec((d,), ("embed",), init="zeros")
    return s


def mlp_apply(p, x: torch.Tensor, *, act: str = "gelu") -> torch.Tensor:
    """``act(x W_in + b_in) W_out + b_out``; gelu is the tanh form."""
    h = linear(x, p["w_in"], p.get("b_in"))
    h = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    return linear(h, p["w_out"], p.get("b_out"))


def gated_mlp_specs(d: int, ff: int) -> dict:
    """SwiGLU/GeGLU style gated MLP (Hymba)."""
    return {
        "w_gate": ParamSpec((d, ff), ("embed", "ff")),
        "w_up": ParamSpec((d, ff), ("embed", "ff")),
        "w_down": ParamSpec((ff, d), ("ff", "embed")),
    }


def gated_mlp_apply(p, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """``(act(x W_gate) ⊙ x W_up) W_down``; gelu is the tanh form."""
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    if act == "silu":
        g = F.silu(g)
    elif act == "gelu":
        g = F.gelu(g, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return (g * u) @ p["w_down"].to(x.dtype)


def conv2d_specs(c_in: int, c_out: int, k, *, bias: bool = True) -> dict:
    """NCHW 2-D convolution layer: OIHW filter + per-channel bias."""
    kh, kw = (k, k) if isinstance(k, int) else k
    s = {"w": ParamSpec((c_out, c_in, kh, kw),
                        ("conv_out", "conv_in", None, None))}
    if bias:
        s["b"] = ParamSpec((c_out,), ("conv_out",), init="zeros")
    return s


def conv2d_apply(p, x: torch.Tensor, *, mode: str = "same", stride=1,
                 activation: str | None = None,
                 strategy: str | None = None) -> torch.Tensor:
    """NCHW convolution through the engine's reduce-axes plan:
    ``x (B, C_in, H, W) → (B, C_out, H', W')``. The per-channel bias and
    ``activation`` ('gelu'/'silu'/'relu') are the kernel's fused
    epilogue, and a stride computes only the kept outputs. ``strategy``
    picks the lowering on the card: None, 'auto' or 'lanes' K1, 'mxu'
    K2 (the im2row contraction on the tensor cores). Differentiable: the
    backward runs the adjoint plans (``dx`` under the same strategy, K3
    for ``dW``)."""
    from ..kernels import ops

    epilogue, args = [], []
    if "b" in p:
        epilogue.append("bias")
        args.append(p["b"])
    if activation is not None:
        epilogue.append(activation)
    return ops.conv2d(x, p["w"], mode=mode, stride=stride,
                      epilogue=tuple(epilogue) or None, epilogue_args=args,
                      strategy=strategy)
