"""Core layers of the port: RMS norm and embeddings (the ones RWKV6 uses).

Functional style, as in the reference: ``<layer>_specs(...)`` returns a
ParamSpec tree, ``<layer>_apply(params, ...)`` reads the materialized
parameters (any mapping of name → tensor).
"""
from __future__ import annotations

import torch

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
