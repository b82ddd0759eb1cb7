"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule: the reference's formulas (``optim/adamw.py``), on lists of
tensors.

Moments are kept in fp32 whatever the parameter dtype; the update is
computed in fp32 and cast back. Unlike the reference's pure function,
:func:`adamw_update` updates the parameters and the state in place, which
spares a second copy of the model and its moments.
"""
from __future__ import annotations

import math

import torch


def adamw_state(params) -> dict:
    """``{'m', 'v'}``: fp32 zeros shaped like ``params``; ``step`` 0."""
    return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "step": 0}


def global_norm(grads) -> torch.Tensor:
    """√(Σ g²) over every gradient, in fp32."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def cosine_schedule(step: int, *, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> float:
    """Linear warm-up from 0 over ``warmup`` steps, then a cosine decay to
    ``min_frac·base_lr`` at ``total``."""
    if step < warmup:
        return base_lr * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base_lr * (min_frac + (1 - min_frac) * 0.5
                      * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw_update(params, grads, state: dict, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 clip_norm: float = 1.0) -> torch.Tensor:
    """One AdamW step on ``params`` (in place), gradients clipped to a
    global norm of ``clip_norm``. Returns the gradients' global norm."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        g32 = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * g32 * g32)
        delta = (m / c1) / (torch.sqrt(v / c2) + eps) \
            + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    state["step"] = step
    return gnorm
