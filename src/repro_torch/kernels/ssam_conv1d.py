"""SSAM depthwise causal 1-D convolution as a plan over the engine.

The short depthwise convolution of Mamba-style blocks (Hymba's Mamba
branch). The plan (:func:`repro_torch.core.plan.depthwise_conv1d_plan`)
maps channels to the lane axis and time to rows, so the taps walk the
vertical, in-thread direction (the paper's §5.4): no lane shifts at all,
M = 1. Causality is the plan's ``K − 1`` lead rows. On a CUDA tensor the
engine launches K1's per-lane path (``csrc/ssam_window_perlane.cu``), or
K2's (``csrc/ssam_mxu_perlane.cu``) for a plan with ``strategy='mxu'``,
on a CPU tensor their plain versions.
"""
from __future__ import annotations

import torch

from ..core.engine import run_window_plan
from ..core.plan import depthwise_conv1d_plan

BLOCK = (128, 128)            # the reference's (block_t, block_d) default


def plan_for(K: int):
    """The D-optimal depthwise plan for a length-``K`` filter."""
    return depthwise_conv1d_plan(K)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, *,
                  block_t: int = BLOCK[0],
                  block_d: int = BLOCK[1]) -> torch.Tensor:
    """Depthwise causal conv: ``y[b,t,d] = Σ_k x[b, t−K+1+k, d]·w[k, d]``.

    Args:
      x: ``(B, T, D)`` input.
      w: ``(K, D)`` per-channel filter taps (tap K−1 multiplies x[t]).
    """
    K, Dw = w.shape
    if Dw != x.shape[-1]:
        raise ValueError(f"filter lanes {tuple(w.shape)} do not match input "
                         f"channels {tuple(x.shape)}")
    return run_window_plan(x, w, plan=plan_for(K), block=(block_t, block_d))
