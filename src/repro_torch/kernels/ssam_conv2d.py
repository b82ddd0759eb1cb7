"""SSAM 2-D convolution — the paper's Listing 1 as a plan over the engine.

The image x-axis is the lane axis, the M filter columns are the systolic
steps (partial sums move one lane per step), and each step accumulates
the N vertical taps of its filter column against the runtime ``(N, M)``
filter.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.engine import run_window_plan
from ..core.plan import (PerImageFilterPlan, SystolicPlan,
                         conv2d_batched_plan, conv2d_nchw_plan, conv2d_plan,
                         conv2d_same_plan)


def plan_for(w_shape: tuple[int, int], mode: str = "valid"):
    """The systolic plan for an ``(N, M)`` filter; 'same' folds the
    centre-anchor boundary into the plan's lead/trail."""
    N, M = w_shape
    return conv2d_same_plan(M, N) if mode == "same" else conv2d_plan(M, N)


def plan_for_batched(w_shape: tuple[int, int], mode: str = "valid"):
    """Batched single-channel plan for a ``(B, H, W)`` image stack."""
    N, M = w_shape
    return conv2d_batched_plan(M, N, mode=mode)


def plan_for_depthwise(w_shape: tuple[int, int], mode: str, channels: int):
    """The depthwise plan of ``channels`` channels for ``(N, M)`` filters:
    the batched single-channel plan over the ``B·channels`` images of an
    NCHW input viewed as ``(B·C, H, W)``, image ``i`` against filter ``i
    mod channels`` (:class:`~repro_torch.core.plan.PerImageFilterPlan`),
    so one launch runs every channel."""
    base = plan_for_batched(w_shape, mode)
    return PerImageFilterPlan(
        **{f.name: getattr(base, f.name)
           for f in dataclasses.fields(SystolicPlan)}, filters=channels)


def plan_for_nchw(x_shape, w_shape, mode: str = "valid", groups: int = 1):
    """Reduce-axes plan for an NCHW minibatch against an OIHW filter.

    ``groups > 1`` checks that both channel counts divide evenly and
    describes one group's reduce sweep: ``ops.conv2d(groups=)`` runs it
    on each group's slice of the operands.
    """
    B, C_in = x_shape[:2]
    C_out, C_in_w, N, M = w_shape
    if C_in_w * groups != C_in:
        raise ValueError(
            f"conv2d: filter expects C_in={C_in_w * groups} "
            f"({C_in_w} per group × {groups}) but input has C_in={C_in} "
            f"(x {tuple(x_shape)}, w {tuple(w_shape)})")
    return conv2d_nchw_plan(B, C_in, C_out, M, N, mode=mode, groups=groups)


def conv2d_valid(x: torch.Tensor, w: torch.Tensor, *, block=None,
                 variant: str = "shift_psum") -> torch.Tensor:
    """Valid-mode cross-correlation ``(H, W) ⋆ (N, M) → (H−N+1, W−M+1)``."""
    return run_window_plan(x, w, plan=plan_for(tuple(w.shape)), block=block,
                           variant=variant)


def conv2d_same(x: torch.Tensor, w: torch.Tensor, *, block=None,
                variant: str = "shift_psum") -> torch.Tensor:
    """'Same'-mode cross-correlation (zero boundary, centre anchor)."""
    return run_window_plan(x, w, plan=plan_for(tuple(w.shape), "same"),
                           block=block, variant=variant)


def conv2d_batched(x: torch.Tensor, w: torch.Tensor, *, mode: str = "valid",
                   block=None, time_steps: int = 1,
                   variant: str = "shift_psum") -> torch.Tensor:
    """A ``(B, H, W)`` image stack against one ``(N, M)`` filter."""
    return run_window_plan(x, w, plan=plan_for_batched(tuple(w.shape), mode),
                           block=block, time_steps=time_steps,
                           variant=variant)


def conv2d_nchw(x: torch.Tensor, w: torch.Tensor, *, mode: str = "valid",
                block=None, variant: str = "shift_psum") -> torch.Tensor:
    """Batched multi-channel NCHW convolution through the reduce-axes
    plan: ``(B, C_in, H, W) ⋆ (C_out, C_in, N, M) → (B, C_out, H', W')``,
    the channel reduction in an fp32 accumulator."""
    return run_window_plan(x, w, plan=plan_for_nchw(x.shape, w.shape, mode),
                           block=block, variant=variant)
