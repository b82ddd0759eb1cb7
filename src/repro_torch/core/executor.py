"""Plain-torch executor for conv/stencil plans — the model-level semantics.

Interprets a :class:`SystolicPlan` with ``torch.roll`` standing in for
the partial-sum interconnect (``__shfl_up_sync`` on a GPU), independent
of the engine's blocking:

* :func:`execute_conv_block` runs one register-cache block of shape
  ``(C, S)`` — a single "warp" step, Fig. 2a;
* :func:`execute_conv_global` runs the same schedule over a whole
  ``(H, W)`` array (the S→∞ limit).

The scan executors wait for the scan slice of the port.
"""
from __future__ import annotations

import torch

from .plan import SystolicPlan


def _shift_partial_sums(s: torch.Tensor, shift: int, dim: int = -1) -> torch.Tensor:
    """The D-edge: lane j receives lane j−shift (wrapping into halo lanes)."""
    return torch.roll(s, shift, dims=dim)


def execute_conv_block(plan: SystolicPlan, data: torch.Tensor,
                       coeffs: torch.Tensor) -> torch.Tensor:
    """Run a conv/stencil plan on one ``(C, S)`` register-cache block.

    ``coeffs`` is indexed by each tap's ``coeff_id`` (the ``(N, M)``
    filter for conv2d, a flat vector for stencils). Returns ``(P, S)``;
    lanes ``[M−1, S)`` hold the valid outputs.
    """
    P, S = plan.P, plan.S
    if tuple(data.shape) != (plan.C, S):
        raise ValueError(f"block shape {tuple(data.shape)} != {(plan.C, S)}")
    rows = []
    for i in range(P):
        s = data.new_zeros((S,))
        for step in plan.steps:
            if step.shift:
                s = _shift_partial_sums(s, step.shift)
            for tap in step.taps:
                s = s + data[i + tap.row_offset, :] * coeffs[tap.coeff_id]
        rows.append(s)
    return torch.stack(rows)


def execute_conv_global(plan: SystolicPlan, data: torch.Tensor,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """Whole-array execution: the valid cross-correlation of an ``(H, W)``
    array, shape ``(H − N + 1, W − M + 1)``."""
    H, W = data.shape
    rows = []
    for y in range(H - plan.N + 1):
        s = data.new_zeros((W,))
        for step in plan.steps:
            if step.shift:
                s = _shift_partial_sums(s, step.shift)
            for tap in step.taps:
                s = s + data[y + tap.row_offset, :] * coeffs[tap.coeff_id]
        rows.append(s[plan.M - 1:])
    return torch.stack(rows)
