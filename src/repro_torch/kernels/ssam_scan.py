"""SSAM scan kernels — Kogge–Stone plans over the engine (paper §3.6).

Two memory-bound primitives built from the same masked shift-accumulate
schedule (Fig. 1e):

* :func:`cumsum` — inclusive prefix sum along time
  (:func:`repro_torch.core.plan.scan_plan`, combine='add').
* :func:`linear_recurrence` — ``h_t = a_t · h_{t−1} + b_t`` via
  Kogge–Stone over the affine transfer pairs ``(a, b)``
  (:func:`repro_torch.core.plan.linear_recurrence_plan`,
  combine='linrec'), the engine of the RWKV6 WKV recurrence.

Layout: time on the lane axis, independent channels on rows. The
lowering is :func:`repro_torch.core.engine.run_scan_plan`: K5 on a CUDA
tensor, its plain version on a CPU tensor.
"""
from __future__ import annotations

import torch

from ..core.engine import run_scan_plan
from ..core.plan import linear_recurrence_plan, scan_plan


def _lane_tile(block_t: int, T: int) -> int:
    """Largest power-of-two lane tile ≤ min(block_t, T)."""
    return 1 << (min(block_t, T).bit_length() - 1)


def cumsum(x: torch.Tensor, *, block_r: int = 8, block_t: int = 128,
           carry=None, return_carry: bool = False):
    """Inclusive prefix sum along the last axis of ``(R, T)``.

    ``carry``/``return_carry`` thread the running total across chunks."""
    plan = scan_plan(_lane_tile(block_t, x.shape[-1]))
    return run_scan_plan(x, plan=plan, block_r=block_r, carry=carry,
                         return_carry=return_carry)


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, *, block_r: int = 8,
                      block_t: int = 128, carry=None,
                      return_carry: bool = False):
    """Solve ``h_t = a_t · h_{t−1} + b_t`` along the last axis of (R, T).

    ``carry`` seeds h₋₁ (default 0); ``return_carry=True`` also returns
    the final state ``(R, 1)``, so a caller can stream chunks through the
    carry.
    """
    plan = linear_recurrence_plan(_lane_tile(block_t, a.shape[-1]))
    return run_scan_plan(a, b, plan=plan, block_r=block_r, carry=carry,
                         return_carry=return_carry)
