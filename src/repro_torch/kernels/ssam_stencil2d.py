"""SSAM 2-D stencil — the paper's Listing 2 as a plan over the engine.

Taps are grouped by column offset ({West}, {North, Current, South},
{East} for the 5-point stencil); the coefficients ride the plan as
immediates. ``time_steps > 1`` applies the stencil t times inside the
block over a halo widened to t footprints, with the pad-once semantics of
``ref.stencil_iterate``.
"""
from __future__ import annotations

import torch

from ..core.engine import run_window_plan
from ..core.plan import stencil2d_plan
from .stencils import StencilDef


def plan_for(sdef: StencilDef):
    """The systolic plan for a 2-D stencil definition (coeffs baked in)."""
    return stencil2d_plan(sdef.offsets, coeffs=sdef.coeffs)


def stencil2d(x: torch.Tensor, sdef: StencilDef, *, block=None,
              time_steps: int = 1, variant: str = "shift_psum") -> torch.Tensor:
    """Apply ``sdef`` to ``x`` (H, W) ``time_steps`` times (zero boundary,
    same shape)."""
    if sdef.ndim != 2:
        raise ValueError(f"{sdef.name} is a {sdef.ndim}-D stencil")
    return run_window_plan(x, plan=plan_for(sdef), block=block,
                           time_steps=time_steps, variant=variant)
