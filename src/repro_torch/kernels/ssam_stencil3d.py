"""SSAM 3-D stencil (paper §4.9) as a plan over the engine.

The X–Y plane is scheduled as in 2-D; Z taps are further register reads
(``Tap.z_offset``). On the card each thread walks Z with a rolling
register cache of the footprint's slices.
"""
from __future__ import annotations

import torch

from ..core.engine import run_window_plan
from ..core.plan import stencil3d_plan
from .stencils import StencilDef


def plan_for(sdef: StencilDef):
    """The systolic plan for a 3-D stencil definition (coeffs baked in)."""
    return stencil3d_plan(sdef.offsets, coeffs=sdef.coeffs)


def stencil3d(x: torch.Tensor, sdef: StencilDef, *, block=None,
              time_steps: int = 1, variant: str = "shift_psum") -> torch.Tensor:
    """Apply ``sdef`` to ``x`` (Z, Y, X) ``time_steps`` times (zero
    boundary, same shape)."""
    if sdef.ndim != 3:
        raise ValueError(f"{sdef.name} is a {sdef.ndim}-D stencil")
    return run_window_plan(x, plan=plan_for(sdef), block=block,
                           time_steps=time_steps, variant=variant)
