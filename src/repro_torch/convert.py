"""Carry state from the JAX package into the port.

This system's "weights" are its plans and filters. A plan crosses as
``dataclasses.asdict`` of the reference's plan (plain nested dicts, no
JAX objects), so nothing here imports the reference; filters and grids
cross as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.plan import EpilogueStage, Step, SystolicPlan, Tap


def _tuple(v):
    return None if v is None else tuple(v)


def plan_from_reference(d: dict) -> SystolicPlan:
    """Rebuild a port :class:`SystolicPlan` from ``dataclasses.asdict`` of
    a reference plan, with nested steps, taps, epilogue stages and fused
    stages."""
    steps = tuple(
        Step(shift=s["shift"], masked=s["masked"],
             taps=tuple(Tap(t["row_offset"], tuple(t["coeff_id"]),
                            t["z_offset"]) for t in s["taps"]))
        for s in d["steps"])
    return SystolicPlan(
        **{**d,
           "steps": steps,
           "lead": _tuple(d["lead"]),
           "trail": _tuple(d["trail"]),
           "coeffs": _tuple(d["coeffs"]),
           "stride": _tuple(d["stride"]),
           "epilogue": tuple(EpilogueStage(**e) for e in d["epilogue"]),
           "stages": tuple(plan_from_reference(s) for s in d["stages"])})


def from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """A filter or grid as a contiguous tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
