"""Carry state from the JAX package into the port.

This system's "weights" are its plans and filters, and the parameters and
decode states of its models. A plan crosses as ``dataclasses.asdict`` of
the reference's plan (plain nested dicts, no JAX objects); filters,
grids, parameter trees and states cross as numpy arrays. Nothing here
imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.plan import EpilogueStage, Step, SystolicPlan, Tap
from .nn.spec import leaves, unstack


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


def _tree_from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return from_numpy(np.array(tree), device)     # a writable copy


STACKED = ("layers", "enc_layers", "dec_layers")


def params_from_reference(tree, device="cpu"):
    """A reference parameter tree (nested dicts of numpy arrays, the
    layers stacked on a leading axis under ``"layers"``, or
    ``"enc_layers"`` and ``"dec_layers"`` for an encoder-decoder) as the
    port's tree: the same names, torch tensors on ``device``, and each
    stack a list of per-layer trees."""
    out = _tree_from_numpy(tree, device)
    for key in STACKED:
        if key not in out:
            continue
        n = {v.shape[0] for _, v in leaves(out[key])}
        if len(n) != 1:
            raise ValueError(f"stacked {key} disagree on their count: {n}")
        out[key] = unstack(out[key], n.pop())
    return out


def params_to_reference(tree) -> dict:
    """The port's parameter tree (or a tree of its gradients) as the
    reference lays it out: numpy arrays, each list of per-layer trees
    stacked on a leading axis again. The inverse of
    :func:`params_from_reference`."""
    def arrays(t):
        if isinstance(t, torch.Tensor):
            return t.detach().cpu().numpy()
        if isinstance(t, (list, torch.nn.ModuleList)):
            return _stack([arrays(v) for v in t])
        return {k: arrays(v) for k, v in t.items()}

    return arrays(tree)


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return np.stack(layers)


def state_from_reference(tree, device="cpu"):
    """A reference decode state (numpy arrays, stacked ``(L, B, …)``) as
    the port's: the same layout, torch tensors on ``device``."""
    return _tree_from_numpy(tree, device)
