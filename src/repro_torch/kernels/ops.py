"""Public ops of the port: ``stencil`` and ``conv2d``.

The device of ``x`` decides the path: a CUDA tensor launches K1, the
hand-written windowed-plan kernel, and a CPU tensor runs its plain torch
version (:func:`repro_torch.core.engine.run_window_plan_reference`).
Nothing falls back: a CUDA failure raises. There is no autotuner, mesh,
guard lattice or ``impl=`` switch in this slice.
"""
from __future__ import annotations

import torch

from . import ssam_conv2d as _c2
from . import ssam_stencil2d as _s2
from . import ssam_stencil3d as _s3
from .stencils import BENCHMARKS, StencilDef


def stencil(x: torch.Tensor, sdef: StencilDef | str, *, time_steps: int = 1,
            variant: str = "shift_psum", block=None, epilogue=None,
            mesh=None) -> torch.Tensor:
    """Apply a Table-3 stencil ``time_steps`` times to an ``(H, W)`` or
    ``(D, H, W)`` grid (zero boundary, same shape, pad-once semantics)."""
    if epilogue is not None:
        raise NotImplementedError(
            "stencil epilogues are ROADMAP Queue 1 item 4")
    if mesh is not None:
        raise NotImplementedError(
            "sharded stencils are ROADMAP Queue 1 item 12")
    if isinstance(sdef, str):
        sdef = BENCHMARKS[sdef]
    if x.ndim != sdef.ndim:
        raise ValueError(f"{sdef.name} is {sdef.ndim}-D, x has shape "
                         f"{tuple(x.shape)}")
    fn = _s2.stencil2d if sdef.ndim == 2 else _s3.stencil3d
    return fn(x, sdef, block=block, time_steps=time_steps, variant=variant)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, mode: str = "same",
           variant: str = "shift_psum", block=None, groups: int = 1,
           stride=None, epilogue=None, mesh=None) -> torch.Tensor:
    """2-D cross-correlation with an ``(N, M)`` filter, by input rank:
    ``(H, W)`` for one image, ``(B, H, W)`` for a stack of single-channel
    images. ``mode`` is ``'same'`` (zero boundary, centre anchor) or
    ``'valid'``."""
    if x.ndim == 4 or groups != 1 or stride not in (None, 1, (1, 1)) \
            or epilogue is not None:
        raise NotImplementedError(
            "NCHW input, groups, stride and epilogues are ROADMAP Queue 1 "
            "item 4")
    if mesh is not None:
        raise NotImplementedError("sharded conv2d is ROADMAP Queue 1 item 12")
    if mode not in ("same", "valid"):
        raise ValueError(f"conv2d: mode must be 'same' or 'valid', got {mode!r}")
    if w.ndim != 2:
        raise ValueError(f"conv2d takes an (N, M) filter, got w shape "
                         f"{tuple(w.shape)}")
    if x.ndim == 3:
        return _c2.conv2d_batched(x, w, mode=mode, block=block,
                                  variant=variant)
    if x.ndim != 2:
        raise ValueError(f"conv2d takes (H, W) or (B, H, W), got "
                         f"{tuple(x.shape)}")
    fn = _c2.conv2d_same if mode == "same" else _c2.conv2d_valid
    return fn(x, w, block=block, variant=variant)
