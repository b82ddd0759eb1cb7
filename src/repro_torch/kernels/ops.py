"""Public ops of the port: ``stencil`` and ``conv2d`` (windowed plans,
K1) and the scan family ``cumsum``, ``sat``, ``linear_recurrence``,
``linear_recurrence_carry`` and ``chunked_linear_recurrence`` (K5).

The device of the input decides the path: a CUDA tensor launches the
hand-written kernel, and a CPU tensor runs its plain torch version
(:func:`repro_torch.core.engine.run_window_plan_reference`,
:func:`repro_torch.core.engine.run_scan_plan_reference`). Nothing falls
back: a CUDA failure raises. There is no autotuner, mesh, guard lattice
or device ``impl=`` switch; ``chunked_linear_recurrence``'s ``impl``
names the schedule, as in the reference.
"""
from __future__ import annotations

import torch

from ..core import engine as _engine
from ..core.plan import linear_recurrence_plan
from . import ssam_conv2d as _c2
from . import ssam_scan as _sc
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


# ---------------------------------------------------------------------------
# Scan family (K5)
# ---------------------------------------------------------------------------

SCAN_BLOCK = (8, 128)        # (block_r, block_t) of the reference's defaults


def _reject_scan_kwargs(op: str, kw: dict) -> None:
    """Scan ops take no sharding or windowed-plan fusion kwargs: say so
    instead of ignoring them."""
    bad = sorted(k for k in ("mesh", "in_specs", "boundary") if k in kw)
    if bad:
        raise ValueError(
            f"ops.{op} does not take {', '.join(bad)}: scan plans carry a "
            "sequential inter-block carry along the lane axis, so the "
            "halo-exchange layer cannot shard them; shard the row axis "
            "instead")
    bad = sorted(k for k in ("epilogue", "epilogue_args", "stride",
                             "strategy") if k in kw)
    if bad:
        raise ValueError(
            f"ops.{op} does not take {', '.join(bad)}: fused epilogues, "
            "output strides, chain fusion and the lanes/mxu lowering "
            "strategy are windowed-plan features — a scan's tap "
            "contraction is a carried recurrence, not a matmul, and a fused "
            "activation would corrupt the carry; apply the elementwise "
            "stage after the scan")


def _scan_blocks(op: str, kw: dict, block_t: int = SCAN_BLOCK[1]):
    """``(block_r, block_t)`` from ``kw``; any other kwarg raises."""
    _reject_scan_kwargs(op, kw)
    block_r = kw.pop("block_r", SCAN_BLOCK[0])
    block_t = kw.pop("block_t", block_t)
    if kw:
        raise TypeError(f"unexpected kwargs for ops.{op}: {sorted(kw)}")
    return block_r, block_t


def cumsum(x: torch.Tensor, **kw) -> torch.Tensor:
    """Inclusive prefix sum along the last axis of ``(R, T)``."""
    block_r, block_t = _scan_blocks("cumsum", kw)
    return _sc.cumsum(x, block_r=block_r, block_t=block_t)


def sat(x: torch.Tensor, **kw) -> torch.Tensor:
    """Summed-area table (§3.6): two passes of the Kogge–Stone cumsum —
    rows, then columns (the transposed rows)."""
    _reject_scan_kwargs("sat", kw)
    return cumsum(cumsum(x, **kw).T, **kw).T


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """h_t = a_t·h_{t−1} + b_t along the last axis of (R, T)-shaped a, b."""
    block_r, block_t = _scan_blocks("linear_recurrence", kw)
    return _sc.linear_recurrence(a, b, block_r=block_r, block_t=block_t)


def linear_recurrence_carry(a: torch.Tensor, b: torch.Tensor,
                            h0: torch.Tensor, **kw):
    """``h_t = a_t·h_{t−1} + b_t`` over (R, T) rows with an explicit carry.

    Returns ``(h, h_T)``, ``h_T`` the final raw state ``(R, 1)``; ``h0``
    is ``(R,)`` or ``(R, 1)``. One chunk of the streamed schedule."""
    block_r, block_t = _scan_blocks("linear_recurrence_carry", kw)
    return _sc.linear_recurrence(a, b, block_r=block_r, block_t=block_t,
                                 carry=h0.reshape(a.shape[0], 1),
                                 return_carry=True)


def chunked_linear_recurrence(a: torch.Tensor, b: torch.Tensor, *,
                              chunk: int = 128, impl: str = "engine",
                              **kw) -> torch.Tensor:
    """Same math as :func:`linear_recurrence`; a, b shaped (..., T).

    Leading axes flatten to the engine's rows. ``impl`` names the
    schedule: ``"engine"`` streams ``(R, chunk)`` slabs through the scan
    engine with the carry threaded between them (one K5 launch per slab
    on the card); ``"engine_unchunked"`` runs all of T in one call.
    """
    if impl == "chunked":
        raise NotImplementedError(
            "chunked_linear_recurrence(impl='chunked'), the XLA "
            "associative-scan form, is not ported yet (ROADMAP Queue 1 "
            "item 5b)")
    if impl not in ("engine", "engine_unchunked"):
        raise ValueError(f"impl must be 'engine' or 'engine_unchunked', "
                         f"got {impl!r}")
    if a.shape != b.shape:
        raise ValueError(f"a and b must share a shape, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    T = a.shape[-1]
    rows_a, rows_b = a.reshape(-1, T), b.reshape(-1, T)
    if impl == "engine":
        block_r, block_t = _scan_blocks("chunked_linear_recurrence", kw)
        plan = linear_recurrence_plan(_sc._lane_tile(min(block_t, chunk),
                                                     chunk))
        out = _engine.run_scan_plan_chunked(rows_a, rows_b, plan=plan,
                                            chunk=chunk, block_r=block_r)
    else:
        block_r, block_t = _scan_blocks("chunked_linear_recurrence", kw,
                                        block_t=chunk)
        out = _sc.linear_recurrence(rows_a, rows_b, block_r=block_r,
                                    block_t=block_t)
    return out.reshape(a.shape)
