"""The plan engine: windowed plans (K1, K2, K3, K4) and scan plans (K5),
each a CUDA kernel beside its plain version.

:func:`run_window_plan` runs a windowed :class:`SystolicPlan` (2-D and
3-D stencils, dense 2-D convolution, with leading batch axes, NCHW
convolution with a channel reduction, and depthwise (per-lane) conv1d;
an output stride on 2-D plans, and a fused epilogue, ``residual_add``
included, on all of them) over an input whose lane axis is last. The tensor's
device decides how:

* a CUDA tensor launches K1, the hand-written kernel in
  ``csrc/ssam_window*.cu`` (it replaces the JAX package's
  ``core/engine.py::_window_kernel``), or, for a plan whose
  ``strategy`` is ``'mxu'``, K2, the tensor-core kernels in
  ``csrc/ssam_mxu_tc.cu`` (channel plans), ``csrc/ssam_mxu.cu``
  (single-channel plans) and ``csrc/ssam_mxu_perlane.cu`` (per-lane
  plans; all three replace ``_apply_plan_mxu``); a failure
  raises, it never falls back, and an mxu plan never retreats to K1;
* a CPU tensor runs :func:`run_window_plan_reference`, the plain torch
  version: the reference's ``_apply_plan_once`` block walk, both
  variants and the strided read (or, for mxu plans,
  :func:`apply_plan_mxu`, its im2row contraction), over overlapped
  blocks padded per :func:`origin_pads`, then the epilogue at the flush.

The geometry is the reference ``_window_call``'s: output shape
``(in + t·(lead+trail) − t·(ext−1) − 1) // stride + 1`` per axis,
blocks of the output tiled disjointly, each read from a ``t``-widened
overlapped input block at a stride-scaled origin. Plans outside the
port's reach raise ``NotImplementedError`` naming the ROADMAP item that
ports them.

:func:`run_weight_grad_plan` is the backward-weight correlation
``∂L/∂w[n,m] = Σ_{b,o} g[b,o]·xp[b,s·o+(n,m)]`` of a dense plan (``s``
its output stride, ``g`` the strided output's cotangent), K3
(``csrc/ssam_wgrad_tc.cu`` for channel plans, ``csrc/ssam_wgrad.cu``
for single-channel ones, replacing ``_wgrad_dense_kernel``), and
``∂L/∂w[k,d] = Σ_{b,t} g[b,t,d]·xp[b,t+k,d]`` of a per-lane plan, K4
(``csrc/ssam_wgrad_perlane.cu``, replacing ``_wgrad_perlane_kernel``),
for CUDA tensors; :func:`run_weight_grad_plan_reference` for CPU
tensors.

:func:`run_scan_plan` runs a scan plan (``combine='add'``: prefix sum;
``'linrec'``: ``h_t = a_t·h_{t−1} + b_t``) over ``(R, T)`` rows, with an
optional carry in and out: a CUDA tensor launches K5
(``csrc/ssam_scan.cu``, replacing ``_scan_kernel``), a CPU tensor runs
:func:`run_scan_plan_reference`. :func:`run_scan_plan_chunked` streams
``(R, chunk)`` slabs through it, threading the carry.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from .. import _build
from . import adjoint
from .adjoint import apply_epilogue
from .halo import origin_pads
from .plan import EPILOGUE_OPERANDS, SystolicPlan, epilogue_operand_stages

VARIANTS = ("shift_psum", "shift_data")
STRATEGIES = (None, "lanes", "mxu")
MXU_TAP_ALIGN = 8            # K2's im2row taps pad to a multiple of 8
WARP = 32
SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use
TABLE_SLOTS = 1024           # the kernel's tap-table limit (steps · D · N)
# the kernels' epilogue codes (csrc/ssam_epilogue.cuh), in their order
EPILOGUE_CODES = {"bias": 1, "gelu": 2, "silu": 3, "relu": 4, "scale": 5,
                  "residual_add": 6}
MAX_EPILOGUE = 8


def _is_reduce(plan: SystolicPlan) -> bool:
    return bool(plan.reduce_axes or plan.out_axes)


def check_supported(plan: SystolicPlan, time_steps: int, variant: str) -> None:
    """Raise for what the port does not run yet."""
    todo = []
    reduce = _is_reduce(plan)
    if reduce and (plan.reduce_axes, plan.out_axes) != (1, 1):
        todo.append("reduce/out axes other than one of each (ROADMAP "
                    "Queue 1 item 4; no ops.* call reaches it)")
    if plan.stages:
        todo.append("fused stages (ROADMAP Queue 1 item 7)")
    perlane = plan.coeff_mode == "perlane"
    if perlane and time_steps != 1:
        todo.append("temporal blocking of per-lane plans (ROADMAP Queue 1 "
                    "item 4; no ops.* call reaches it)")
    if plan.combine != "fma":
        raise ValueError(f"{plan.kind!r} plan has combine={plan.combine!r}: "
                         "scan plans run through run_scan_plan")
    if todo:
        raise NotImplementedError(
            f"{plan.kind!r} plan: {', '.join(todo)} not ported yet")
    if plan.coeff_mode not in ("table", "dense", "perlane"):
        raise ValueError(f"unknown coeff_mode {plan.coeff_mode!r}")
    if perlane and (reduce or plan.ndim_spatial != 2 or plan.M != 1
                    or len(plan.steps) != 1 or plan.steps[0].shift):
        raise ValueError(f"{plan.kind!r}: per-lane plans are 2-D plans with "
                         "one unshifted column step (M = 1) and no reduce "
                         "axes, as depthwise_conv1d_plan builds them")
    if plan.strategy not in STRATEGIES:
        raise ValueError(f"unknown lowering strategy {plan.strategy!r}: "
                         f"expected one of {STRATEGIES}")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if int(time_steps) != time_steps or time_steps < 1:
        raise ValueError(f"time_steps must be an int >= 1, got {time_steps}")
    strided = any(v > 1 for v in plan.stride_per_axis())
    if reduce:
        if plan.coeff_mode != "dense" or plan.ndim_spatial != 2 \
                or plan.batch_axes > 1:
            raise ValueError(f"{plan.kind!r}: reduce plans are dense 2-D "
                             "plans with at most one batch axis")
        if time_steps != 1:
            raise ValueError(
                "temporal blocking does not commute with a channel "
                "reduction: iterate t must see the summed output of "
                "iterate t-1")
    elif strided and (time_steps != 1 or plan.ndim_spatial != 2
                      or perlane):
        raise ValueError("output strides support single 2-D plan "
                         "applications")


def _out_dims(plan: SystolicPlan, x, w, time_steps: int = 1) -> tuple:
    """The output's shape: x's batch axes, C_out for reduce plans, then
    the windowed axes of :meth:`SystolicPlan.out_shape`."""
    nb, nr = plan.batch_axes, plan.reduce_axes
    return (tuple(x.shape[:nb])
            + ((w.shape[0],) if _is_reduce(plan) else ())
            + plan.out_shape(tuple(x.shape[nb + nr:]), time_steps))


def _check_operands(plan: SystolicPlan, x, w, epilogue_args,
                    time_steps: int = 1) -> None:
    """Shapes of the filter and the epilogue operands against the plan:
    a bias per C_out (reduce plans), per lane (per-lane plans) or a
    scalar (any other plan), a residual shaped exactly like the output
    (the reference's ``_check_epilogue_operands``)."""
    if plan.coeff_mode in ("dense", "perlane") and w is None:
        raise ValueError(f"a {plan.coeff_mode} plan needs its filter w")
    need = epilogue_operand_stages(plan.epilogue)
    if len(epilogue_args) != len(need):
        raise ValueError(
            f"epilogue {tuple(s.op for s in plan.epilogue)} needs "
            f"{len(need)} runtime operand(s), got {len(epilogue_args)}")
    perlane = plan.coeff_mode == "perlane"
    if perlane:
        rows = 1 + max(t.coeff_id[-1] for t in plan.steps[0].taps)
        if w.ndim != 2 or w.shape[1] != x.shape[-1] or w.shape[0] < rows:
            raise ValueError(
                f"{plan.kind!r}: per-lane filter {tuple(w.shape)} must be "
                f"(>= {rows}, D) with D = x's lane axis {x.shape[-1]}")
    elif _is_reduce(plan):
        nb = plan.batch_axes
        if x.ndim != nb + 3 or w.ndim != 4 or w.shape[1] != x.shape[nb]:
            raise ValueError(
                f"{plan.kind!r}: x {tuple(x.shape)} must be (B, C_in, H, W) "
                f"against a (C_out, C_in, N, M) filter, got w "
                f"{tuple(w.shape)}")
        if tuple(w.shape[2:]) != plan.exts:
            raise ValueError(f"filter {tuple(w.shape)} does not match the "
                             f"plan's footprint {plan.exts}")
    for st, arr in zip(need, epilogue_args):
        shape = tuple(arr.shape)
        if st.op == "residual_add":
            want = _out_dims(plan, x, w, time_steps)
            if shape != want:
                raise ValueError(
                    f"residual_add epilogue wants an output-shaped {want} "
                    f"operand, got shape {shape}")
        elif perlane:
            if shape != (x.shape[-1],):
                raise ValueError(f"bias epilogue wants a per-lane "
                                 f"({x.shape[-1]},) row, got {shape}")
        elif _is_reduce(plan):
            if shape != (w.shape[0],):
                raise ValueError(f"bias epilogue wants a per-C_out "
                                 f"({w.shape[0]},) row, got {shape}")
        elif arr.numel() != 1:
            raise ValueError(
                f"bias epilogue wants a scalar for {plan.kind!r} plans (no "
                f"channel axis), got shape {shape}")


def _geometry(plan, x_shape, block, time_steps):
    lead_axes = plan.batch_axes + plan.reduce_axes
    nd = plan.ndim_spatial
    if len(x_shape) != lead_axes + nd:
        raise ValueError(
            f"{plan.kind!r} plan takes a {lead_axes + nd}-D input (batch "
            f"axes {plan.batch_axes}, reduce axes {plan.reduce_axes}), got "
            f"shape {tuple(x_shape)}")
    if len(block) != nd:
        raise ValueError(f"block {block} must have {nd} entries")
    spatial_in = tuple(x_shape[lead_axes:])
    out_sp = plan.out_shape(spatial_in, time_steps)
    if any(o < 1 for o in out_sp):
        raise ValueError(f"input {spatial_in} is smaller than the plan's "
                         f"footprint {plan.exts} over {time_steps} steps")
    B = tuple(min(b, o) for b, o in zip(block, out_sp))
    g = tuple(-(-o // b) for o, b in zip(out_sp, B))
    return spatial_in, out_sp, B, g


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 accumulation, fp64 for fp64 inputs (so that fp64 gradcheck
    holds the plain path to its own precision)."""
    return torch.promote_types(x.dtype, torch.float32)


# ---------------------------------------------------------------------------
# The plain version: the reference block walk in torch
# ---------------------------------------------------------------------------

def _term(plan: SystolicPlan, w, tap, view):
    """One tap's products. Reduce plans contract the input channels of the
    view (axis 1) against ``w[:, :, tap]``, the ``C_in`` sweep of the
    reference's reduce grid done as one contraction per tap."""
    if plan.coeff_mode == "table":
        return view * plan.coeffs[tap.coeff_id[-1]]
    if plan.coeff_mode == "perlane":
        # the reference's _coeff: row coeff_id of w, one value per lane
        return view * w[tap.coeff_id[-1]].to(view.dtype)
    if _is_reduce(plan):
        wt = w[(slice(None), slice(None)) + tuple(tap.coeff_id)]
        return torch.einsum("bc...,oc->bo...", view, wt.to(view.dtype))
    return view * w[tuple(tap.coeff_id)].to(view.dtype)


def _zeros(xb, plan, w, spatial):
    nd = plan.ndim_spatial
    shape = list(xb.shape[:-nd]) + list(spatial)
    if _is_reduce(plan):
        shape[1] = w.shape[0]
    return xb.new_zeros(shape)


def _tap_read(xb, tap, valid):
    if len(valid) == 3:
        return xb[..., tap.z_offset:tap.z_offset + valid[0],
                  tap.row_offset:tap.row_offset + valid[1], :]
    return xb[..., tap.row_offset:tap.row_offset + valid[0], :]


def apply_plan_once(xb: torch.Tensor, plan: SystolicPlan, w,
                    variant: str) -> torch.Tensor:
    """One valid application of ``plan`` on blocks ``xb`` (in xb's dtype).

    The last ``plan.ndim_spatial`` axes are the block; any leading axes
    are independent blocks (for reduce plans axis 0 is the batch and axis
    1 the reduced channel). The torch twin of the reference's
    ``_apply_plan_once`` (lanes strategy): ``shift_psum`` rolls the
    partial sums one lane per column step and keeps lanes ``[M−1, W)``;
    ``shift_data`` rolls the data by the cumulative shift and keeps lanes
    ``[0, W−M+1)``; an output-strided plan reads lane ``l·stride + cum``
    directly and computes only the kept outputs. Same products, same
    order.
    """
    nd = plan.ndim_spatial
    stride = plan.stride_per_axis()
    if any(v > 1 for v in stride):
        sh, sw = stride
        out_sp = tuple((n - e) // v + 1
                       for n, e, v in zip(xb.shape[-2:], plan.exts, stride))
        s = _zeros(xb, plan, w, out_sp)
        cum = 0
        for step in plan.steps:
            cum += step.shift
            for tap in step.taps:
                view = xb[..., tap.row_offset:
                          tap.row_offset + (out_sp[0] - 1) * sh + 1:sh,
                          cum:cum + (out_sp[1] - 1) * sw + 1:sw]
                s = s + _term(plan, w, tap, view)
        return s
    valid = tuple(n - (e - 1) for n, e in zip(xb.shape[-nd:], plan.exts))
    s = _zeros(xb, plan, w, valid[:-1] + (xb.shape[-1],))
    if variant == "shift_psum":
        for step in plan.steps:
            if step.shift:
                s = torch.roll(s, step.shift, dims=-1)
            for tap in step.taps:
                s = s + _term(plan, w, tap, _tap_read(xb, tap, valid))
        return s[..., plan.M - 1:plan.M - 1 + valid[-1]]
    if variant == "shift_data":
        cum = 0
        for step in plan.steps:
            cum += step.shift
            xs = torch.roll(xb, -cum, dims=-1) if cum else xb
            for tap in step.taps:
                s = s + _term(plan, w, tap, _tap_read(xs, tap, valid))
        return s[..., :valid[-1]]
    raise ValueError(variant)


def flat_taps(plan: SystolicPlan) -> list:
    """The tap set flattened to ``(cumulative_shift, tap)`` pairs, in plan
    order. The cumulative lane shift is the tap's column: output lane
    ``l`` reads input lane ``l + cum`` (strided plans: ``l·stride +
    cum``)."""
    out, cum = [], 0
    for step in plan.steps:
        cum += step.shift
        for tap in step.taps:
            out.append((cum, tap))
    return out


def _mxu_view(xb, plan: SystolicPlan, cum: int, tap, out_sp):
    """One tap's shifted crop of the blocks ``xb``: the tap's row of the
    im2row operand, output-shaped (strided plans read every
    ``stride``-th input)."""
    if len(out_sp) == 3:
        return xb[..., tap.z_offset:tap.z_offset + out_sp[0],
                  tap.row_offset:tap.row_offset + out_sp[1],
                  cum:cum + out_sp[2]]
    sh, sw = plan.stride_per_axis()
    return xb[..., tap.row_offset:tap.row_offset + (out_sp[0] - 1) * sh + 1:sh,
              cum:cum + (out_sp[1] - 1) * sw + 1:sw]


def apply_plan_mxu(xb: torch.Tensor, plan: SystolicPlan, w) -> torch.Tensor:
    """One valid application of ``plan`` on blocks ``xb`` as an im2row
    contraction: the plain version of K2, the torch twin of the
    reference's ``_apply_plan_mxu``.

    Each tap's shifted crop of the block (:func:`_mxu_view`) is a row of
    a ``(taps padded to 8, out_elems)`` operand, contracted with the
    coefficient row in the accumulator's dtype. 'table' coefficients
    fold into their rows against a ones row, as the reference does.
    'perlane' coefficients (depthwise conv1d and its input adjoint) have
    no shared row: each lane contracts the tap axis against its own row
    ``w[coeff_id, lane]`` (``w`` broadcast against the blocks' lanes,
    as :func:`run_window_plan_reference` lays it out), the reference's
    lane-batched mat-vec. For
    NCHW reduce plans (axis 0 of ``xb`` the batch, axis 1 ``C_in``) the
    contraction runs over ``C_in·taps`` against ``w[:, :, tap]`` into the
    same sum. Leading axes are independent blocks, so the operand of all
    blocks at once would be ``taps`` times the input; it is built and
    contracted in groups of :data:`MXU_TAP_ALIGN` taps (zero rows pad the
    last group), each group's product added to the fp32 sum in plan
    order. The reference contracts all taps in one dot: the sums agree
    to fp32 rounding, not bit for bit.
    """
    nd = plan.ndim_spatial
    out_sp = tuple((n - e) // v + 1 for n, e, v in zip(
        xb.shape[-nd:], plan.exts, plan.stride_per_axis()))
    taps = flat_taps(plan)
    reduce = _is_reduce(plan)
    acc = None
    for g0 in range(0, len(taps), MXU_TAP_ALIGN):
        group = taps[g0:g0 + MXU_TAP_ALIGN]
        views = [_mxu_view(xb, plan, cum, tap, out_sp) for cum, tap in group]
        pad = MXU_TAP_ALIGN - len(group)
        if plan.coeff_mode == "perlane":
            # (T, …, R, L) taps against (T, …, 1, L) per-lane rows: T
            # contracted under a lane batch, the reference's batched mat-vec
            A = torch.stack(views)
            Wm = torch.stack([w[tap.coeff_id[-1]] for _, tap in group]
                             ).to(xb.dtype)
            if pad:
                A = torch.cat([A, A.new_zeros((pad,) + tuple(A.shape[1:]))])
                Wm = torch.cat([Wm, Wm.new_zeros((pad,)
                                                 + tuple(Wm.shape[1:]))])
            Wm = Wm.reshape((MXU_TAP_ALIGN,) + (1,) * (A.ndim - Wm.ndim)
                            + tuple(Wm.shape[1:]))
            part = (A * Wm).sum(0)
            acc = part if acc is None else acc + part
            continue
        if plan.coeff_mode == "table":
            rows = [v * plan.coeffs[tap.coeff_id[-1]]
                    for v, (_, tap) in zip(views, group)]
            c = xb.new_ones(MXU_TAP_ALIGN)      # zero rows contribute 0
        elif reduce:
            rows = views
            c = torch.stack([w[(slice(None), slice(None))
                               + tuple(tap.coeff_id)]
                             for _, tap in group]).to(xb.dtype)
        else:
            rows = views
            c = torch.stack([w[tuple(tap.coeff_id)]
                             for _, tap in group]).to(xb.dtype)
        A = torch.stack(rows)
        if pad:
            A = torch.cat([A, A.new_zeros((pad,) + tuple(A.shape[1:]))])
        if len(c) < MXU_TAP_ALIGN:
            c = torch.cat([c, c.new_zeros((pad,) + tuple(c.shape[1:]))])
        if reduce:
            part = torch.einsum("tbc...,toc->bo...", A, c)
        else:
            part = torch.tensordot(c, A, dims=1)
        acc = part if acc is None else acc + part
    return acc


def run_window_plan_reference(x: torch.Tensor, w=None, *, plan: SystolicPlan,
                              block=None, time_steps: int = 1,
                              variant: str = "shift_psum",
                              epilogue_args=()) -> torch.Tensor:
    """The plain version of K1 and K2, on any device.

    Pads ``x`` per :func:`origin_pads` (``t·lead`` zeros ahead, enough
    behind for the last block), cuts it into the overlapped input blocks
    of the disjoint output tiling (a strided view; strided plans start
    block ``i`` at ``i·b·stride``), runs ``time_steps`` applications of
    :func:`apply_plan_once` on every block at once, crops each block to
    its output tile, stitches the tiles and applies the epilogue to the
    sum, as the reference does at the accumulator flush. Accumulates in
    fp32 (fp64 for fp64 inputs); returns ``x``'s dtype. A plan whose
    ``strategy`` is ``'mxu'`` applies :func:`apply_plan_mxu` instead (the
    plain version of K2; ``variant`` is then moot, as in the reference).
    """
    check_supported(plan, time_steps, variant)
    _check_operands(plan, x, w, epilogue_args, time_steps)
    block = tuple(block or default_block(plan, time_steps))
    t = time_steps
    nd = plan.ndim_spatial
    squeeze = _is_reduce(plan) and not plan.batch_axes
    xx = x[None] if squeeze else x
    lead_in = xx.ndim - nd
    spatial_in, out_sp, B, g = _geometry(
        dataclasses.replace(plan, batch_axes=lead_in - plan.reduce_axes),
        xx.shape, block, t)
    pads = origin_pads(plan, spatial_in, g, B, t)
    xp = F.pad(xx.to(acc_dtype(x)),
               [v for lo_hi in reversed(pads) for v in lo_hi])
    in_block = plan.block_in_shape(B, t)
    stride = plan.stride_per_axis()
    blocks = xp
    for a in range(nd):
        blocks = blocks.unfold(lead_in + a, in_block[a], B[a] * stride[a])
    blocks = blocks[(slice(None),) * lead_in + tuple(slice(0, gi) for gi in g)]
    if plan.coeff_mode == "perlane":
        # each block reads its own lanes of w, as the reference's (K, B[-1])
        # BlockSpec cuts the lane-padded filter: (K, gd, 1, bd) broadcasts
        # against blocks (..., gt, gd, rows, bd)
        wp = F.pad(w, (0, g[-1] * B[-1] - w.shape[-1]))
        w = wp.reshape(w.shape[0], g[-1], 1, B[-1])
    for _ in range(t):
        if plan.strategy == "mxu":
            blocks = apply_plan_mxu(blocks, plan, w)
        else:
            blocks = apply_plan_once(blocks, plan, w, variant)
    blocks = blocks[(...,) + tuple(slice(0, b) for b in B)]
    lead_out = lead_in                    # C_in is replaced by C_out in place
    perm = list(range(lead_out)) + [d for a in range(nd)
                                    for d in (lead_out + a, lead_out + nd + a)]
    out = blocks.permute(perm).reshape(
        tuple(blocks.shape[:lead_out])
        + tuple(gi * bi for gi, bi in zip(g, B)))
    out = out[(slice(None),) * lead_out + tuple(slice(0, o) for o in out_sp)]
    if plan.epilogue:
        out = apply_epilogue(plan, out, epilogue_args)
    if squeeze:
        out = out[0]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# K1: the CUDA kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpilogueCodes:
    """A plan's epilogue as the kernels read it: ``ops`` and ``vals``
    ctypes arrays of :data:`MAX_EPILOGUE` entries (codes of
    :data:`EPILOGUE_CODES`), ``count`` stages, ``bias`` the fp32 bias (per
    C_out, per lane, or one value) and ``resid`` the residual in the
    output's dtype and layout, each contiguous on x's device or None."""

    ops: object
    vals: object
    count: int
    bias: torch.Tensor | None
    resid: torch.Tensor | None

    def args(self) -> tuple:
        """The five epilogue arguments of the C entries."""
        return (None if self.bias is None else self.bias.data_ptr(),
                None if self.resid is None else self.resid.data_ptr(),
                self.ops, self.vals, self.count)


def _epilogue_codes(plan: SystolicPlan, epilogue_args, device,
                    dtype) -> EpilogueCodes:
    """The epilogue of ``plan`` for a kernel launch on ``device`` whose
    output has ``dtype``: a residual of another dtype is converted once
    here (a residual that is x itself is read in place)."""
    ops_, vals, bias, resid = [], [], None, None
    args = iter(epilogue_args)
    for st in plan.epilogue:
        ops_.append(EPILOGUE_CODES[st.op])
        vals.append(st.value or 0.0)
        if st.op in EPILOGUE_OPERANDS:
            arr = next(args)
            if arr.device != device:
                raise ValueError("epilogue operands must lie on x's device")
            if st.op == "residual_add":
                resid = arr.detach().to(dtype).contiguous()
            else:
                bias = arr.detach().to(torch.float32).reshape(-1).contiguous()
    if len(ops_) > MAX_EPILOGUE:
        raise ValueError(f"the kernels apply at most {MAX_EPILOGUE} "
                         "epilogue stages")
    return EpilogueCodes((ctypes.c_int * MAX_EPILOGUE)(*ops_),
                         (ctypes.c_float * MAX_EPILOGUE)(*vals), len(ops_),
                         bias, resid)


def _check_kernel_operands(kernel: str, x, w, plan: SystolicPlan) -> None:
    """Device and dtype checks every windowed kernel (K1, K2) makes."""
    if not x.is_cuda:
        raise ValueError(f"{kernel} takes a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel} takes float32 or bfloat16, got {x.dtype}")
    if plan.coeff_mode in ("dense", "perlane") and w.device != x.device:
        raise ValueError(f"a {plan.coeff_mode} plan takes its filter w on "
                         "the same device as x")


def _tile_launch(plan: SystolicPlan, x, block, t: int, out_sp=None):
    """A single-channel launch's geometry, padded to 3-D as both K1 and K2
    read it: ``(x, out, B, head, tile)``, ``x`` contiguous, ``out`` empty
    (None where the caller gives the output extent ``out_sp``, a crop of
    the plan's output that it stores itself), ``B`` the output tile,
    ``head`` the ints ``(batch, zin, hin, win, zo, ho, wo, lz, ly, lx)``
    (``l*`` the ``t``-fold lead) and ``tile`` ``(bz, bh, bw)``."""
    nb, nd = plan.batch_axes, plan.ndim_spatial
    spatial_in, full, B, _ = _geometry(plan, x.shape, block, t)
    x = x.contiguous()
    batch = 1
    for d in x.shape[:nb]:
        batch *= d
    out = None
    if out_sp is None:
        out_sp = full
        out = torch.empty(tuple(x.shape[:nb]) + out_sp, dtype=x.dtype,
                          device=x.device)
    else:
        out_sp = tuple(out_sp)
        B = tuple(min(b, o) for b, o in zip(block, out_sp))
    pad3 = (1,) * (3 - nd)
    lead, _ = plan.lead_trail()
    head = ((batch,) + pad3 + spatial_in + pad3 + out_sp
            + (0,) * (3 - nd) + tuple(t * v for v in lead))
    return x, out, B, head, pad3 + B


def _dense_oaddr(head) -> tuple[int, int, int, int]:
    """The output step ``(o_row, o_col, o_plane, o_img)`` of a dense
    ``(batch, zo, ho, wo)`` output."""
    zo, ho, wo = head[4:7]
    return (wo, 1, ho * wo, zo * ho * wo)


def _phase_launches(run, g, wa, plan: SystolicPlan, in_spatial):
    """``dx`` of a strided single-channel plan through a single-channel
    kernel (``run``, K1's or K2's): each output phase of
    :func:`adjoint.strided_input_adjoint_phases` is one launch of its
    stride-1 plan on the cotangent ``g`` as it is, storing its ``(hq,
    wq)`` outputs in place at ``dx[..., py::sh, px::sw]`` through the
    kernel's output step; phases no tap reaches stay zero."""
    lin = dataclasses.replace(plan, epilogue=())
    sh, sw = plan.stride_per_axis()
    H, W = in_spatial
    phases = [ph for ph in adjoint.strided_input_adjoint_phases(lin)
              if all(ph.extent(in_spatial))]
    g = g.contiguous()
    make = torch.zeros if any(ph.plan is None for ph in phases) \
        else torch.empty
    dx = make(tuple(g.shape[:-2]) + (H, W), dtype=g.dtype, device=g.device)
    for ph in phases:
        if ph.plan is None:
            continue
        p = _phase_plan_on(ph, tuple(g.shape[-2:]), in_spatial)
        py, px = ph.offset
        run(g, ph.filter(wa), p, default_block(p, 1), 1, "shift_psum", (),
            out=dx, out_sp=ph.extent(in_spatial), offset=py * W + px,
            oaddr=(sh * W, sw, H * W, H * W))
    return dx


class WindowKernel:
    """Wrapper of K1. ``launches`` counts the kernel launches it made:
    one per call, on the single-channel path (``ssam_window_launch``) and
    on the channel-reduce path (``ssam_window_reduce_launch``) alike, a
    fused epilogue or residual included; a strided reduce plan's input
    adjoint (:meth:`adjoint_phases`) is one launch for all its phases, a
    strided single-channel plan's one launch a phase that a tap
    reaches."""

    name = "ssam_window"
    source = "src/repro_torch/csrc/ssam_window.cu"
    replaces = "src/repro/core/engine.py:361 (_window_kernel, pallas_call at 587)"

    def __init__(self, library: _build.Library):
        self.library = library
        self.launches = 0

    def __call__(self, x: torch.Tensor, w, *, plan: SystolicPlan, block,
                 time_steps: int, variant: str,
                 epilogue_args=()) -> torch.Tensor:
        _check_kernel_operands("K1", x, w, plan)
        if _is_reduce(plan):
            return self._reduce(x, w, plan, epilogue_args)
        if plan.coeff_mode == "perlane":
            return self._perlane(x, w, plan, epilogue_args)
        return self._single(x, w, plan, block, time_steps, variant,
                            epilogue_args)

    def _single(self, x, w, plan, block, t, variant, epilogue_args, *,
                out=None, out_sp=None, offset=0, oaddr=None):
        """The single-channel path (``ssam_window.cuh``): one launch,
        strided or not, the epilogue at the store. ``out``, ``out_sp``,
        ``offset`` and ``oaddr`` (the output step) store a crop of the
        plan's output into a caller's tensor (an adjoint phase)."""
        table = tap_table(plan, None if w is None else tuple(w.shape))
        ints, cvals = _device_table(table, x.device)
        if plan.coeff_mode == "dense":
            cvals = w.detach().to(torch.float32).contiguous()
        x, fresh, B, head, tile = _tile_launch(plan, x, block, t, out_sp)
        out = fresh if out is None else out
        # TMA reads rows at a pitch of a multiple of 16 bytes: other widths
        # take a pitch-padded copy (the map keeps the logical width)
        xt, pitch = _tma_operand(x)
        lay = window_layout(plan, head, tile, t, x.element_size(), pitch,
                            variant, oaddr)
        epi = _epilogue_codes(plan, epilogue_args, x.device, x.dtype)
        err = self.library.get().ssam_window_launch(
            xt.data_ptr(), out.data_ptr() + offset * x.element_size(),
            int(x.dtype == torch.bfloat16), cvals.data_ptr(),
            ints.data_ptr(), (ctypes.c_int * len(lay.geom))(*lay.geom),
            len(lay.geom), *epi.args(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                               f"({plan.kind}, block {B}, t={t})")
        self.launches += 1
        return out

    def _reduce(self, x, w, plan, epilogue_args):
        """The channel-reduce path: ``x (B, C_in, H, W)`` against
        ``w (C_out, C_in, N, M)``, output stride and epilogue, one phase."""
        x4 = x if plan.batch_axes else x[None]
        phase = forward_phase(plan, tuple(x4.shape[2:]))
        out = self._launch_phases(x4, w, plan, (phase,),
                                  plan.stride_per_axis(), (1, 1),
                                  phase.extent, epilogue_args)
        return out if plan.batch_axes else out[0]

    def adjoint_phases(self, g, wa, *, plan: SystolicPlan, in_spatial):
        """``dx`` of a strided plan: for a reduce plan one launch, every
        output phase of :func:`adjoint_reduce_phases` reading the
        cotangent ``g`` at stride 1 and writing its positions of ``dx``
        in place; for a single-channel plan one launch a phase
        (:func:`_phase_launches`)."""
        _check_kernel_operands("K1", g, wa, plan)
        if not _is_reduce(plan):
            return _phase_launches(self._single, g, wa, plan, in_spatial)
        g4 = g if plan.batch_axes else g[None]
        lin = dataclasses.replace(plan, epilogue=())
        phases = adjoint_reduce_phases(lin, in_spatial)
        out = self._launch_phases(g4, wa, lin, phases, (1, 1),
                                  plan.stride_per_axis(), tuple(in_spatial),
                                  ())
        return out if plan.batch_axes else out[0]

    def _launch_phases(self, x4, w, plan, phases, read_stride, out_stride,
                       out_spatial, epilogue_args):
        """Launch ``ssam_window_reduce.cu`` on ``x4 (B, C_r, H, W)`` and
        ``w (C_o, C_r, N, M)``: the filter as the kernel stages it (C_out
        minor, padded to the block's 128 channels), the tap table, the
        layout of :func:`reduce_layout`."""
        x4 = x4.contiguous()
        if x4.data_ptr() % CP_ASYNC_BYTES:
            x4 = x4.clone()     # the staging copies start 16-byte aligned
        Bn, Cr, H, W = x4.shape
        Co, fsz = w.shape[0], plan.N * plan.M
        lay = reduce_layout(phases, batch=Bn, c_in=Cr, c_out=Co,
                            read_stride=read_stride,
                            elem_bytes=x4.element_size())
        wt = torch.zeros((Cr, fsz, lay.co_pad), dtype=torch.float32,
                         device=x4.device)
        wt[..., :Co] = w.detach().to(torch.float32).reshape(
            Co, Cr, fsz).permute(1, 2, 0)
        table = _device_ints(lay.table, x4.device)
        epi = _epilogue_codes(plan, epilogue_args, x4.device, x4.dtype)
        out = torch.empty((Bn, Co) + tuple(out_spatial), dtype=x4.dtype,
                          device=x4.device)
        err = self.library.get().ssam_window_reduce_launch(
            x4.data_ptr(), out.data_ptr(), int(x4.dtype == torch.bfloat16),
            wt.data_ptr(), table.data_ptr(), len(lay.table), *epi.args(),
            Bn, Cr, Co, lay.co_pad, H, W, *out_spatial, *read_stride,
            *out_stride, fsz, len(phases), lay.cols, lay.ci_slab,
            lay.row_elems, lay.x_bytes, lay.stage_bytes, *lay.grid[:2],
            lay.smem,
            torch.cuda.current_stream(x4.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                               f"({plan.kind}, reduce {Cr} -> {Co}, "
                               f"{len(phases)} phase(s))")
        self.launches += 1
        return out

    def _perlane(self, x, w, plan, epilogue_args):
        """The per-lane (depthwise) path: ``x (…, T, D)`` against ``w (K,
        D)``, each thread 16 bytes of lanes streaming down time, with the
        per-lane bias and the activations fused (``ssam_window_perlane.cu``,
        :func:`perlane_layout`)."""
        rows = perlane_row_table(plan)
        nb = plan.batch_axes
        x = x.contiguous()
        batch = 1
        for d in x.shape[:nb]:
            batch *= d
        T, D = x.shape[nb:]
        To = plan.out_shape((T, D))[0]
        lay = perlane_layout(plan, batch, T, D, x.element_size())
        if lay.grid[1] > 65535 or batch > 65535:
            raise ValueError(f"K1's per-lane grid cannot hold {To} rows of "
                             f"{batch} sequences")
        (lead, _), _ = plan.lead_trail()
        wf = w.detach().to(torch.float32).contiguous()
        epi = _epilogue_codes(plan, epilogue_args, x.device, x.dtype)
        out = torch.empty(tuple(x.shape[:nb]) + (To, D), dtype=x.dtype,
                          device=x.device)
        err = self.library.get().ssam_window_perlane_launch(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            wf.data_ptr(), (ctypes.c_int * PERLANE_MAX_ROWS)(*rows),
            plan.N, *epi.args(), batch, T, D, To, lead,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                               f"({plan.kind}, per-lane {tuple(x.shape)})")
        self.launches += 1
        return out


WINDOW_KERNEL = WindowKernel(_build.LIBRARY)

# K1's per-lane path (csrc/ssam_window_perlane.cu): a block of 128 threads,
# each 16 bytes of channels (4 fp32 or 8 bf16) of one sequence, streaming 32
# output rows through a cp.async ring of 8 rows a thread. (K4 tiles its lanes
# 128 a block, PERLANE_LANES.)
PERLANE_LANES = 128
PERLANE_THREADS = 128
PERLANE_ROWS = 32
PERLANE_STAGES = 8            # rows in flight a thread
PERLANE_MAX_ROWS = 8          # footprint rows (filter taps) it holds
# the epilogue chains K1's per-lane path has an instance for (codes of
# EPILOGUE_CODES); any other chain runs the generic instance
PERLANE_CHAINS = {(): "none", (1, 3): "bias+silu", (4,): "relu",
                  (1, 2, 5): "bias+gelu+scale"}


@dataclasses.dataclass(frozen=True)
class PerlaneLayout:
    """K1's per-lane geometry for one call: ``vec`` channels a thread (16
    bytes), ``window`` input rows in registers (4 for filters of up to 4
    taps, else 8), whether rows take 16-byte copies (``aligned``: D a
    multiple of ``vec``, operands 16-byte aligned) or element-wise masked
    ones, the epilogue instance ``chain`` (a name of
    :data:`PERLANE_CHAINS`, or ``"generic"``) and the grid (lane tiles,
    row tiles, sequences)."""

    vec: int
    window: int
    aligned: bool
    chain: str
    grid: tuple[int, int, int]


def perlane_layout(plan: SystolicPlan, batch: int, T: int, D: int,
                   elem_bytes: int, ptrs_aligned: bool = True
                   ) -> PerlaneLayout:
    """K1's per-lane layout of a call on ``(batch, T, D)`` (the choices
    ``ssam_window_perlane_launch`` makes from the same arguments)."""
    vec = CP_ASYNC_BYTES // elem_bytes
    To = plan.out_shape((T, D))[0]
    codes = tuple(EPILOGUE_CODES[st.op] for st in plan.epilogue)
    threads = -(-D // vec)
    grid = (-(-threads // PERLANE_THREADS), -(-To // PERLANE_ROWS), batch)
    return PerlaneLayout(vec, 4 if plan.N <= 4 else 8,
                         D % vec == 0 and ptrs_aligned,
                         PERLANE_CHAINS.get(codes, "generic"), grid)


def emulate_perlane_kernel(x: torch.Tensor, w: torch.Tensor, *,
                           plan: SystolicPlan,
                           epilogue_args=()) -> torch.Tensor:
    """K1's per-lane schedule walked in plain torch on the CPU, the spec of
    ``csrc/ssam_window_perlane.cu``: :func:`perlane_layout`'s grid, each
    thread's ``vec`` channels (masked at D), its stream of input rows
    (rows of the zero-weight window slots never loaded, zeros outside [0,
    T)) through a ring of :data:`PERLANE_STAGES` slots, the window of
    ``window`` rows, the sum over its slots in row order and the epilogue
    at the store. Every (b, t, d) is written exactly once (asserted).
    Returns ``x``'s shape and dtype."""
    check_supported(plan, 1, "shift_psum")
    _check_operands(plan, x, w, epilogue_args)
    if plan.coeff_mode != "perlane":
        raise ValueError("the emulation walks K1's per-lane path")
    rows = perlane_row_table(plan)
    nb = plan.batch_axes
    xs = x.reshape((-1,) + tuple(x.shape[nb:]))
    batch, T, D = xs.shape
    (lead, _), _ = plan.lead_trail()
    lay = perlane_layout(plan, batch, T, D, x.element_size())
    To = plan.out_shape((T, D))[0]
    NM, V = lay.window, lay.vec
    skip = NM - plan.N
    wf = w.detach().to(torch.float32)
    wr = torch.zeros((NM, D))
    for j in range(skip, NM):
        if rows[j - skip] >= 0:
            wr[j] = wf[rows[j - skip]]
    sums = torch.zeros((batch, To, D))
    hits = torch.zeros((batch, To, D), dtype=torch.int64)
    xf = xs.float()
    for bx in range(lay.grid[0]):
        d0 = bx * PERLANE_THREADS * V
        d1 = min(D, d0 + PERLANE_THREADS * V)   # the threads' masked lanes
        for by in range(lay.grid[1]):
            t0 = by * PERLANE_ROWS
            t1 = min(t0 + PERLANE_ROWS, To)
            r0 = t0 - lead - skip
            total = t1 - t0 + NM - 1
            slot = torch.zeros((PERLANE_STAGES, batch, d1 - d0))
            held = [None] * PERLANE_STAGES

            def issue(i):
                row = r0 + i
                held[i % PERLANE_STAGES] = i
                slot[i % PERLANE_STAGES] = (
                    xf[:, row, d0:d1] if (skip <= i < total
                                          and 0 <= row < T) else 0.0)

            for i in range(PERLANE_STAGES):
                issue(i)
            c = torch.zeros((NM, batch, d1 - d0))
            for i in range(total):
                assert held[i % PERLANE_STAGES] == i, "a slot holds another row"
                c = torch.cat([c[1:], slot[i % PERLANE_STAGES][None]])
                issue(i + PERLANE_STAGES)
                t = t0 + i - (NM - 1)
                if t < t0:
                    continue
                s = torch.zeros((batch, d1 - d0))
                for j in range(NM):           # row order, fp32
                    s = s + c[j] * wr[j, d0:d1]
                sums[:, t, d0:d1] = s
                hits[:, t, d0:d1] += 1
    assert bool((hits == 1).all()), "an output is not written exactly once"
    out = sums.reshape(tuple(x.shape[:nb]) + (To, D))
    if plan.epilogue:
        out = apply_epilogue(plan, out, epilogue_args)
    return out.to(x.dtype)


def perlane_row_table(plan: SystolicPlan) -> tuple[int, ...]:
    """A per-lane plan's taps as K1, K2 and K4 read them: per footprint
    row, the row of ``w`` its tap multiplies (``-1``: no tap), padded to
    :data:`PERLANE_MAX_ROWS`. The rows are summed in row order, which is
    the plan's order for the depthwise builder and its input adjoint."""
    if plan.N > PERLANE_MAX_ROWS:
        raise ValueError(f"the per-lane paths of K1 and K2 hold filters "
                         f"of up to {PERLANE_MAX_ROWS} taps, got N={plan.N}")
    rows = [-1] * PERLANE_MAX_ROWS
    prev = -1
    for tap in plan.steps[0].taps:
        r = tap.row_offset
        if not 0 <= r < plan.N or rows[r] != -1 or r < prev:
            raise ValueError(f"per-lane taps must sit on distinct rows of "
                             f"the footprint in row order, got {tap}")
        rows[r], prev = tap.coeff_id[-1], r
    return tuple(rows)

# K2's per-lane path (csrc/ssam_mxu_perlane.cu): a unit is 128 output rows
# (one m16n8k8 tile a lane: 16 rows of 8 steps) x 128 bytes of lanes (8
# chunks of 16 bytes) of one sequence, staged with 8 more input rows (the
# 16-step K window of the last 8 outputs); persistent blocks of 128 threads,
# MXU_PL_BLOCKS_PER_SM an SM, walk the units on a ring of two stages.
MXU_PL_CHUNKS = 8
MXU_PL_OUT = 128
MXU_PL_IN = MXU_PL_OUT + 8
MXU_PL_BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class MxuPerlaneLayout:
    """K2's per-lane geometry for one call: ``vec`` lanes of a 16-byte
    chunk, ``lanes`` of a tile (``8·vec``), the units (lane tiles, row
    tiles, sequences; the row tile fastest in the walk) and the persistent
    blocks that walk them. Whether rows take 16-byte copies the kernel
    decides from D and the pointers it is given."""

    vec: int
    lanes: int
    grid: tuple[int, int, int]
    blocks: int


def mxu_perlane_layout(plan: SystolicPlan, batch: int, T: int, D: int,
                       elem_bytes: int) -> MxuPerlaneLayout:
    """K2's per-lane layout of a call on ``(batch, T, D)`` (the choices
    ``ssam_mxu_perlane_launch`` makes from the same arguments)."""
    vec = CP_ASYNC_BYTES // elem_bytes
    lanes = MXU_PL_CHUNKS * vec
    To = plan.out_shape((T, D))[0]
    grid = (-(-D // lanes), -(-To // MXU_PL_OUT), batch)
    units = grid[0] * grid[1] * grid[2]
    return MxuPerlaneLayout(vec, lanes, grid,
                            min(units, MXU_PL_BLOCKS_PER_SM * H100_SMS))


def mxu_perlane_swizzle(r: int, out: bool = False) -> int:
    """The chunk permutation of a staged row ``r`` (an XOR on the chunk
    index): bits 0, 1 and 3 of an input row, so one phase of a warp's
    16-byte fragment loads (rows ``x..x+3`` and ``x+8..x+11``) reads eight
    chunks; bits 1-3 of an output row, so a phase of the staging stores
    (rows ``x, x+2, …, x+14``) writes eight."""
    return (r >> 1) & 7 if out else (r & 3) | ((r >> 1) & 4)


def _mma_coords():
    """The m16n8k8 TF32 fragment layouts (PTX ``mma.sync``, row.col): per
    thread ``(g, c)`` of a warp, the ``(row, column)`` of its four A, two
    B and four D elements."""
    a = [[(g + 8 * (f & 1), c + 4 * (f >> 1)) for f in range(4)]
         for g in range(8) for c in range(4)]
    b = [[(c + 4 * h, g) for h in range(2)] for g in range(8)
         for c in range(4)]
    d = [[(g + 8 * (f >> 1), 2 * c + (f & 1)) for f in range(4)]
         for g in range(8) for c in range(4)]
    return a, b, d


def emulate_mxu_perlane_kernel(x: torch.Tensor, w: torch.Tensor, *,
                               plan: SystolicPlan,
                               epilogue_args=()) -> torch.Tensor:
    """K2's per-lane schedule walked in plain torch on the CPU, the spec of
    ``csrc/ssam_mxu_perlane.cu``: :func:`mxu_perlane_layout`'s units
    (each walked once by the persistent blocks), each unit's
    :data:`MXU_PL_IN` input rows from ``t0 − lead`` (zeros outside
    [0, T) and past D) in chunks permuted by :func:`mxu_perlane_swizzle`,
    every thread's fragments gathered at the rows the kernel computes
    (``8g + c + 8·ks``, +64 for rows ``g + 8``, +4 for columns ``c + 4``),
    the lane's band ``B[m][j] = w[cid[m − j]]`` from the same thread
    formulas, the product assembled through the PTX fragment layouts in
    3xTF32 (truncating splits; a bf16 x without its small part), the D
    elements mapped back to output rows ``8i + j`` through the staging
    tile's permutation (every (b, t, d) written exactly once, asserted)
    and the epilogue at the store. Returns ``x``'s shape and dtype."""
    check_supported(plan, 1, "shift_psum")
    _check_operands(plan, x, w, epilogue_args)
    if plan.coeff_mode != "perlane":
        raise ValueError("the emulation walks K2's per-lane path")
    rows = perlane_row_table(plan)
    nb = plan.batch_axes
    xs = x.reshape((-1,) + tuple(x.shape[nb:]))
    batch, T, D = xs.shape
    (lead, _), _ = plan.lead_trail()
    lay = mxu_perlane_layout(plan, batch, T, D, x.element_size())
    To = plan.out_shape((T, D))[0]
    V, gx, gy = lay.vec, lay.grid[0], lay.grid[1]
    walked = sorted(u for blk in range(lay.blocks)
                    for u in range(blk, gx * gy * batch, lay.blocks))
    assert walked == list(range(gx * gy * batch)), "a unit is not walked once"
    CH = MXU_PL_CHUNKS
    Dp = gx * lay.lanes
    bf16 = x.dtype == torch.bfloat16
    # every block's staged tile at once, (batch, gy, gx, rows, chunks, V):
    # chunk k of row r lands at k ^ swizzle(r)
    xf = F.pad(xs.float(), (0, Dp - D))
    ti = (torch.arange(gy)[:, None] * MXU_PL_OUT - lead
          + torch.arange(MXU_PL_IN)[None])
    inside = ((ti >= 0) & (ti < T)).float()
    tile = (xf[:, ti.clamp(0, T - 1)] * inside[None, :, :, None]).reshape(
        batch, gy, MXU_PL_IN, gx, CH, V).movedim(3, 2)
    perm_in = torch.tensor([[k ^ mxu_perlane_swizzle(r) for k in range(CH)]
                            for r in range(MXU_PL_IN)])
    smem = torch.zeros_like(tile)
    smem[..., torch.arange(MXU_PL_IN)[:, None], perm_in, :] = tile
    wr = torch.zeros((PERLANE_MAX_ROWS, Dp))
    for r, cid in enumerate(rows):
        if cid >= 0:
            wr[r, :D] = w.detach().float()[cid]
    wr = wr.reshape(PERLANE_MAX_ROWS, gx, CH, V)
    acoords, bcoords, dcoords = _mma_coords()
    acc = torch.zeros((batch, gy, gx, CH, V, 16, 8))
    cor = torch.zeros_like(acc)
    for ks in range(2):
        A = torch.zeros((batch, gy, gx, CH, V, 16, 8))
        Bm = torch.zeros((gx, CH, V, 8, 8))
        for th in range(32):
            g, c = th >> 2, th & 3
            for f, (i, k) in enumerate(acoords[th]):
                r = 8 * g + c + 8 * ks + (64 if f & 1 else 0) \
                    + (4 if f & 2 else 0)
                A[..., i, k] = smem[:, :, :, r, perm_in[r]]
            for h, (k, j) in enumerate(bcoords[th]):
                r = 8 * ks + c + 4 * h - g
                if 0 <= r < PERLANE_MAX_ROWS:
                    Bm[..., k, j] = wr[r]
        ab, as_ = _tf32_split(A)
        if bf16:                 # a bf16 x is exact in TF32
            as_ = torch.zeros_like(as_)
        bb, bs = _tf32_split(Bm)
        acc = acc + ab @ bb
        cor = cor + (as_ @ bb + ab @ bs)
    prod = acc + cor
    # D element (i, j) of thread (g, c) is output row 8i + j of its block,
    # staged at chunk q ^ swizzle(row, out) and stored from there
    perm_out = [[k ^ mxu_perlane_swizzle(r, True) for k in range(CH)]
                for r in range(MXU_PL_OUT)]
    ost = torch.zeros((batch, gy, gx, MXU_PL_OUT, CH, V))
    hits = torch.zeros((MXU_PL_OUT, CH), dtype=torch.int64)
    for th in range(32):
        g, c = th >> 2, th & 3
        for f, (i, j) in enumerate(dcoords[th]):
            tr = 8 * g + 2 * c + (f & 1) + 32 * (f & 2)
            assert tr == 8 * i + j, "a D element leaves its output row"
            for q in range(CH):
                ost[:, :, :, tr, perm_out[tr][q]] = prod[:, :, :, q, :, i, j]
                hits[tr, perm_out[tr][q]] += 1
    assert bool((hits == 1).all()), "a staged output is not written once"
    outs = torch.stack([ost[:, :, :, r, perm_out[r]]
                        for r in range(MXU_PL_OUT)], 3)
    outs = outs.movedim(2, 3).reshape(batch, gy * MXU_PL_OUT, Dp)
    out = outs[:, :To, :D].reshape(tuple(x.shape[:nb]) + (To, D))
    if plan.epilogue:
        out = apply_epilogue(plan, out, epilogue_args)
    return out.to(x.dtype)


# K1's channel-reduce path (csrc/ssam_window_reduce.cu): a register-tiled
# implicit GEMM on the CUDA cores. A thread holds 8 output channels x 8
# consecutive output columns of fp32 sums, a block 128 channels x ``cols``
# columns (2·cols threads); the input channels stream through a ring of
# REDUCE_STAGES cp.async stages of ``ci_slab`` channels each.
REDUCE_CO_TILE = 128
REDUCE_COLS = (128, 96, 64)       # column tiles the wave model picks from
REDUCE_MW = 3                     # columns of one tap group's register window
REDUCE_STAGES = 3
REDUCE_STAGE_TARGET = 24 * 1024   # bytes of one ring stage (at least 1 channel)
REDUCE_CI_SLAB_MAX = 16
REDUCE_REGS = 128                 # registers a thread may use (launch bounds)
REDUCE_PHASE_INTS = 10            # one phase's header in the tap table
REDUCE_TABLE_INTS = 4096
CP_ASYNC_BYTES = 16               # the staging copies' width
H100_SM_SMEM = 233472             # shared memory of one SM (bytes)
H100_SM_REGS = 65536
H100_SMS = 132


def reduce_tap_table(plan: SystolicPlan) -> tuple[int, ...]:
    """The taps of a dense reduce plan as ``(row, col, coeff)`` triples in
    plan order: ``col`` is the cumulative lane shift of the tap's step,
    ``coeff`` the flat index into one ``(N, M)`` filter slice."""
    out, cum = [], 0
    for step in plan.steps:
        cum += step.shift
        for tap in step.taps:
            n, m = tap.coeff_id
            if not (0 <= tap.row_offset < plan.N and 0 <= cum < plan.M
                    and 0 <= n < plan.N and 0 <= m < plan.M):
                raise ValueError(f"tap {tap} at column {cum} lies outside "
                                 f"the {plan.exts} footprint")
            out += [tap.row_offset, cum, n * plan.M + m]
    if not out or len(out) // 3 > TABLE_SLOTS:
        raise ValueError(f"K1's reduce path takes 1..{TABLE_SLOTS} taps, "
                         f"got {len(out) // 3}")
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _device_ints(values: tuple[int, ...], device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=256)
def _device_floats(values: tuple[float, ...], device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class ReducePhase:
    """One output phase of a K1 reduce launch: output rows ``oy·osh + py``
    and columns ``ox·osw + px`` for ``oy < rows``, ``ox < cols`` (``offset
    = (py, px)``, ``extent = (rows, cols)``), each the sum over the input
    channels of ``x[oy·sh + dr, ox·sw + dc]·w[coeff]`` over ``taps``
    ``(dr, dc, coeff)`` (``coeff`` flat into one ``(N, M)`` filter slice),
    zero where the read leaves ``x``. A forward is one phase; a strided
    plan's input adjoint one per output phase."""

    offset: tuple[int, int]
    extent: tuple[int, int]
    taps: tuple[tuple[int, int, int], ...]


def forward_phase(plan: SystolicPlan, in_spatial) -> ReducePhase:
    """A reduce plan's forward as K1's one phase: taps at ``(row − ly,
    col − lx)`` in plan order."""
    (ly, lx), _ = plan.lead_trail()
    t = reduce_tap_table(plan)
    taps = tuple((t[i] - ly, t[i + 1] - lx, t[i + 2])
                 for i in range(0, len(t), 3))
    return ReducePhase((0, 0), plan.out_shape(tuple(in_spatial)), taps)


def adjoint_reduce_phases(plan: SystolicPlan, in_spatial
                          ) -> tuple[ReducePhase, ...]:
    """The input adjoint of a strided reduce plan as K1's phases
    (:func:`adjoint.strided_input_adjoint_phases`), read at stride 1 from
    the cotangent and written at the plan's stride into ``dx``; phases
    that hold no position of ``dx`` are left out, phases no tap reaches
    kept (they write zeros)."""
    out = []
    for ph in adjoint.strided_input_adjoint_phases(plan):
        ext = ph.extent(in_spatial)
        if all(ext):
            out.append(ReducePhase(ph.offset, ext, tuple(
                (dr, dc, n * plan.M + m) for dr, dc, (n, m) in ph.taps)))
    return tuple(out)


def reduce_groups(phase: ReducePhase):
    """``(dcmin, rows, groups)`` of a phase as K1 reads it: ``rows`` the
    distinct ``dr`` (one staged input row each per channel), ``groups``
    ``(row index, window column, tap of column 0, 1, …)`` with window
    column relative to ``dcmin`` and ``-1`` where no tap sits. A group is
    one register window of a thread: ``8·sw + REDUCE_MW − sw`` staged
    values that serve the taps of up to REDUCE_MW adjacent columns of one
    row. Groups in the order their first tap has in ``taps``; inside a
    group the taps by column (the kernel's summation order)."""
    if not phase.taps:
        return 0, (), ()
    dcmin = min(t[1] for t in phase.taps)
    rows, groups = [], {}
    for t, (dr, dc, _) in enumerate(phase.taps):
        if dr not in rows:
            rows.append(dr)
        wo = (dc - dcmin) // REDUCE_MW * REDUCE_MW
        g = groups.setdefault((rows.index(dr), wo), [-1] * REDUCE_MW)
        g[dc - dcmin - wo] = t
    return dcmin, tuple(rows), tuple((r, wo, *g)
                                     for (r, wo), g in groups.items())


def reduce_table(phases) -> tuple[int, ...]:
    """The tap table of a K1 reduce launch: per phase a header of
    :data:`REDUCE_PHASE_INTS` ints ``(py, px, rows, cols, ntaps, nrows,
    ngroups, dcmin, data offset, 0)``, then each phase's data: its taps'
    coefficient indices, its rows' ``dr`` and its groups
    (:func:`reduce_groups`)."""
    head, data = [], []
    base = REDUCE_PHASE_INTS * len(phases)
    for ph in phases:
        dcmin, rows, groups = reduce_groups(ph)
        head += [*ph.offset, *ph.extent, len(ph.taps), len(rows),
                 len(groups), dcmin, base + len(data), 0]
        data += [t[2] for t in ph.taps] + list(rows)
        data += [v for g in groups for v in g]
    table = tuple(head + data)
    if len(table) > REDUCE_TABLE_INTS:
        raise ValueError(f"K1's reduce tap table holds {REDUCE_TABLE_INTS} "
                         f"ints, the plan needs {len(table)}")
    return table


def staged_row_start(g0: int, elem_bytes: int) -> tuple[int, int]:
    """Where K1 stages an input row whose first needed element has the
    flat index ``g0``: ``(a0, shift)``, ``a0`` the 16-byte aligned element
    at or below ``g0`` (the cp.async copies start there), ``shift = g0 −
    a0`` the offset the reads apply."""
    per = CP_ASYNC_BYTES // elem_bytes
    return g0 - g0 % per, g0 % per


@dataclasses.dataclass(frozen=True)
class ReduceLayout:
    """K1's reduce-path geometry. A block owns 128 output channels (of
    ``co_pad``, the filter's padded C_out) × one output row × ``cols``
    columns of one phase, with ``2·cols`` threads; the grid is (column
    tiles, rows, batch × C_out tiles × phases). Each ring stage holds
    ``ci_slab`` input channels: per channel the phase's input rows of
    ``row_elems`` elements each (the row's span from its 16-byte aligned
    start, ``x_bytes`` for the slab) and its taps' 128 filter values;
    :data:`REDUCE_STAGES` stages after the tap table (``table``) make
    ``smem`` bytes.
    ``blocks_per_sm`` is what the registers and shared memory allow at
    once."""

    cols: int
    ci_slab: int
    row_elems: int
    x_bytes: int
    stage_bytes: int
    smem: int
    blocks_per_sm: int
    co_pad: int
    grid: tuple[int, int, int]
    table: tuple[int, ...]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def reduce_layout(phases, *, batch: int, c_in: int, c_out: int,
                  read_stride=(1, 1), elem_bytes: int = 4) -> ReduceLayout:
    """K1's reduce-path layout for ``phases`` (:class:`ReducePhase`). The
    column tile (one of :data:`REDUCE_COLS`) comes from a wave model: each
    SM runs ``blocks_per_sm`` blocks at a time, and a wave of them takes
    as long as ``blocks_per_sm·cols`` columns of work whether it is full
    or not; the tile with the fewest such columns wins, the wider on a
    tie."""
    sh, sw = read_stride
    per = CP_ASYNC_BYTES // elem_bytes
    table = reduce_table(phases)
    groups = [reduce_groups(ph) for ph in phases]
    rows_max = max(1, max(len(r) for _, r, _ in groups))
    taps_max = max(1, max(len(ph.taps) for ph in phases))
    wo_max = max((g[1] for _, _, gs in groups for g in gs), default=0)
    co_pad = _round_up(c_out, REDUCE_CO_TILE)
    table_bytes = _round_up(4 * len(table), 16)
    rows_out = max(ph.extent[0] for ph in phases)
    cols_out = max(ph.extent[1] for ph in phases)
    z = batch * (co_pad // REDUCE_CO_TILE) * len(phases)
    if rows_out > 65535 or z > 65535:
        raise ValueError(f"K1's reduce grid cannot hold {rows_out} rows or "
                         f"{batch} x {c_out} channels x {len(phases)} phases")

    def layout(cb):
        need = (cb - 1) * sw + wo_max + REDUCE_MW
        lp = _round_up(need + per - 1, per)
        w_per = taps_max * REDUCE_CO_TILE * 4
        x_per = rows_max * lp * elem_bytes
        slab = max(1, min(REDUCE_CI_SLAB_MAX, c_in,
                          REDUCE_STAGE_TARGET // (w_per + x_per)))
        x_bytes = _round_up(slab * x_per, 16)
        stage = x_bytes + slab * w_per
        smem = table_bytes + REDUCE_STAGES * stage
        threads = 2 * cb
        bps = max(1, min(H100_SM_REGS // (threads * REDUCE_REGS),
                         H100_SM_SMEM // (smem + 1024), 2048 // threads))
        return ReduceLayout(cb, slab, lp, x_bytes, stage,
                            smem, bps, co_pad,
                            (-(-cols_out // cb), rows_out, z), table)

    def cost(lay):
        blocks = lay.grid[0] * lay.grid[1] * lay.grid[2]
        waves = -(-blocks // (H100_SMS * lay.blocks_per_sm))
        return waves * lay.blocks_per_sm * lay.cols, -lay.cols

    lay = min((layout(cb) for cb in REDUCE_COLS), key=cost)
    if lay.smem > SMEM_LIMIT:
        raise ValueError(f"K1's reduce block needs {lay.smem} bytes of "
                         f"shared memory (limit {SMEM_LIMIT})")
    return lay


# K1's single-channel path (csrc/ssam_window.cuh): persistent blocks walk
# the output tiles in order, fed by a ring of TMA stages; each warp is a
# 32-lane systolic array over P output rows. 2-D plans run blocks of 256
# threads, two an SM where shared memory allows (the launch bounds' 128
# registers); 3-D plans blocks of 512, one an SM.
WINDOW_BLOCKS_PER_SM = {2: 2, 3: 1}
WINDOW_MAX_STAGES = 3
WINDOW_SMEM_TARGET = H100_SM_SMEM // 2 - 1024   # two blocks an SM
TMA_ALIGN = 16                    # bytes: TMA's base, row pitch and box start
TMA_MAX_BOX = 256                 # elements of a TMA box along one axis


@dataclasses.dataclass(frozen=True)
class TapTable:
    """A plan's taps as K1's single-channel kernel walks them. Per column
    step ``(shift, first, count, dense)`` (``steps``): the lane shift, the
    step's first tap and tap count in the compacted lists, and whether its
    taps fill every footprint slot (a branch-free body runs it). Per tap,
    in (dz, row) order within its step: its slot ``dz·N + row``
    (``slots``) and its index into the coefficient array (``cidx``: the
    plan's immediates, or the flattened dense filter). An output-strided
    plan's slot is ``rho << 8 | q`` for row ``sh·q + rho`` (its taps in
    (rho, q) order, no step dense)."""

    steps: tuple[tuple[int, int, int, int], ...]
    slots: tuple[int, ...]
    cidx: tuple[int, ...]
    coeffs: tuple[float, ...] | None

    def ints(self) -> tuple[int, ...]:
        """The table as the kernel reads it: the step records, the slots,
        then the coefficient indices."""
        return (tuple(v for st in self.steps for v in st) + self.slots
                + self.cidx)


@functools.lru_cache(maxsize=256)
def tap_table(plan: SystolicPlan, w_shape) -> TapTable:
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, steps = plan.N, len(plan.steps)
    reach = sum(s.shift for s in plan.steps)
    if nd == 3 and (D > 5 or N > 5):
        raise ValueError(f"K1 builds 3-D plans up to a 5x5 (depth x rows) "
                         f"footprint, got {D}x{N}")
    if N > 32:
        raise ValueError(f"K1 builds plans of up to 32 rows, got N={N}")
    if reach + 1 != plan.M or plan.M > WARP or steps > WARP:
        raise ValueError(
            f"K1 maps the lane axis onto one {WARP}-lane warp: the plan's "
            f"column steps (shift total {reach}, M={plan.M}, {steps} steps) "
            "must fit in it")
    if steps * D * N > TABLE_SLOTS:
        raise ValueError(f"plan has {steps * D * N} tap slots, K1 holds "
                         f"{TABLE_SLOTS}")
    sh = plan.stride_per_axis()[0]
    strided = _strided(plan)
    slots, cidx = [], []
    for m, step in enumerate(plan.steps):
        taps = {}
        for tap in step.taps:
            if not (0 <= tap.row_offset < N and 0 <= tap.z_offset < D):
                raise ValueError(f"tap {tap} lies outside the footprint")
            slot = (((tap.row_offset % sh) << 8) | tap.row_offset // sh
                    if strided else tap.z_offset * N + tap.row_offset)
            if slot in taps:
                raise ValueError(f"two taps of step {m} read the same "
                                 f"cell {tap}")
            if plan.coeff_mode == "table":
                if not 0 <= tap.coeff_id[-1] < len(plan.coeffs or ()):
                    raise ValueError(f"tap {tap} has no coefficient in the "
                                     "plan's table")
                taps[slot] = tap.coeff_id[-1]
            else:
                if len(tap.coeff_id) != len(w_shape) or not all(
                        0 <= i < n for i, n in zip(tap.coeff_id, w_shape)):
                    raise ValueError(f"tap {tap} lies outside the filter of "
                                     f"shape {w_shape}")
                flat = 0
                for i, n in zip(tap.coeff_id, w_shape):
                    flat = flat * n + i
                taps[slot] = flat
        for slot in sorted(taps):
            slots.append(slot)
            cidx.append(taps[slot])
    return TapTable(tap_steps(plan), tuple(slots), tuple(cidx), plan.coeffs)


def tap_steps(plan: SystolicPlan) -> tuple[tuple[int, int, int, int], ...]:
    """The step records ``(shift, first, count, dense)`` of
    :func:`tap_table`, which depend on the plan's taps only."""
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    out, first = [], 0
    for step in plan.steps:
        n = len({(t.z_offset, t.row_offset) for t in step.taps})
        out.append((step.shift, first, n,
                    int(n == D * plan.N and not _strided(plan))))
        first += n
    return tuple(out)


def _strided(plan: SystolicPlan) -> bool:
    return any(v > 1 for v in plan.stride_per_axis())


@functools.lru_cache(maxsize=256)
def _device_table(table: TapTable, device):
    """Device copies of a tap table (:meth:`TapTable.ints`) and the plan's
    immediates, kept per (table, device)."""
    ints = torch.tensor(table.ints(), dtype=torch.int32, device=device)
    const = torch.tensor(table.coeffs or (0.0,), dtype=torch.float32,
                         device=device)
    return ints, const


@dataclasses.dataclass(frozen=True)
class WindowLayout:
    """K1's single-channel geometry for one call. Output tiles ``tile``
    ``(bz, bh, bw)`` (``tiles`` per axis: batch, z, y, x; x fastest in
    the walk); ``grid`` persistent blocks, block ``g`` taking tiles ``g,
    g + grid, …``. A tile's input, widened by the t footprints, is staged
    by TMA boxes ``box`` ``(z, y, x)``,
    ``boxes`` of them per axis (each axis at most 256 elements; the x
    extent from the 16-byte aligned column at or below the tile's first
    input column): a stage holds ``boxes[2]`` blocks of ``sz × sy ×
    box_x`` elements. ``stages`` stages of ``stage_bytes`` make the ring;
    then ``bufs`` fp32 words (the widened bf16 stage, the odd and the
    even iterates: the last application writes the output tile into the
    even buffer), the tap table, the barriers and the slack the register
    cache's discarded rows read past the last buffer: ``smem`` bytes.
    ``geom`` is what the C entry takes."""

    tile: tuple[int, int, int]
    tiles: tuple[int, int, int, int]
    box: tuple[int, int, int]
    boxes: tuple[int, int, int]
    stage_bytes: int
    stages: int
    bufs: tuple[int, int, int]
    smem: int
    blocks_per_sm: int
    grid: int
    geom: tuple[int, ...]

    @property
    def ntiles(self) -> int:
        return self.tiles[0] * self.tiles[1] * self.tiles[2] * self.tiles[3]

    @property
    def staged(self) -> tuple[int, int]:
        """Staged (slices, rows) of one x-block: ``(sz, sy)``."""
        return (self.boxes[0] * self.box[0], self.boxes[1] * self.box[1])

    def tile_origin(self, tile: int) -> tuple[int, int, int, int]:
        """``(b, oz0, oy0, ox0)`` of tile number ``tile``."""
        _, tz, ty, tx = self.tiles
        b, r = divmod(tile, tz * ty * tx)
        iz, r = divmod(r, ty * tx)
        iy, ix = divmod(r, tx)
        bz, bh, bw = self.tile
        return b, iz * bz, iy * bh, ix * bw


# K1's output-strided instantiations (``csrc/ssam_window_2d_strided.cu``):
# one a cache-row count ``⌈N/sh⌉`` up to WINDOW_STRIDED_EXACT, one of
# WINDOW_STRIDED_BUCKET rows above it that loads only the rows its taps
# read (a bucket for the exact counts cost the forward 30–75 %, PERF.md).
WINDOW_STRIDED_EXACT, WINDOW_STRIDED_BUCKET = 16, 32


def window_rows(plan: SystolicPlan) -> int:
    """Cache rows ``N`` of the K1 single-channel instantiation that runs
    ``plan``: the plan's own rows; for an output-strided plan ``⌈N/sh⌉``
    up to :data:`WINDOW_STRIDED_EXACT`, else
    :data:`WINDOW_STRIDED_BUCKET`."""
    if not _strided(plan):
        return plan.N
    n = -(-plan.N // plan.stride_per_axis()[0])
    return n if n <= WINDOW_STRIDED_EXACT else WINDOW_STRIDED_BUCKET


def window_p(plan: SystolicPlan) -> int:
    """Output rows a thread of K1's single-channel kernel holds (its
    instantiation tables in ``csrc/ssam_window_{2d,2d_wide,3d}.cu``, each
    chosen by paired runs on the card): 32 for 2-D plans of up to 13 rows,
    16 for wider ones; 16 for 3-D plans whose register cache then holds at
    most 54 values (``D·(N + 15) ≤ 54``: the 3×3 footprints), else 8. An
    output-strided plan's instantiation (:func:`window_rows`) holds 16,
    8 in the one of 32 rows."""
    if _strided(plan):
        return 16 if window_rows(plan) <= 16 else 8
    if plan.ndim_spatial == 2:
        return 32 if plan.N <= 13 else 16
    return 16 if plan.depth * (plan.N + 15) <= 54 else 8


def _xblock(sz: int, sy: int, box_x: int, elem_bytes: int) -> int:
    """Elements of one x-block of a K1 stage: ``sz × sy × box_x`` padded
    to 128 bytes, where TMA's next box may land."""
    return _round_up(sz * sy * box_x, 128 // elem_bytes)


def _window_smem(plan: SystolicPlan, tile, t: int, elem_bytes: int,
                 stages: int):
    """``(box, boxes, stage_bytes, bufs, smem)`` of a K1 single-channel
    block at a ring of ``stages``."""
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, M = plan.N, plan.M
    bz, bh, bw = tile
    sh, sw = plan.stride_per_axis()[-2:]
    per = TMA_ALIGN // elem_bytes
    zs, hs = bz + t * (D - 1), sh * (bh - 1) + 1 + t * (N - 1)
    wneed = _round_up(sw * (bw - 1) + 1 + t * (M - 1) + per - 1, per)
    nbx = -(-wneed // TMA_MAX_BOX)
    box_x = _round_up(-(-wneed // nbx), per)
    # every box lands at a 128-byte aligned address: stacked y- and z-boxes
    # take a few more rows or slices, each x-block is padded to 128 bytes
    row = box_x * elem_bytes
    nby = -(-hs // TMA_MAX_BOX)
    box_y = -(-hs // nby)
    if nby > 1:
        box_y = _round_up(box_y, 128 // math.gcd(128, row))
    if nby > 1 and zs > 1:      # a box per slice: y-boxes stack in a slice
        nbz, box_z = zs, 1
    else:
        nbz = -(-zs // TMA_MAX_BOX)
        box_z = -(-zs // nbz)
        if nbz > 1:
            box_z = _round_up(box_z, 128 // math.gcd(128, nby * box_y * row))
    elems = nbx * _xblock(nbz * box_z, nby * box_y, box_x, elem_bytes)
    stage_bytes = _round_up(elems * elem_bytes, 128)

    def tile_words(j):
        return (bz + j * (D - 1)) * (bh + j * (N - 1)) * (bw + j * (M - 1))

    c0 = _round_up(elems, 4) if elem_bytes == 2 else 0
    odd = max((tile_words(j) for j in range(1, t, 2)), default=0)
    even = max(tile_words(j) for j in range(0, t, 2))
    bufs = (c0, _round_up(odd, 4), _round_up(even, 4))
    taps = sum(len(s.taps) for s in plan.steps)
    table = 8 * (taps + 1) + 8 * WINDOW_MAX_STAGES
    slack = 4 * window_p(plan) * nbx * box_x
    smem = (128 + stages * stage_bytes + 4 * sum(bufs) + table + slack)
    return ((box_z, box_y, box_x), (nbz, nby, nbx), stage_bytes, bufs,
            _round_up(smem, 16))


def window_layout(plan: SystolicPlan, head, tile, t: int,
                  elem_bytes: int = 4, pitch: int | None = None,
                  variant: str = "shift_psum",
                  oaddr=None) -> WindowLayout:
    """K1's single-channel layout for a call of :func:`_tile_launch`'s
    ``head`` and ``tile``, storing through the output step ``oaddr``
    (``(o_row, o_col, o_plane, o_img)``; default the dense output). The
    ring takes the most stages (up to 3) that leave two blocks an SM (2-D
    plans); failing that, or for 3-D plans, the most that fit one block;
    failing that, the call raises."""
    batch, zin, hin, win, zo, ho, wo, lz, ly, lx = head
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    tile = tuple(tile)
    fits = [(s, _window_smem(plan, tile, t, elem_bytes, s))
            for s in range(WINDOW_MAX_STAGES, 0, -1)]
    two = WINDOW_BLOCKS_PER_SM[nd] == 2
    pick = next(((s, f) for s, f in fits
                 if two and f[4] <= WINDOW_SMEM_TARGET), None) or next(
        ((s, f) for s, f in fits if f[4] <= SMEM_LIMIT), None)
    if pick is None:
        raise ValueError(
            f"block {tile[3 - nd:]} needs {fits[-1][1][4]} bytes of shared "
            f"memory (limit {SMEM_LIMIT}); pass a smaller block")
    stages, (box, boxes, stage_bytes, bufs, smem) = pick
    bz, bh, bw = tile
    tiles = (batch, -(-zo // bz), -(-ho // bh), -(-wo // bw))
    ntiles = tiles[0] * tiles[1] * tiles[2] * tiles[3]
    if ntiles >= 2 ** 31:
        raise ValueError(f"K1's tile walk cannot count {ntiles} tiles")
    bps = max(1, min(WINDOW_BLOCKS_PER_SM[nd],
                     H100_SM_SMEM // (smem + 1024)))
    grid = min(ntiles, bps * H100_SMS)
    ntaps = sum(len(s.taps) for s in plan.steps)
    geom = (nd, D, plan.N, plan.M, len(plan.steps), ntaps, t,
            VARIANTS.index(variant), batch, zin, hin, win,
            pitch or tma_pitch(win, elem_bytes),
            zo, ho, wo, lz, ly, lx, bz, bh, bw,
            box[2], box[1], box[0], boxes[2], boxes[1], boxes[0],
            stages, stage_bytes, *bufs, smem, grid,
            *plan.stride_per_axis()[-2:], *(oaddr or _dense_oaddr(head))
            ) + tuple(v for st in tap_steps(plan) for v in st)
    return WindowLayout(tile, tiles, box, boxes, stage_bytes, stages,
                        bufs, smem, bps, grid, geom)


def smem_bytes(plan: SystolicPlan, block, time_steps: int) -> int:
    """Dynamic shared memory of one fp32 single-channel K1 block with one
    ring stage (layout of ``ssam_window.cuh``, :func:`window_layout`)."""
    tile = (1,) * (3 - plan.ndim_spatial) + tuple(block)
    return _window_smem(plan, tile, time_steps, 4, 1)[4]


def default_block(plan: SystolicPlan, time_steps: int = 1) -> tuple[int, ...]:
    """The output tile of the block walk: four warp-widths of valid lanes
    across, 64 rows (2-D) or 16 rows by 8 slices (3-D), halved until a
    single-channel K1 block with one stage fits (:func:`window_layout`
    then deepens the ring and packs two 2-D blocks an SM where shared
    memory allows: paired runs on the card found these large tiles faster
    than smaller ones at t > 1, whose halo the fused steps recompute); an
    mxu plan takes K2's tile (:func:`_mxu_block`). (The reduce paths tile
    their output themselves: K1 128 channels x 1 row x 64-128 columns, K2
    128 or 256 channels x 1 row x 128 or 64 columns.)"""
    if plan.strategy == "mxu":
        return _mxu_block(plan, time_steps)
    need, limit = smem_bytes, SMEM_LIMIT
    V = max(1, WARP - (plan.M - 1))
    if _strided(plan):
        # items of P rows x 32 columns, 8 a tile, the tile's input small
        # enough for two blocks an SM
        block, limit = [4 * window_p(plan), 2 * WARP], WINDOW_SMEM_TARGET
    elif plan.ndim_spatial == 3:
        block = [8, 16, 2 * V]
    else:
        block = [64, 4 * V]
    while need(plan, block, time_steps) > limit:
        i = max(range(len(block) - 1), key=lambda a: block[a])
        if block[i] == 1:
            break
        block[i] = max(1, block[i] // 2)
    return tuple(block)


def _shfl_up(v: torch.Tensor, d: int) -> torch.Tensor:
    """``__shfl_up_sync(full, v, d)`` over the last (lane) axis of 32:
    lane ``l ≥ d`` takes lane ``l − d``'s value, lanes below ``d`` keep
    their own."""
    return torch.cat([v[..., :d], v[..., :-d]], dim=-1) if d else v


def _shfl_down(v: torch.Tensor, d: int) -> torch.Tensor:
    """``__shfl_down_sync(full, v, d)``: lane ``l < 32 − d`` takes lane
    ``l + d``'s value, the top ``d`` lanes keep their own."""
    return torch.cat([v[..., d:], v[..., -d:]], dim=-1) if d else v


def _tma_box(xm: torch.Tensor, win: int, b: int, corner, box) -> torch.Tensor:
    """One TMA box of the map over ``xm (batch, Z, H, pitch)`` with the
    logical width ``win``: ``box (z, y, x)`` elements from ``corner (z0,
    y0, x0)``, zeros outside the tensor (negative coordinates too). The
    rules the card enforces are asserted: at most 256 elements per axis,
    the innermost start and extent multiples of 16 bytes."""
    es = xm.element_size()
    assert all(1 <= n <= TMA_MAX_BOX for n in box), box
    assert (corner[2] * es) % TMA_ALIGN == 0 and (box[2] * es) % TMA_ALIGN == 0
    out = xm.new_zeros(box)
    src, dst = [], []
    for c, n, size in zip(corner, box, (xm.shape[1], xm.shape[2], win)):
        lo, hi = max(c, 0), min(c + n, size)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - c, hi - c))
    out[tuple(dst)] = xm[(b,) + tuple(src)]
    return out


def _emulate_apply(src: torch.Tensor, addr, ext, table: TapTable, coef,
                   plan: SystolicPlan, variant: str, P: int) -> torch.Tensor:
    """One application of ``ssam_window.cuh::apply_once`` on the emulated
    shared memory ``src`` (flat fp32; NaN past the source, where the
    kernel reads whatever lies there): the warp items of ``V = 33 − M``
    valid lanes and ``P`` rows (every slice at once), the register cache
    read through ``addr (pitch, plane, bw, bstride, shift)`` with the
    lane's column clamped to the source's last, the compacted column
    steps with 32-lane shuffles, the valid lanes written once each to a
    dense ``(zs−D+1, hs−N+1, ws−M+1)`` result."""
    pitch, plane, bw, bstride, shift = addr
    zs, hs, ws = ext
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, M = plan.N, plan.M
    C = N + P - 1
    V = WARP - (M - 1)
    zd, hd, wd = zs - (D - 1), hs - (N - 1), ws - (M - 1)
    nwc, nyc = -(-wd // V), -(-hd // P)
    lane = torch.arange(WARP)
    col = torch.arange(nwc)[:, None] * V + lane               # (nwc, 32)
    sc = col.clamp(max=ws - 1) + shift
    cbase = (sc // bw) * bstride + sc % bw
    rows = torch.arange(nyc)[:, None] * P + torch.arange(C)  # (nyc, C)
    zz = torch.arange(zd)[:, None] + torch.arange(D)         # (zd, D)
    addr = (zz[:, :, None, None, None, None] * plane
            + rows[None, None, None, :, :, None] * pitch
            + cbase[None, None, :, None, None, :])
    assert int(addr.max()) < src.numel()
    c = src[addr]                                # (zd, D, nwc, nyc, C, 32)
    s = c.new_zeros((zd, nwc, nyc, P, WARP))
    cum = 0
    for shift_m, first, count, dense in table.steps:
        cum += shift_m
        if variant == "shift_psum":
            s = _shfl_up(s, shift_m)
        if dense:
            assert table.slots[first:first + count] == tuple(range(D * N))
        for k in range(first, first + count):
            dz, r = divmod(table.slots[k], N)
            v = c[:, dz, :, :, r:r + P, :]
            if variant == "shift_data":
                v = _shfl_down(v, cum)
            s = s + v * coef[k]
    if variant == "shift_psum":
        oc, ok_lane = col - (M - 1), lane >= M - 1
    else:
        oc, ok_lane = col, lane < V
    y = torch.arange(nyc)[:, None] * P + torch.arange(P)     # (nyc, P)
    ok = (ok_lane & (oc < wd))[:, None, None, :] & (y < hd)[None, :, :, None]
    idx = torch.nonzero(ok.expand(nwc, nyc, P, WARP), as_tuple=True)
    oy, ox = y[idx[1], idx[2]], oc[idx[0], idx[3]]
    dst = s.new_full((zd, hd, wd), float("nan"))
    hits = torch.zeros((hd, wd), dtype=torch.int64)
    hits.index_put_((oy, ox), torch.ones_like(oy), accumulate=True)
    assert bool((hits == 1).all()), "an output is not written exactly once"
    dst[:, oy, ox] = s[:, idx[0], idx[1], idx[2], idx[3]]
    return dst


def _emulate_strided(src: torch.Tensor, addr, hs: int, out_ext,
                     table: TapTable, coef, plan: SystolicPlan,
                     P: int) -> torch.Tensor:
    """One application of ``ssam_window.cuh::apply_strided`` on the
    emulated shared memory ``src`` through ``addr (pitch, plane, bw,
    bstride, shift)``: items of ``P`` rows × 32 lanes, lane ``l`` on
    output column ``l`` (clamped to the last) reading input column ``sw·l
    + cum`` of each step, the register cache's ``⌈N/sh⌉ + P − 1`` rows
    that the taps read (of :func:`window_rows`)
    ``sh·(y0 + i) + rho`` (clamped to the source's last, ``hs − 1``)
    loaded once per (step, row phase), the taps in (rho, q) order. Returns
    the dense fp32 ``(hd, wd)`` outputs."""
    pitch, _, bw, bstride, shift = addr
    hd, wd = out_ext
    sh, sw = plan.stride_per_axis()
    C = -(-plan.N // sh) + P - 1
    nwc, nyc = -(-wd // WARP), -(-hd // P)
    oc = torch.arange(nwc)[:, None] * WARP + torch.arange(WARP)
    colbase = sw * oc.clamp(max=wd - 1) + shift                 # (nwc, 32)
    y0 = torch.arange(nyc)[:, None] * P
    s = torch.zeros((nyc, P, nwc, WARP))
    cum = 0
    for shift_m, first, count, dense in table.steps:
        assert not dense, "a strided step runs its taps' records"
        cum += shift_m
        sc = colbase + cum
        xoff = (sc // bw) * bstride + sc % bw
        k = first
        while k < first + count:
            rho = table.slots[k] >> 8
            rows = (sh * (y0 + torch.arange(C)) + rho).clamp(max=hs - 1)
            a = rows[:, :, None, None] * pitch + xoff[None, None]
            assert int(a.max()) < src.numel(), "a read leaves the source"
            c = src[a]                                  # (nyc, C, nwc, 32)
            while k < first + count and table.slots[k] >> 8 == rho:
                q = table.slots[k] & 255
                s = s + c[:, q:q + P] * coef[k]
                k += 1
    return s.reshape(nyc * P, nwc * WARP)[:hd, :wd]


def _tile_epilogue(plan: SystolicPlan, vals: torch.Tensor, epilogue_args,
                   resid, b: int, origin) -> torch.Tensor:
    """The epilogue as a kernel applies it at the store: the fp32 sums of
    one output tile ``vals`` at ``origin`` of image ``b``, the residual
    (the output's ``(batch, …)`` view ``resid``) read at the outputs'
    positions."""
    if not plan.epilogue:
        return vals
    sl = (b,) + tuple(slice(o, o + n) for o, n in
                      zip(origin[-vals.ndim:], vals.shape))
    args = [resid[sl].float() if st.op == "residual_add" else a
            for st, a in zip(epilogue_operand_stages(plan.epilogue),
                             epilogue_args)]
    return apply_epilogue(plan, vals, args)


def emulate_window_kernel(x: torch.Tensor, w=None, *, plan: SystolicPlan,
                          block=None, time_steps: int = 1,
                          variant: str = "shift_psum",
                          epilogue_args=()) -> torch.Tensor:
    """K1's single-channel schedule walked in plain torch on the CPU: the
    spec of ``csrc/ssam_window.cuh`` that the CPU tests hold to the plain
    version. The wrapper's operand (a pitch-padded copy where x's rows are
    not a multiple of 16 bytes), :func:`window_layout`, the persistent
    walk (block ``g`` takes tiles ``g, g + grid, …``; a stage is waited
    for by the tile it was filled with, and refilled after the tile's
    first application), each stage's TMA boxes (:func:`_tma_box`), the
    t applications (:func:`_emulate_apply`: the stage, then the fp32
    iterates in two ping-pong buffers, the last into the even one; an
    output-strided plan's one :func:`_emulate_strided`) and the output
    tile stored from it through the epilogue (:func:`_tile_epilogue`).
    Returns ``x``'s shape and dtype."""
    check_supported(plan, time_steps, variant)
    _check_operands(plan, x, w, epilogue_args, time_steps)
    if _is_reduce(plan) or plan.coeff_mode == "perlane" \
            or plan.strategy == "mxu":
        raise ValueError("the emulation walks K1's single-channel path")
    block = tuple(block or default_block(plan, time_steps))
    t, nd = time_steps, plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, M = plan.N, plan.M
    P = window_p(plan)
    table = tap_table(plan, None if w is None else tuple(w.shape))
    cvals = (torch.tensor(plan.coeffs, dtype=torch.float32)
             if plan.coeff_mode == "table"
             else w.detach().to(torch.float32).flatten())
    coef = cvals[list(table.cidx)]
    xc, out, _, head, tile = _tile_launch(plan, x, block, t)
    xt, pitch = _tma_operand(xc)
    batch, zin, hin, win, zo, ho, wo, lz, ly, lx = head
    es = x.element_size()
    lay = window_layout(plan, head, tile, t, es, pitch, variant)
    assert lay.smem <= SMEM_LIMIT
    xm = xt.reshape(batch, zin, hin, pitch)
    out4 = out.reshape(batch, zo, ho, wo)
    resid = next((a.reshape(batch, zo, ho, wo) for st, a in zip(
        epilogue_operand_stages(plan.epilogue), epilogue_args)
        if st.op == "residual_add"), None)
    sh, sw = plan.stride_per_axis()[-2:]
    (box_z, box_y, box_x), (nbz, nby, nbx) = lay.box, lay.boxes
    sz, sy = lay.staged
    bstride = _xblock(sz, sy, box_x, es)
    slack = torch.full((P * nbx * box_x + WARP,), float("nan"))
    done = torch.zeros(lay.ntiles, dtype=torch.int64)
    for g in range(lay.grid):
        mine = list(range(g, lay.ntiles, lay.grid))
        ring = mine[:lay.stages] + [None] * (lay.stages - len(mine))
        for i, tile_no in enumerate(mine):
            s = i % lay.stages
            assert ring[s] == tile_no, "a stage holds another tile"
            b, oz0, oy0, ox0 = lay.tile_origin(tile_no)
            x0, shift = staged_row_start(sw * ox0 - lx, es)
            stage = torch.empty(nbx * bstride)
            for jx in range(nbx):
                for jz in range(nbz):
                    for jy in range(nby):
                        box = _tma_box(xm, win, b, (oz0 - lz + jz * box_z,
                                                    sh * oy0 - ly
                                                    + jy * box_y,
                                                    x0 + jx * box_x),
                                       lay.box)
                        off = (jx * bstride
                               + (jz * box_z * sy + jy * box_y) * box_x)
                        assert (off * es) % 128 == 0, "a box lands unaligned"
                        stage[off:off + box.numel()] = box.flatten().float()
            tz, ty, tx = (min(a, n - o) for a, n, o in
                          zip(lay.tile, (zo, ho, wo), (oz0, oy0, ox0)))
            ext = (tz + t * (D - 1), ty + t * (N - 1), tx + t * (M - 1))
            src = torch.cat([stage, slack])
            addr = (box_x, sy * box_x, box_x, bstride, shift)
            if sh * sw > 1:
                dst = _emulate_strided(src, addr, sh * (ty - 1) + N,
                                       (ty, tx), table, coef, plan, P)[None]
                nxt = i + lay.stages
                ring[s] = mine[nxt] if nxt < len(mine) else None
                ext, t_left = (1, ty, tx), 0
            else:
                t_left = t
            for k in range(t_left):
                dst = _emulate_apply(src, addr, ext, table, coef, plan,
                                     variant, P)
                if k == 0:      # the stage is read: refill it
                    nxt = i + lay.stages
                    ring[s] = mine[nxt] if nxt < len(mine) else None
                ext = tuple(dst.shape)
                addr = (ext[2], ext[1] * ext[2], 1 << 30, 0, 0)
                src = torch.cat([dst.flatten(), slack])
            assert ext == (tz, ty, tx)
            out4[b, oz0:oz0 + tz, oy0:oy0 + ty, ox0:ox0 + tx] = \
                _tile_epilogue(plan, dst, epilogue_args, resid, b,
                               (oz0, oy0, ox0))
            done[tile_no] += 1
    assert bool((done == 1).all()), "a tile is not walked exactly once"
    return out


# ---------------------------------------------------------------------------
# K2: the tensor-core kernel (strategy='mxu')
# ---------------------------------------------------------------------------

MXU_MAX_TAPS = 1024           # single-channel taps K2 holds (padded to 8)


def _round8(n: int) -> int:
    return -(-n // MXU_TAP_ALIGN) * MXU_TAP_ALIGN


def mxu_tap_table(plan: SystolicPlan, w_shape) -> tuple[int, ...]:
    """The taps of a single-channel plan as K2 reads them: ``(dz, row,
    col, cidx)`` quadruples in plan order, ``cidx`` an index into the
    plan's immediates ('table') or the flattened filter ('dense')."""
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    out = []
    for cum, tap in flat_taps(plan):
        dz = tap.z_offset if nd == 3 else 0
        if not (0 <= dz < D and 0 <= tap.row_offset < plan.N
                and 0 <= cum < plan.M):
            raise ValueError(f"tap {tap} at column {cum} lies outside the "
                             f"{plan.exts} footprint")
        if plan.coeff_mode == "table":
            if not 0 <= tap.coeff_id[-1] < len(plan.coeffs or ()):
                raise ValueError(f"tap {tap} has no coefficient in the "
                                 "plan's table")
            cidx = tap.coeff_id[-1]
        else:
            if len(tap.coeff_id) != len(w_shape) or not all(
                    0 <= i < n for i, n in zip(tap.coeff_id, w_shape)):
                raise ValueError(f"tap {tap} lies outside the filter of "
                                 f"shape {w_shape}")
            cidx = 0
            for i, n in zip(tap.coeff_id, w_shape):
                cidx = cidx * n + i
        out += [dz, tap.row_offset, cum, cidx]
    if not out or _round8(len(out) // 4) > MXU_MAX_TAPS:
        raise ValueError(f"K2 takes 1..{MXU_MAX_TAPS} taps, got "
                         f"{len(out) // 4}")
    return tuple(out)


# K2's single-channel path (csrc/ssam_mxu.cu): Toeplitz coefficient tiles
# on the tensor cores. A tapped footprint row (dz, r) is cut into entries of
# at most MXU_SPAN consecutive columns; an entry's k-steps s < KK hold B_s[k,
# n] = c(dz, r, cmin + 8s + k − n) for 8 consecutive output columns n. A
# warp item is MXU_ROWS output rows × MXU_CHUNKS chunks of 8 columns of one
# slice; persistent blocks of 256 threads stage their tiles' input by TMA
# into a ring of up to MXU_MAX_STAGES stages.
MXU_ROWS = 16                 # output rows of an item (mma.m16n8k8's M)
MXU_CHUNKS = 4                # 8-column chunks of an item
MXU_KSTEPS = 4                # k-steps of one entry
MXU_FLUSH = 8                 # k-steps of big·big summed in the tensor core
MXU_SPAN = 8 * MXU_KSTEPS - 7  # columns of one entry: KK = ⌈(span + 7)/8⌉
MXU_MAX_STAGES = 3
MXU_SLACK = 64                # zeroed words past the last buffer (over-reads)
MXU_MAX_SW = 4                # column strides an entry's window holds


def mxu_span(sw: int = 1) -> int:
    """Columns an entry of K2's single-channel path spans at output column
    stride ``sw``: its ``⌈(span + 7·sw)/8⌉`` k-steps are at most
    :data:`MXU_KSTEPS` (:data:`MXU_SPAN` at stride 1)."""
    if not 1 <= sw <= MXU_MAX_SW:
        raise ValueError(f"K2's single-channel path takes column strides "
                         f"up to {MXU_MAX_SW}, got {sw}")
    return 8 * MXU_KSTEPS - 7 * sw


def mxu_slack(sw: int = 1) -> int:
    """Zeroed words past K2's last buffer: what a ragged item's fragment
    loads reach past the source at column stride ``sw``
    (:data:`MXU_SLACK` at stride 1)."""
    return 24 * sw + 40
MXU_ENT_INTS = 8              # one entry's record in the table


@dataclasses.dataclass(frozen=True)
class MxuEntries:
    """A single-channel plan's taps as K2 walks them. ``entries``: per
    entry ``(dz, r, cmin, span, kk, boff, toff)``, in (dz, r, cmin) order:
    the footprint row, its first column and column span (at most
    :data:`MXU_SPAN`), its k-steps ``kk = ⌈(span + 7)/8⌉``, the offset of
    its B tiles (``kk`` tiles of 8 × 8 fp32, ``[k][n]``) and of its column
    table in ``table``. ``table``: the entry records (:data:`MXU_ENT_INTS`
    ints each), then per entry per column of its span the coefficient's
    index (the plan's immediates, or the flattened filter), ``-1`` where no
    tap sits. ``b_words``: the B tiles' fp32 words."""

    entries: tuple[tuple[int, ...], ...]
    table: tuple[int, ...]
    b_words: int


def _mxu_segments(rows, sw: int = 1) -> list:
    """The entries of a footprint: ``rows`` maps each tapped row ``(dz, r)``
    to its tapped columns; each row's sorted columns are cut, from the
    left, into runs whose span is at most :func:`mxu_span` (``sw`` the
    column stride). Returns ``(dz, r, columns)`` in (dz, r, column)
    order."""
    span = mxu_span(sw)
    out = []
    for dz, r in sorted(rows):
        cols = sorted(rows[(dz, r)])
        i = 0
        while i < len(cols):
            j = i
            while j + 1 < len(cols) and cols[j + 1] - cols[i] < span:
                j += 1
            out.append((dz, r, cols[i:j + 1]))
            i = j + 1
    return out


def _mxu_b_shape(plan: SystolicPlan) -> tuple[int, int]:
    """``(entries, B tile words)`` of a plan, from its tap positions."""
    rows: dict = {}
    for cum, tap in flat_taps(plan):
        dz = tap.z_offset if plan.ndim_spatial == 3 else 0
        rows.setdefault((dz, tap.row_offset), set()).add(cum)
    sw = plan.stride_per_axis()[-1]
    segs = _mxu_segments(rows, sw)
    return len(segs), sum(64 * -(-(c[-1] - c[0] + 1 + 7 * sw) // 8)
                          for _, _, c in segs)


@functools.lru_cache(maxsize=256)
def mxu_entries(plan: SystolicPlan, w_shape) -> MxuEntries:
    quads = mxu_tap_table(plan, w_shape)
    rows: dict = {}
    for i in range(0, len(quads), 4):
        dz, r, col, ci = quads[i:i + 4]
        cols = rows.setdefault((dz, r), {})
        if col in cols:
            raise ValueError(f"two taps of {plan.kind!r} read the cell "
                             f"({dz}, {r}, {col})")
        cols[col] = ci
    sw = plan.stride_per_axis()[-1]
    ents, tabs, boff = [], [], 0
    for dz, r, cols in _mxu_segments(rows, sw):
        cmin, span = cols[0], cols[-1] - cols[0] + 1
        kk = -(-(span + 7 * sw) // 8)
        tab = [-1] * span
        for c in cols:
            tab[c - cmin] = rows[(dz, r)][c]
        ents.append((dz, r, cmin, span, kk, boff))
        tabs.append(tab)
        boff += 64 * kk
    head, tail, out = [], [], []
    for (dz, r, cmin, span, kk, bo), tab in zip(ents, tabs):
        toff = MXU_ENT_INTS * len(ents) + len(tail)
        head += [dz, r, cmin, span, kk, bo, toff, 0]
        out.append((dz, r, cmin, span, kk, bo, toff))
        tail += tab
    return MxuEntries(tuple(out), tuple(head + tail), boff)


def mxu_btiles(ents: MxuEntries, cvals: torch.Tensor,
               sw: int = 1) -> torch.Tensor:
    """The Toeplitz B tiles K2 builds in shared memory at a block's start:
    ``b_words`` fp32 words, entry ``e``'s k-step ``s`` at ``boff + 64·s``,
    ``B_s[k][n] = c(cmin + 8s + k − sw·n)`` (0 where no tap sits; ``sw``
    the output column stride: a steeper band)."""
    bt = torch.zeros(ents.b_words, dtype=torch.float32)
    s = torch.arange(MXU_KSTEPS * 64)
    qq = 8 * (s // 64) + (s // 8) % 8 - sw * (s % 8)
    for _, _, _, span, kk, boff, toff in ents.entries:
        col = torch.tensor(ents.table[toff:toff + span] + (-1,))
        q = qq[:64 * kk]
        ci = col[torch.where((q >= 0) & (q < span), q, span)]
        bt[boff:boff + 64 * kk] = torch.where(
            ci >= 0, cvals.float()[ci.clamp(min=0)], 0.0)
    return bt


def mxu_pitch(width: int) -> int:
    """The row pitch, in words, of K2's fp32 iterate buffers: at least
    ``width`` and 4 mod 8, so that a fragment's 8 rows × 4 columns fall
    in 32 banks."""
    return (width + 4) // 8 * 8 + 4


@dataclasses.dataclass(frozen=True)
class MxuLayout:
    """K2's single-channel geometry for one call. Output tiles ``tile``
    ``(bz, bh, bw)`` (``tiles`` per axis: batch, z, y, x; x fastest),
    ``grid`` persistent blocks, block ``g`` taking tiles ``g, g + grid,
    …``. A tile's input, widened by the t footprints, is one TMA box along
    x (``box`` ``(z, y, x)``, x from the 16-byte aligned column at or below
    the first input column, its pitch 4 mod 8 words for fp32) and
    ``boxes`` ``(nbz, nby)`` along z and y. ``stages`` stages of
    ``stage_bytes`` make the ring; then ``bufs`` fp32 words (the widened
    bf16 stage at pitch ``pc``, the even and the odd iterates), the
    :data:`MXU_SLACK` words the over-reads reach, the B tiles, the entries
    and the barriers: ``smem`` bytes. ``geom`` is what the C entry
    takes."""

    tile: tuple[int, int, int]
    tiles: tuple[int, int, int, int]
    box: tuple[int, int, int]
    boxes: tuple[int, int]
    stage_bytes: int
    stages: int
    pc: int
    bufs: tuple[int, int, int]
    smem: int
    grid: int
    geom: tuple[int, ...]

    @property
    def ntiles(self) -> int:
        return self.tiles[0] * self.tiles[1] * self.tiles[2] * self.tiles[3]

    @property
    def staged(self) -> tuple[int, int]:
        """Staged (slices, rows): ``(sz, sy)``."""
        return (self.boxes[0] * self.box[0], self.boxes[1] * self.box[1])

    def tile_origin(self, tile: int) -> tuple[int, int, int, int]:
        """``(b, oz0, oy0, ox0)`` of tile number ``tile``."""
        _, tz, ty, tx = self.tiles
        b, r = divmod(tile, tz * ty * tx)
        iz, r = divmod(r, ty * tx)
        iy, ix = divmod(r, tx)
        bz, bh, bw = self.tile
        return b, iz * bz, iy * bh, ix * bw


def _mxu_smem(plan: SystolicPlan, tile, t: int, elem_bytes: int,
              stages: int):
    """``(box, boxes, stage_bytes, pc, bufs, smem)`` of a K2 single-channel
    block at a ring of ``stages`` (``box[2]`` above :data:`TMA_MAX_BOX`
    where a tile's input row is wider than one TMA box)."""
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, M = plan.N, plan.M
    bz, bh, bw = tile
    sh, sw = plan.stride_per_axis()[-2:]
    es = elem_bytes
    per = TMA_ALIGN // es
    zs, hs = bz + t * (D - 1), sh * (bh - 1) + 1 + t * (N - 1)
    box_x = _round_up(sw * (bw - 1) + 1 + t * (M - 1) + per - 1, per)
    if es == 4 and box_x % 8 != 4:
        box_x += 4                      # fp32 rows at a pitch 4 mod 8
    row = box_x * es
    nby = -(-hs // TMA_MAX_BOX)
    box_y = -(-hs // nby)
    if nby > 1:
        box_y = _round_up(box_y, 128 // math.gcd(128, row))
    if nby > 1 and zs > 1:      # a box per slice: y-boxes stack in a slice
        nbz, box_z = zs, 1
    else:
        nbz = -(-zs // TMA_MAX_BOX)
        box_z = -(-zs // nbz)
        if nbz > 1:
            box_z = _round_up(box_z, 128 // math.gcd(128, nby * box_y * row))
    sz, sy = nbz * box_z, nby * box_y
    stage_bytes = _round_up(sz * sy * box_x * es, 128)
    pc = box_x + 4 if es == 2 else 0    # bf16 box_x is a multiple of 8
    c0 = _round_up(sz * sy * pc, 4)

    def iterate(k):             # words of application k's result
        j = t - 1 - k
        return ((bz + j * (D - 1)) * (bh + j * (N - 1))
                * mxu_pitch(bw + j * (M - 1)))

    even = max((iterate(k) for k in range(0, t - 1, 2)), default=0)
    odd = max((iterate(k) for k in range(1, t - 1, 2)), default=0)
    bufs = (c0, _round_up(even, 4), _round_up(odd, 4))
    nent, b_words = _mxu_b_shape(plan)
    smem = (128 + stages * stage_bytes
            + 4 * (sum(bufs) + mxu_slack(sw) + b_words) + 32 * nent
            + 8 * stages)
    return ((box_z, box_y, box_x), (nbz, nby), stage_bytes, pc, bufs,
            _round_up(smem, 16))


def mxu_layout(plan: SystolicPlan, head, tile, t: int, elem_bytes: int,
               pitch: int, ents: MxuEntries, oaddr=None) -> MxuLayout:
    """K2's single-channel layout for a call of :func:`_tile_launch`'s
    ``head`` and ``tile``, storing through the output step ``oaddr``
    (``(o_row, o_col, o_plane, o_img)``; default the dense output). The
    ring takes the most stages (up to 3) that leave two blocks an SM;
    failing that, the most that fit one block; failing that, the call
    raises."""
    batch, zin, hin, win, zo, ho, wo, lz, ly, lx = head
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    tile = tuple(tile)
    fits = [(s, _mxu_smem(plan, tile, t, elem_bytes, s))
            for s in range(MXU_MAX_STAGES, 0, -1)]
    pick = next(((s, f) for s, f in fits if f[5] <= WINDOW_SMEM_TARGET),
                None) or next(((s, f) for s, f in fits
                               if f[5] <= SMEM_LIMIT), None)
    if pick is None:
        raise ValueError(
            f"block {tile[3 - nd:]} needs {fits[-1][1][5]} bytes of shared "
            f"memory (limit {SMEM_LIMIT}); pass a smaller block")
    stages, (box, boxes, stage_bytes, pc, bufs, smem) = pick
    if box[2] > TMA_MAX_BOX:
        raise ValueError(f"block {tile[3 - nd:]}: a tile's input row is "
                         f"wider than one TMA box ({TMA_MAX_BOX}); pass a "
                         "narrower block")
    bz, bh, bw = tile
    tiles = (batch, -(-zo // bz), -(-ho // bh), -(-wo // bw))
    ntiles = tiles[0] * tiles[1] * tiles[2] * tiles[3]
    if ntiles >= 2 ** 31:
        raise ValueError(f"K2's tile walk cannot count {ntiles} tiles")
    bps = max(1, min(2, H100_SM_SMEM // (smem + 1024)))
    grid = min(ntiles, bps * H100_SMS)
    geom = (nd, D, plan.N, plan.M, t, len(ents.entries), batch, zin, hin,
            win, pitch, zo, ho, wo, lz, ly, lx, bz, bh, bw, box[2], box[1],
            box[0], boxes[1], boxes[0], stages, stage_bytes, pc, *bufs,
            ents.b_words, len(ents.table), smem, grid,
            mxu_slack(plan.stride_per_axis()[-1]),
            max(e[4] for e in ents.entries), *plan.stride_per_axis()[-2:],
            *(oaddr or _dense_oaddr(head)))
    return MxuLayout(tile, tiles, box, boxes, stage_bytes, stages, pc, bufs,
                     smem, grid, geom)


def mxu_smem_bytes(plan: SystolicPlan, block, time_steps: int) -> int:
    """Dynamic shared memory of one fp32 single-channel K2 block with one
    ring stage (layout of ``ssam_mxu.cu``, :func:`mxu_layout`), B tiles
    included."""
    tile = (1,) * (3 - plan.ndim_spatial) + tuple(block)
    return _mxu_smem(plan, tile, time_steps, 4, 1)[5]


def _mxu_block(plan: SystolicPlan, t: int) -> tuple[int, ...]:
    """K2's default output tile: 64 × 128 (2-D) or 8 × 16 × 64 (3-D), cut
    at t > 1 (by at most half) so that the first application's rows and
    columns fill whole warp items (16 rows, 32 columns); slices, then
    rows, then columns (or
    the columns first where a tile's input row is wider than one TMA box)
    halved until a block takes at most half of the shared memory, two
    blocks an SM."""
    base = [8, 16, 64] if plan.ndim_spatial == 3 else [64, 128]
    grow = ((t - 1) * (plan.N - 1), (t - 1) * (plan.M - 1))
    while True:
        block = list(base)
        for a, (unit, g) in enumerate(zip((MXU_ROWS, 8 * MXU_CHUNKS), grow)):
            i = len(block) - 2 + a
            cut = (block[i] + g) // unit * unit - g
            block[i] = cut if 2 * cut >= block[i] else block[i]
        tile = (1,) * (3 - len(block)) + tuple(block)
        box, *_, smem = _mxu_smem(plan, tile, t, 4, 1)
        wide = box[2] > TMA_MAX_BOX
        if not wide and smem <= SMEM_LIMIT // 2:
            return tuple(block)
        i = next((a for a in range(len(base) - 1) if base[a] > 1),
                 len(base) - 1)
        if wide:
            i = len(base) - 1
        if base[i] == 1:
            return tuple(block)
        base[i] //= 2


def _tf32_split(a: torch.Tensor):
    """3xTF32's truncating split as K2 does it: ``big`` = ``a`` with the 13
    low mantissa bits cleared, ``small = a − big`` as the tensor core
    reads it (its own top 19 bits)."""
    def trunc(v):
        return (v.view(torch.int32) & -8192).view(torch.float32)
    big = trunc(a)
    return big, trunc(a - big)


def _emulate_mxu_apply(mem: torch.Tensor, src, out_ext, ents: MxuEntries,
                       btile: torch.Tensor, plan: SystolicPlan
                       ) -> torch.Tensor:
    """One application of ``ssam_mxu.cu::apply_mx`` on the emulated shared
    memory ``mem`` (flat fp32 words) through ``src (base, pitch, plane,
    shift)``: the warp items (16 rows, rows past the last clamped, × 4
    chunks of 8 columns, per slice), each entry's shifted-row A (its k-step
    windows read in place: output row ``y`` reads row ``sh·y + r``, chunk
    ``c`` its window from column ``sw·8c``) split and multiplied with its
    Toeplitz tiles (big·big summed over whole entries of at least
    :data:`MXU_FLUSH` k-steps, then added to the fp32 sum; the cross terms
    beside). Returns the dense fp32 ``out_ext`` ``(zd, hd, wd)``
    result."""
    base, pitch, plane, shift = src
    zd, hd, wd = out_ext
    sh, sw = plan.stride_per_axis()[-2:]
    hp = _round_up(hd, MXU_ROWS)
    nch = _round_up(wd, 8 * MXU_CHUNKS) // 8
    y = torch.arange(hp).clamp(max=hd - 1)
    acc = torch.zeros((zd, hp, nch, 8))
    cor = torch.zeros((zd, hp, nch, 8))
    hi = torch.zeros((zd, hp, nch, 8))
    pend = 0
    for e, (dz, r, cmin, _, kk, boff, _) in enumerate(ents.entries):
        addr = (base + (torch.arange(zd)[:, None, None, None] + dz) * plane
                + (sh * y[None, :, None, None] + r) * pitch
                + sw * 8 * torch.arange(nch)[None, None, :, None] + cmin
                + shift + torch.arange(8 * kk))
        assert int(addr.min()) >= 0 and int(addr.max()) < mem.numel(), \
            "a fragment load leaves shared memory"
        ab, as_ = _tf32_split(mem[addr])
        bb, bs = _tf32_split(btile[boff:boff + 64 * kk].view(8 * kk, 8))
        hi = hi + ab @ bb
        cor = cor + (as_ @ bb + ab @ bs)
        pend += kk
        if pend >= MXU_FLUSH or e == len(ents.entries) - 1:
            acc, hi, pend = acc + hi, torch.zeros_like(hi), 0
    return (acc + cor).reshape(zd, hp, nch * 8)[:, :hd, :wd]


def emulate_mxu_kernel(x: torch.Tensor, w=None, *, plan: SystolicPlan,
                       block=None, time_steps: int = 1,
                       epilogue_args=()) -> torch.Tensor:
    """K2's single-channel schedule walked in plain torch on the CPU: the
    spec of ``csrc/ssam_mxu.cu`` that the CPU tests hold to the plain
    version. The wrapper's operand (a pitch-padded copy where x's rows are
    not a multiple of 16 bytes), :func:`mxu_entries` and the Toeplitz tiles
    (:func:`mxu_btiles`), :func:`mxu_layout`, the persistent walk (block
    ``g`` takes tiles ``g, g + grid, …``; a stage is waited for by the
    tile it was filled with), each stage's TMA boxes (:func:`_tma_box`),
    one block's shared memory zeroed at its start and reused by its tiles
    (a bf16 stage widened into its fp32 buffer), the t applications
    (:func:`_emulate_mxu_apply`: the stage, then the fp32 iterates in two
    ping-pong buffers at :func:`mxu_pitch`) and the last one stored
    through the epilogue (:func:`_tile_epilogue`). Returns ``x``'s shape
    and dtype."""
    check_supported(plan, time_steps, "shift_psum")
    _check_operands(plan, x, w, epilogue_args, time_steps)
    if _is_reduce(plan) or plan.coeff_mode == "perlane" \
            or plan.strategy != "mxu":
        raise ValueError("the emulation walks K2's single-channel path")
    block = tuple(block or default_block(plan, time_steps))
    t, nd = time_steps, plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, M = plan.N, plan.M
    ents = mxu_entries(plan, None if w is None else tuple(w.shape))
    cvals = (torch.tensor(plan.coeffs, dtype=torch.float32)
             if plan.coeff_mode == "table"
             else w.detach().to(torch.float32).flatten())
    sh, sw = plan.stride_per_axis()[-2:]
    btile = mxu_btiles(ents, cvals, sw)
    xc, out, _, head, tile = _tile_launch(plan, x, block, t)
    xt, pitch = _tma_operand(xc)
    batch, zin, hin, win, zo, ho, wo, lz, ly, lx = head
    es = x.element_size()
    lay = mxu_layout(plan, head, tile, t, es, pitch, ents)
    assert lay.smem <= SMEM_LIMIT
    xm = xt.reshape(batch, zin, hin, pitch)
    out4 = out.reshape(batch, zo, ho, wo)
    resid = next((a.reshape(batch, zo, ho, wo) for st, a in zip(
        epilogue_operand_stages(plan.epilogue), epilogue_args)
        if st.op == "residual_add"), None)
    (box_z, box_y, box_x), (nbz, nby) = lay.box, lay.boxes
    sz, sy = lay.staged
    c0, even, odd = lay.bufs
    ring = lay.stages * lay.stage_bytes // 4
    offs = (ring, ring + c0, ring + c0 + even)      # c0, even, odd buffers
    words = offs[2] + odd + mxu_slack(sw)
    done = torch.zeros(lay.ntiles, dtype=torch.int64)
    for g in range(lay.grid):
        mem = torch.zeros(words)                    # zeroed at block start
        mine = list(range(g, lay.ntiles, lay.grid))
        held = mine[:lay.stages] + [None] * (lay.stages - len(mine))
        for i, tile_no in enumerate(mine):
            s = i % lay.stages
            assert held[s] == tile_no, "a stage holds another tile"
            b, oz0, oy0, ox0 = lay.tile_origin(tile_no)
            x0, shift = staged_row_start(sw * ox0 - lx, es)
            stage = torch.zeros(sz * sy * box_x)
            for jz in range(nbz):
                for jy in range(nby):
                    box = _tma_box(xm, win, b, (oz0 - lz + jz * box_z,
                                                sh * oy0 - ly + jy * box_y,
                                                x0),
                                   lay.box)
                    off = (jz * box_z * sy + jy * box_y) * box_x
                    assert (off * es) % 128 == 0, "a box lands unaligned"
                    stage[off:off + box.numel()] = box.flatten().float()
            if es == 4:
                sbase = s * lay.stage_bytes // 4
                mem[sbase:sbase + stage.numel()] = stage
                src = (sbase, box_x, sy * box_x, shift)
            else:                                   # widened at pitch pc
                rows = mem[offs[0]:offs[0] + sz * sy * lay.pc]
                rows.view(sz * sy, lay.pc)[:, :box_x] = stage.view(-1, box_x)
                src = (offs[0], lay.pc, sy * lay.pc, shift)
            nxt = i + lay.stages                    # the stage is read
            held[s] = mine[nxt] if nxt < len(mine) else None
            tz, ty, tx = (min(a, n - o) for a, n, o in
                          zip(lay.tile, (zo, ho, wo), (oz0, oy0, ox0)))
            ext = (tz + t * (D - 1), ty + t * (N - 1), tx + t * (M - 1))
            for k in range(t):
                res = _emulate_mxu_apply(
                    mem, src, (tz, ty, tx) if sh * sw > 1 else
                    (ext[0] - (D - 1), ext[1] - (N - 1), ext[2] - (M - 1)),
                    ents, btile, plan)
                ext = tuple(res.shape)
                if k < t - 1:
                    zd, hd, wd = ext
                    dp = mxu_pitch(wd)
                    base = offs[1 + (k & 1)]
                    assert zd * hd * dp <= lay.bufs[1 + (k & 1)]
                    mem[base:base + zd * hd * dp].view(zd, hd, dp)[
                        ..., :wd] = res
                    src = (base, dp, hd * dp, 0)
            assert ext == (tz, ty, tx)
            out4[b, oz0:oz0 + tz, oy0:oy0 + ty, ox0:ox0 + tx] = \
                _tile_epilogue(plan, res, epilogue_args, resid, b,
                               (oz0, oy0, ox0))
            done[tile_no] += 1
    assert bool((done == 1).all()), "a tile is not walked exactly once"
    return out


# K2's channel-reduce path (csrc/ssam_mxu_tc.cu): an implicit GEMM on the
# tensor cores, M = output positions, N = C_out, K = C_in·taps in k-blocks
# of 32 input channels of one tap. A block of two warpgroups owns 128
# positions (64 each) x 128 channels; the filter tiles and x's staged rows
# come by TMA.
MXU_TC_POS = 128                # positions of a block (2 x wgmma M)
MXU_TC_CO = 128                 # channels of a block (wgmma N)
MXU_TC_KB = 32                  # a k-block: 32 input channels of one tap
MXU_TC_ROW_BYTES = 128          # bytes of a filter row of one k-block
MXU_TC_STAGES = ((4, 2), (3, 2), (4, 1), (2, 2), (3, 1), (2, 1))
MXU_TC_PHASE_INTS = 8           # one phase's header in the table
MXU_TC_MAX_CHUNKS = 256         # 16-byte chunks of a staged row (TMA box)


def gather_wavefronts(pitch: int, sw: int, elem_bytes: int) -> int:
    """Shared-memory wavefronts of one A-fragment load of K2's channel
    kernel: lane ``4g + t`` reads channel ``t`` (``pitch`` elements apart)
    at position ``g`` (``sw`` elements apart); the most distinct 4-byte
    words any of the 32 banks serves."""
    banks: dict[int, set] = {}
    for lane in range(WARP):
        g, t = divmod(lane, 4)
        word = (t * pitch + g * sw) * elem_bytes // 4
        banks.setdefault(word % 32, set()).add(word)
    return max(len(v) for v in banks.values())


@dataclasses.dataclass(frozen=True)
class MxuTcLayout:
    """K2's channel-path geometry. A block owns :data:`MXU_TC_POS` output
    columns of one output row of one phase × :data:`MXU_TC_CO` channels;
    the grid is (column tiles, rows, batch × C_out tiles × phases). K runs
    over ``slabs`` slabs of 32 input channels (zero past C_in) × a phase's
    taps, one k-block each, in the filter operand's columns ``kcols`` (indices into the flat filter
    ``(C_out, C_in·N·M)`` with one zero column appended at its end). Each
    x stage holds, for 32 channels, ``rows`` staged rows of ``row_len``
    elements starting at the 16-byte chunk at or below a tile's first
    column: the rows of all a phase's taps (one stage per slab), or
    (``x_per_kblock``) the row of one tap. ``table``: per phase ``(py, px,
    rows, cols, taps, dcmin, first k-block, tap data offset)``, then per
    tap ``(x row offset, offset in the stage)``."""

    co_tiles: int
    slabs: int
    row_len: int
    rows: int
    x_per_kblock: bool
    b_stages: int
    x_stages: int
    b_bytes: int
    x_bytes: int
    smem: int
    grid: tuple[int, int, int]
    table: tuple[int, ...]
    kcols: tuple[int, ...]


@functools.lru_cache(maxsize=64)
def mxu_tc_layout(phases, *, batch: int, c_in: int, c_out: int, fsz: int,
                  read_stride=(1, 1), elem_bytes: int = 4) -> MxuTcLayout:
    """K2's channel-path layout for ``phases`` (:class:`ReducePhase`). The
    rings take the deepest stages that fit in :data:`SMEM_LIMIT`, x staged
    a slab at a time (the rows of all a phase's taps) where that fits, else
    a k-block at a time (one tap's row). The row length is padded so that
    a fragment load meets the fewest bank conflicts
    (:func:`gather_wavefronts`)."""
    sw = read_stride[1]
    per = TMA_ALIGN // elem_bytes
    slabs = -(-c_in // MXU_TC_KB)
    live = [ph for ph in phases if ph.taps]
    rows_out = max(ph.extent[0] for ph in phases)
    cols_out = max(ph.extent[1] for ph in phases)
    span = max((max(t[1] for t in ph.taps) - min(t[1] for t in ph.taps)
                for ph in live), default=0)
    slab_rows = max((max(t[0] for t in ph.taps) - min(t[0] for t in ph.taps)
                     + 1 for ph in live), default=1)

    def row_len(rows):
        need = (MXU_TC_POS - 1) * sw + span + 1 + per - 1
        first = _round_up(need, per)
        return min(range(first, first + 32 * per, per),
                   key=lambda n: (gather_wavefronts(rows * n, sw,
                                                    elem_bytes), n))

    def fit(per_kblock):
        rows = 1 if per_kblock else slab_rows
        L = row_len(rows)
        x_bytes = _round_up(MXU_TC_KB * rows * L * elem_bytes, 1024)
        if L // per > MXU_TC_MAX_CHUNKS:
            return None
        for bs, xs in MXU_TC_STAGES:
            smem = (1024 + max((bs + 2) * b_bytes + xs * x_bytes, tile)
                    + 8 * (4 + 2))
            if smem <= SMEM_LIMIT:
                return per_kblock, L, rows, bs, xs, x_bytes, smem
        return None

    b_bytes = MXU_TC_CO * MXU_TC_ROW_BYTES
    # the flush stages the fp32 output tile (its channels 4 words mod 32
    # apart) where the rings were
    tile = 4 * MXU_TC_CO * (MXU_TC_POS + 4)
    best = fit(False) or fit(True)
    if best is None:
        raise ValueError(f"K2's channel path cannot stage the rows of "
                         f"{len(phases)} phase(s) at stride {read_stride} "
                         f"in {SMEM_LIMIT} bytes of shared memory")
    per_kblock, L, rows, bs, xs, x_bytes, smem = best
    co_tiles = -(-c_out // MXU_TC_CO)
    grid = (-(-cols_out // MXU_TC_POS), rows_out,
            batch * co_tiles * len(phases))
    if grid[1] > 65535 or grid[2] > 65535:
        raise ValueError(f"K2's reduce grid cannot hold {rows_out} rows or "
                         f"{batch} x {c_out} channels x {len(phases)} phases")
    head, data, kcols = [], [], []
    base = MXU_TC_PHASE_INTS * len(phases)
    zero = c_in * fsz                     # the appended zero column
    for ph in phases:
        dcmin = min((t[1] for t in ph.taps), default=0)
        drmin = min((t[0] for t in ph.taps), default=0)
        head += [*ph.offset, *ph.extent, len(ph.taps), dcmin,
                 len(kcols) // MXU_TC_KB, base + len(data)]
        for dr, dc, _ in ph.taps:
            if per_kblock:
                data += [dr, dc - dcmin]
            else:
                data += [drmin, (dr - drmin) * L + dc - dcmin]
        for s in range(slabs):
            for _, _, coeff in ph.taps:
                kcols += [coeff + c * fsz if c < c_in else zero
                          for c in range(s * MXU_TC_KB, (s + 1) * MXU_TC_KB)]
    return MxuTcLayout(co_tiles, slabs, L, rows, per_kblock, bs, xs, b_bytes, x_bytes, smem, grid,
                       tuple(head + data), tuple(kcols))


class MxuKernel:
    """Wrapper of K2. Channel (NCHW) plans launch the tensor-core kernel
    of ``csrc/ssam_mxu_tc.cu`` (``ssam_mxu_tc_launch``), single-channel
    plans ``csrc/ssam_mxu.cu`` (``ssam_mxu_window_launch``), per-lane
    plans ``csrc/ssam_mxu_perlane.cu`` (``ssam_mxu_perlane_launch``).
    ``launches`` counts the kernel launches it made: one per call on any
    path, a
    fused epilogue or residual included; a strided reduce plan's input
    adjoint (:meth:`adjoint_phases`) is one launch for all its phases, a
    strided single-channel plan's one launch a phase that a tap
    reaches."""

    name = "ssam_mxu"
    source = "src/repro_torch/csrc/ssam_mxu_tc.cu"
    single_channel_source = "src/repro_torch/csrc/ssam_mxu.cu"
    perlane_source = "src/repro_torch/csrc/ssam_mxu_perlane.cu"
    perlane_replaces = ("src/repro/core/engine.py:253 (_apply_plan_mxu's "
                        "per-lane branch, pallas_call at 587)")
    replaces = ("src/repro/core/engine.py:189 (_apply_plan_mxu, "
                "strategy='mxu' at pallas_call 587)")

    def __init__(self, library: _build.Library):
        self.library = library
        self.launches = 0

    def __call__(self, x: torch.Tensor, w, *, plan: SystolicPlan, block,
                 time_steps: int, epilogue_args=()) -> torch.Tensor:
        _check_kernel_operands("K2", x, w, plan)
        if plan.strategy != "mxu":
            raise ValueError(f"K2 runs mxu plans, got strategy="
                             f"{plan.strategy!r}")
        if _is_reduce(plan):
            return self._reduce(x, w, plan, epilogue_args)
        if plan.coeff_mode == "perlane":
            return self._perlane(x, w, plan, epilogue_args)
        return self._single(x, w, plan, block, time_steps, None,
                            epilogue_args)

    def _perlane(self, x, w, plan, epilogue_args):
        """The per-lane (depthwise) path: ``x (…, T, D)`` against ``w (K,
        D)``, each lane's taps a Toeplitz band on the tensor cores, 128
        outputs an ``mma.sync`` tile, persistent blocks on a ring of two
        stages, the epilogue at the store (``ssam_mxu_perlane.cu``,
        :func:`mxu_perlane_layout`)."""
        rows = perlane_row_table(plan)
        nb = plan.batch_axes
        x = x.contiguous()
        batch = 1
        for d in x.shape[:nb]:
            batch *= d
        T, D = x.shape[nb:]
        To = plan.out_shape((T, D))[0]
        lay = mxu_perlane_layout(plan, batch, T, D, x.element_size())
        (lead, _), _ = plan.lead_trail()
        wf = w.detach().to(torch.float32).contiguous()
        epi = _epilogue_codes(plan, epilogue_args, x.device, x.dtype)
        out = torch.empty(tuple(x.shape[:nb]) + (To, D), dtype=x.dtype,
                          device=x.device)
        err = self.library.get().ssam_mxu_perlane_launch(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            wf.data_ptr(), (ctypes.c_int * PERLANE_MAX_ROWS)(*rows),
            plan.N, *epi.args(), batch, T, D, To, lead, lay.blocks,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K2 launch failed: CUDA error {err} "
                               f"({plan.kind}, per-lane {tuple(x.shape)})")
        self.launches += 1
        return out

    def _single(self, x, w, plan, block, t, _variant, epilogue_args, *,
                out=None, out_sp=None, offset=0, oaddr=None):
        """The single-channel path (``ssam_mxu.cu``): one launch, strided
        or not, the epilogue at the store; ``out``, ``out_sp``, ``offset``
        and ``oaddr`` as :meth:`WindowKernel._single` takes them."""
        ents = mxu_entries(plan, None if w is None else tuple(w.shape))
        table = _device_ints(ents.table, x.device)
        if plan.coeff_mode == "dense":
            cvals = w.detach().to(torch.float32).contiguous()
        else:
            cvals = _device_floats(plan.coeffs, x.device)
        x, fresh, B, head, tile = _tile_launch(plan, x, block, t, out_sp)
        out = fresh if out is None else out
        xt, pitch = _tma_operand(x)
        lay = mxu_layout(plan, head, tile, t, x.element_size(), pitch, ents,
                         oaddr)
        epi = _epilogue_codes(plan, epilogue_args, x.device, x.dtype)
        err = self.library.get().ssam_mxu_window_launch(
            xt.data_ptr(), out.data_ptr() + offset * x.element_size(),
            int(x.dtype == torch.bfloat16), cvals.data_ptr(),
            table.data_ptr(), (ctypes.c_int * len(lay.geom))(*lay.geom),
            len(lay.geom), *epi.args(),
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K2 launch failed: CUDA error {err} "
                               f"({plan.kind}, block {B}, t={t})")
        self.launches += 1
        return out

    def _reduce(self, x, w, plan, epilogue_args):
        """The channel-reduce path: the implicit GEMM of the im2row operand
        of ``x (B, C_in, H, W)`` against ``w (C_out, C_in, N, M)``, output
        stride and epilogue, one phase."""
        x4 = x if plan.batch_axes else x[None]
        phase = forward_phase(plan, tuple(x4.shape[2:]))
        out = self._launch_phases(x4, w, plan, (phase,),
                                  plan.stride_per_axis(), (1, 1),
                                  phase.extent, epilogue_args)
        return out if plan.batch_axes else out[0]

    def adjoint_phases(self, g, wa, *, plan: SystolicPlan, in_spatial):
        """``dx`` of a strided plan: for a reduce plan one launch, every
        output phase of :func:`adjoint_reduce_phases` reading the
        cotangent ``g`` at stride 1 and writing its positions of ``dx``
        in place; for a single-channel plan one launch a phase
        (:func:`_phase_launches`)."""
        _check_kernel_operands("K2", g, wa, plan)
        if not _is_reduce(plan):
            return _phase_launches(self._single, g, wa, plan, in_spatial)
        g4 = g if plan.batch_axes else g[None]
        lin = dataclasses.replace(plan, epilogue=())
        phases = adjoint_reduce_phases(lin, in_spatial)
        out = self._launch_phases(g4, wa, lin, phases, (1, 1),
                                  plan.stride_per_axis(), tuple(in_spatial),
                                  ())
        return out if plan.batch_axes else out[0]

    def _launch_phases(self, x4, w, plan, phases, read_stride, out_stride,
                       out_spatial, epilogue_args):
        """Launch ``ssam_mxu_tc.cu`` on ``x4 (B, C_r, H, W)`` and ``w (C_o,
        C_r, N, M)``: x's rows in 16-byte chunks (:func:`_tma_operand`),
        the filter gathered into its k-blocks (:attr:`MxuTcLayout.kcols`),
        the layout of :func:`mxu_tc_layout`."""
        Bn, Cr, H, W = x4.shape
        Co, fsz = w.shape[0], plan.N * plan.M
        lay = mxu_tc_layout(tuple(phases), batch=Bn, c_in=Cr, c_out=Co,
                            fsz=fsz, read_stride=tuple(read_stride),
                            elem_bytes=x4.element_size())
        xs, pitch = _tma_operand(x4)
        wf = w.detach().to(torch.float32).reshape(Co, Cr * fsz)
        wb = F.pad(wf, (0, 1)).index_select(
            1, _device_ints(lay.kcols, x4.device))
        table = _device_ints(lay.table, x4.device)
        epi = _epilogue_codes(plan, epilogue_args, x4.device, x4.dtype)
        out = torch.empty((Bn, Co) + tuple(out_spatial), dtype=x4.dtype,
                          device=x4.device)
        err = self.library.get().ssam_mxu_tc_launch(
            xs.data_ptr(), out.data_ptr(), int(x4.dtype == torch.bfloat16),
            wb.data_ptr(), table.data_ptr(), *epi.args(), H, Cr, Bn, pitch, wb.shape[1], Co, *out_spatial, *read_stride,
            *out_stride, len(phases), lay.co_tiles, lay.slabs,
            lay.row_len, lay.rows, int(lay.x_per_kblock), lay.b_stages,
            lay.x_stages, lay.x_bytes, *lay.grid[:2], lay.smem,
            torch.cuda.current_stream(x4.device).cuda_stream)
        if err:
            raise RuntimeError(f"K2 launch failed: CUDA error {err} "
                               f"({plan.kind}, reduce {Cr} -> {Co}, "
                               f"{len(phases)} phase(s))")
        self.launches += 1
        return out


MXU_KERNEL = MxuKernel(_build.LIBRARY)


def run_window_plan(x: torch.Tensor, w=None, *, plan: SystolicPlan,
                    block=None, time_steps: int = 1,
                    variant: str = "shift_psum",
                    epilogue_args=(), strategy: str | None = None
                    ) -> torch.Tensor:
    """Run a windowed plan: K1 (K2 for an mxu plan) for a CUDA tensor,
    the plain version for a CPU tensor, an error for anything else.

    Args:
      x: ``batch_axes + reduce_axes + ndim_spatial``-dim input, lane axis
        last.
      w: the dense filter for ``coeff_mode='dense'`` plans — ``(N, M)``,
        or ``(C_out, C_in, N, M)`` for reduce plans — None for ``'table'``
        plans.
      block: output tile per windowed axis of the block walk (default
        :func:`default_block`).
      time_steps: fused applications (§6.4), pad-once semantics.
      variant: ``'shift_psum'`` (paper) or ``'shift_data'``; moot for an
        mxu plan.
      epilogue_args: runtime operands of the plan's epilogue: a bias (a
        per-C_out row for reduce plans, per lane for per-lane plans, else
        a scalar) and an output-shaped residual.
      strategy: pin the lowering for this call, ``'lanes'`` (K1) or
        ``'mxu'`` (K2, the im2row contraction on the tensor cores); None
        keeps whatever the plan carries. An mxu plan that K2 cannot run
        raises; it never retreats to K1.
    """
    if strategy is not None:
        plan = dataclasses.replace(plan, strategy=strategy)
    check_supported(plan, time_steps, variant)
    _check_operands(plan, x, w, epilogue_args, time_steps)
    block = tuple(block or default_block(plan, time_steps))
    if x.device.type == "cuda":
        if plan.strategy == "mxu":
            return MXU_KERNEL(x, w, plan=plan, block=block,
                              time_steps=time_steps,
                              epilogue_args=epilogue_args)
        return WINDOW_KERNEL(x, w, plan=plan, block=block,
                             time_steps=time_steps, variant=variant,
                             epilogue_args=epilogue_args)
    if x.device.type == "cpu":
        return run_window_plan_reference(x, w, plan=plan, block=block,
                                         time_steps=time_steps,
                                         variant=variant,
                                         epilogue_args=epilogue_args)
    raise ValueError(f"no windowed engine for device {x.device}")


def run_window_plan_mxu(x: torch.Tensor, w=None, *, plan: SystolicPlan,
                        **kw) -> torch.Tensor:
    """:func:`run_window_plan` with the tap-set contraction pinned to the
    im2row lowering (K2 on the card): equivalent to ``strategy='mxu'``
    on the plan. Same signature, same output to fp32 tolerance as the
    lanes schedule."""
    return run_window_plan(
        x, w, plan=dataclasses.replace(plan, strategy="mxu"), **kw)


def _check_adjoint_phase_operands(g, wa, plan: SystolicPlan, in_spatial):
    """``g`` and ``wa`` of a strided plan's input adjoint (a dense 2-D
    plan, NCHW or single-channel), checked against the plan and the
    input's spatial shape."""
    if plan.ndim_spatial != 2 or plan.coeff_mode != "dense" \
            or plan.reduce_axes != plan.out_axes:
        raise ValueError(f"{plan.kind!r}: the phased input adjoint takes "
                         "dense 2-D plans, NCHW or single-channel")
    nb, reduce = plan.batch_axes, _is_reduce(plan)
    want = plan.out_shape(tuple(in_spatial))
    fits = (wa.ndim == 4 and g.ndim == nb + 3 and wa.shape[1] == g.shape[nb]
            if reduce else wa.ndim == 2 and g.ndim == nb + 2)
    if not fits or tuple(g.shape[-2:]) != want \
            or tuple(wa.shape[-2:]) != plan.exts:
        raise ValueError(
            f"cotangent {tuple(g.shape)} and adjoint filter "
            f"{tuple(wa.shape)} do not fit the {plan.kind!r} plan on a "
            f"{tuple(in_spatial)} input (cotangent spatial {want})")


def _phase_plan_on(ph, g_spatial, in_spatial) -> SystolicPlan:
    """An adjoint phase's stride-1 plan with the trail that makes its
    output cover the phase's extent of ``dx`` (the plain version and the
    kernels crop it to that extent)."""
    p = ph.plan
    hq, wq = ph.extent(in_spatial)
    (lr, lc), _ = p.lead_trail()
    Ho, Wo = g_spatial
    trail = (max(0, hq - (Ho + lr - p.N + 1)),
             max(0, wq - (Wo + lc - p.M + 1)))
    return dataclasses.replace(p, trail=trail if any(trail) else None)


def run_adjoint_phases_reference(g: torch.Tensor, wa: torch.Tensor, *,
                                 plan: SystolicPlan,
                                 in_spatial) -> torch.Tensor:
    """The plain version of K1's and K2's phased input adjoint: ``dx`` of
    the strided plan ``plan`` (its linear part; NCHW or single-channel)
    on an input of spatial shape ``in_spatial``, given the cotangent
    ``g`` of the strided output and ``wa = adjoint_coeff_array(plan,
    w)``. Each phase of :func:`adjoint.strided_input_adjoint_phases`
    runs as its stride-1 plan through :func:`run_window_plan_reference`
    and is written to ``dx[..., py::sh, px::sw]``; phases no tap reaches
    stay zero."""
    _check_adjoint_phase_operands(g, wa, plan, in_spatial)
    sh, sw = plan.stride_per_axis()
    lead = (tuple(g.shape[:-3]) + (wa.shape[0],) if _is_reduce(plan)
            else tuple(g.shape[:-2]))
    dx = g.new_zeros(lead + tuple(in_spatial), dtype=acc_dtype(g))
    for ph in adjoint.strided_input_adjoint_phases(plan):
        hq, wq = ph.extent(in_spatial)
        if ph.plan is None or not hq or not wq:
            continue
        p = _phase_plan_on(ph, tuple(g.shape[-2:]), in_spatial)
        y = run_window_plan_reference(g, ph.filter(wa), plan=p)
        py, px = ph.offset
        dx[..., py::sh, px::sw] = y[..., :hq, :wq]
    return dx.to(g.dtype)


def run_adjoint_phases(g: torch.Tensor, wa: torch.Tensor, *,
                       plan: SystolicPlan, in_spatial) -> torch.Tensor:
    """``dx`` of a strided reduce plan, phase by phase, without scattering
    the cotangent: for a CUDA tensor one launch of K2 for an mxu plan
    (:meth:`MxuKernel.adjoint_phases`), else of K1
    (:meth:`WindowKernel.adjoint_phases`); for a CPU tensor
    :func:`run_adjoint_phases_reference`, whose phase plans keep the
    plan's strategy (an mxu plan runs the plain version of K2)."""
    _check_adjoint_phase_operands(g, wa, plan, in_spatial)
    if g.device.type == "cuda":
        kernel = MXU_KERNEL if plan.strategy == "mxu" else WINDOW_KERNEL
        return kernel.adjoint_phases(g, wa, plan=plan, in_spatial=in_spatial)
    if g.device.type == "cpu":
        return run_adjoint_phases_reference(g, wa, plan=plan,
                                            in_spatial=in_spatial)
    raise ValueError(f"no windowed engine for device {g.device}")


# ---------------------------------------------------------------------------
# Backward-weight: the adjoint correlation (K3)
# ---------------------------------------------------------------------------

def _wgrad_operands(x, g, plan: SystolicPlan):
    """``x`` and ``g`` as ``(B, C_in, H, W)`` and ``(B, C_out, H', W')``,
    checked against the plan's geometry as the reference checks them. A
    strided plan takes the cotangent the forward produced (the strided
    output's shape); the stride-free plan takes one scattered onto the
    dense lattice, with the same result."""
    if plan.combine != "fma" or plan.coeff_mode == "table":
        raise ValueError(
            f"no weight gradient for {plan.kind!r} "
            f"(combine={plan.combine!r}, coeff_mode={plan.coeff_mode!r})")
    if plan.coeff_mode != "dense":
        raise ValueError(f"{plan.kind!r}: the dense weight gradient takes "
                         "dense plans; per-lane plans run through K4")
    if plan.ndim_spatial != 2 or plan.reduce_axes != plan.out_axes:
        raise ValueError(f"{plan.kind!r}: the dense weight gradient takes "
                         "2-D plans, single-channel or NCHW")
    nb, nr = plan.batch_axes, plan.reduce_axes
    x4 = x if nb else x[None]
    x4 = x4 if nr else x4[:, None]
    g4 = g if nb else g[None]
    g4 = g4 if nr else g4[:, None]
    if x4.ndim != 4 or g4.ndim != 4 or x4.shape[0] != g4.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} do not "
                         f"fit the {plan.kind!r} plan")
    if tuple(g4.shape[2:]) != plan.out_shape(tuple(x4.shape[2:])):
        raise ValueError(f"cotangent {tuple(g.shape)} is not the output of "
                         f"the {plan.kind!r} plan on {tuple(x.shape)}")
    return x4, g4


def _wgrad_perlane_operands(x, g, plan: SystolicPlan):
    """``x`` and ``g`` of a per-lane plan as ``(B, T, D)`` and ``(B, Tg,
    D)`` (leading batch axes flattened), checked as the reference checks
    them: ``Tg = T + lead + trail − (K − 1)``. The gradient's row ``k``
    pairs with footprint row ``k``, as in the depthwise builder."""
    if plan.combine != "fma" or plan.ndim_spatial != 2 or plan.M != 1:
        raise ValueError(f"{plan.kind!r} is not a per-lane windowed plan")
    if any(t.coeff_id[-1] != t.row_offset for st in plan.steps
           for t in st.taps):
        raise ValueError(f"{plan.kind!r}: the per-lane weight gradient takes "
                         "the forward plan (tap k on footprint row k)")
    nb = plan.batch_axes
    if x.ndim != nb + 2 or g.ndim != nb + 2 or x.shape[:nb] != g.shape[:nb] \
            or x.shape[-1] != g.shape[-1]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} do not "
                         f"fit the {plan.kind!r} plan")
    x3 = x.reshape((-1,) + tuple(x.shape[nb:]))
    g3 = g.reshape((-1,) + tuple(g.shape[nb:]))
    (lead, _), (trail, _) = plan.lead_trail()
    if g3.shape[1] != x3.shape[1] + lead + trail - (plan.N - 1):
        raise ValueError(f"cotangent {tuple(g.shape)} is not the output of "
                         f"the {plan.kind!r} plan on {tuple(x.shape)}")
    return x3, g3


def _wgrad_perlane_reference(x, g, plan: SystolicPlan) -> torch.Tensor:
    """The plain version of K4: ``dW[k, d] = Σ_{b,t} g[b,t,d]·xp[b,t+k,d]``,
    ``xp`` the input padded by the plan's lead and trail; ``(K, D)``."""
    x3, g3 = _wgrad_perlane_operands(x, g, plan)
    acc = acc_dtype(x)
    K = plan.N
    (lead, _), (trail, _) = plan.lead_trail()
    Tg = g3.shape[1]
    xp = F.pad(x3.to(acc), (0, 0, lead, trail))
    gf = g3.to(acc)
    return torch.stack([(gf * xp[:, k:k + Tg]).sum(dim=(0, 1))
                        for k in range(K)])


def run_weight_grad_plan_reference(x: torch.Tensor, g: torch.Tensor, *,
                                   plan: SystolicPlan) -> torch.Tensor:
    """The plain version of K3 and K4, on any device: one correlation per
    filter tap, ``dW[:, :, n, m] = Σ_{b,o} g[b, :, o]·xp[b, :, s·o + (n,
    m)]`` over the input padded by the plan's lead (and trail), ``s`` the
    plan's output stride (``g`` the strided output's cotangent); per-lane
    plans ``dW[k, d] = Σ_{b,t} g[b,t,d]·xp[b,t+k,d]``. Returns fp32 (fp64
    for fp64 inputs), ``(N, M)``, ``(C_out, C_in, N, M)`` or ``(K, D)``."""
    if plan.coeff_mode == "perlane":
        return _wgrad_perlane_reference(x, g, plan)
    x4, g4 = _wgrad_operands(x, g, plan)
    acc = acc_dtype(x)
    N, M = plan.exts
    (ly, lx), _ = plan.lead_trail()
    sy, sx = plan.stride_per_axis()
    H, W = x4.shape[2:]
    Ho, Wo = g4.shape[2:]
    Hd, Wd = sy * (Ho - 1) + 1, sx * (Wo - 1) + 1   # the rows/columns read
    xp = F.pad(x4.to(acc), (lx, Wd + M - 1 - lx - W, ly, Hd + N - 1 - ly - H))
    gf = g4.to(acc)
    out = xp.new_zeros((g4.shape[1], x4.shape[1], N, M))
    for n in range(N):
        for m in range(M):
            out[:, :, n, m] = torch.einsum(
                "bohw,bchw->oc", gf, xp[..., n:n + Hd:sy, m:m + Wd:sx])
    return out if plan.out_axes else out[0, 0]


# K3's single-channel path (csrc/ssam_wgrad.cuh): the paper's systolic walk
# turned onto the correlation. A lane owns 16 bytes of x's columns (V = 4
# fp32 or 8 bf16 values), a warp a strip of 32·V columns; for each output
# row it reads the cotangent's row shifted by its columns (the window of
# V + M − 1 values g[oy, c − m]) and adds N·M·V products into per-tap sums
# that stay in registers for the whole walk. Warps split the footprint's
# rows into bands and a chunk's rows into row groups; persistent blocks walk
# chunks (image, strip, rows) in a fixed order, fed by a TMA ring. A
# footprint wider or taller than one block holds is cut into tiles of taps,
# one launch each.
WGRAD_LANE_BYTES = 16               # a lane's x columns: one 16-byte load
WGRAD_WARPS = 16                    # warps of a block (bands × row groups)
WGRAD_ROWS = 64                     # output rows of a chunk (one ring stage)
WGRAD_MAX_STAGES = 4
WGRAD_FLIGHT_BYTES = 32 * 1024      # bytes an SM keeps in flight
WGRAD_REGS = 128                    # a narrow block's registers a thread
# Instantiations: a tile of m ≤ 32 filter columns runs in the width bucket
# MB ≥ m. A narrow one (MB below WGRAD_WIDE_FROM) runs a block of up to
# 16 warps at 128 registers an SM; a wide one a block of up to 8 warps at
# up to 255 registers, each warp loading the next row while it multiplies
# this one. NB, the rows of a band a thread holds (NB·MB sums), is what
# those registers allow without a spill. The kernels' instantiations are
# generated from this table (wgrad_table_header). Paired runs on the card
# kept each odd bucket from 3 to 9: the next even one was more than 3 %
# slower on a filter it serves (a one-column filter runs in bucket 2).
WGRAD_WIDE_FROM = 12
WGRAD_M_BUCKETS = (2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16, 20, 24, 32)
WGRAD_BAND_ROWS = {
    4: dict(zip(WGRAD_M_BUCKETS, (8, 8, 8, 8, 8, 7, 6, 6, 5, 8, 7, 6, 4, 3))),
    8: dict(zip(WGRAD_M_BUCKETS, (8, 7, 7, 6, 5, 5, 4, 4, 4, 6, 5, 4, 3, 2))),
}


def wgrad_table_header() -> str:
    """``ssam_wgrad_table.h``, the kernels' view of the table above: the
    (bucket, band rows) instantiations of each input type and the first
    wide bucket."""
    def table(V):
        return " ".join(f"X({mb}, {nb})"
                        for mb, nb in WGRAD_BAND_ROWS[V].items())
    return ("// Generated from repro_torch/core/engine.py::WGRAD_BAND_ROWS.\n"
            "#pragma once\n"
            f"#define SSAM_WGRAD_WIDE_FROM {WGRAD_WIDE_FROM}\n"
            f"#define SSAM_WGRAD_F32(X) {table(4)}\n"
            f"#define SSAM_WGRAD_BF16(X) {table(8)}\n")


_build.GENERATED["ssam_wgrad_table.h"] = wgrad_table_header()


def wgrad_wide(mb: int) -> bool:
    """Whether K3's single-channel instantiation of width bucket ``mb`` is
    wide: a block of up to 8 warps at up to 255 registers (else up to 16
    warps at 128 registers)."""
    return mb >= WGRAD_WIDE_FROM


@dataclasses.dataclass(frozen=True)
class WgradTile:
    """One launch of K3's single-channel kernel: the ``n × m`` taps from
    ``(n0, m0)`` of the filter, the weight gradient of an ``n × m`` filter
    read at lead ``(ly, lx − m0)`` with ``ly`` the tile's lead row. The
    lane's window of the cotangent starts ``d`` columns into the 16-byte
    aligned column ``goff`` left of the strip."""

    n0: int
    m0: int
    n: int
    m: int
    ly: int
    goff: int
    d: int

    def ints(self) -> tuple[int, ...]:
        """The seven ints the C entry takes for this tile."""
        return dataclasses.astuple(self)


@dataclasses.dataclass(frozen=True)
class WgradLayout:
    """K3's single-channel geometry for one call. A lane holds ``V``
    columns of x (16 bytes), a warp a strip of ``32·V``; ``strips`` strips
    cover x's width. Output rows go in chunks of ``rows``; a unit of work
    is one (image, chunk, strip), ``units`` of them, numbered strip
    fastest, and persistent block ``k`` of ``grid`` takes units ``k, k +
    grid, …``, each staged by TMA into a ring of ``stages`` stages of
    ``stage_bytes``: the cotangent's ``rows`` rows from the tile's 16-byte
    aligned column (``32·V`` columns, then a halo box of ``hw`` more), and
    x's ``rows + n − 1`` rows of the strip. The footprint is cut into
    ``tiles`` (:class:`WgradTile`, one launch each, each reading x and g
    once); a tile's rows split into ``nbands`` bands of at most ``nb``
    rows (the instantiation ``mb``, the width bucket, holds ``nb·mb`` sums
    a thread); a block has ``warps = nbands·row_groups`` warps, warp ``w``
    taking band ``w % nbands`` on the chunk's row group ``w // nbands``.
    Each block writes one ``(N, M)`` partial; a second kernel adds the
    ``grid`` partials in block order."""

    V: int
    mb: int
    nb: int
    tiles: tuple[WgradTile, ...]
    nbands: int
    row_groups: int
    warps: int
    rows: int
    strips: int
    chunks: int
    units: int
    hw: int
    stage_bytes: int
    stages: int
    smem: int
    blocks_per_sm: int
    grid: int

    @property
    def slices(self) -> int:
        """Partial sums the first kernel writes (one a block)."""
        return self.grid

    @property
    def launches(self) -> int:
        """Kernel launches of one call: a tile each, then the pass that
        adds the partials where there is more than one block."""
        return len(self.tiles) + (self.grid > 1)

    @property
    def x_rows(self) -> int:
        """x's rows in a stage: the chunk's and the tallest tile's halo."""
        return self.rows + max(t.n for t in self.tiles) - 1

    @property
    def regions(self) -> tuple[int, int, int]:
        """Byte offsets in a stage: the halo box, x, and the end of x."""
        return _wgrad_regions(self.rows, self.hw, self.V, self.x_rows)

    def bands(self, n: int) -> tuple[tuple[int, int], ...]:
        """The bands ``(n0, rows)`` of a tile of ``n`` filter rows."""
        return tuple((b * n // self.nbands,
                      (b + 1) * n // self.nbands - b * n // self.nbands)
                     for b in range(self.nbands))

    def unit(self, u: int) -> tuple[int, int, int]:
        """``(b, chunk, strip)`` of unit ``u``."""
        r, sx = divmod(u, self.strips)
        b, cy = divmod(r, self.chunks)
        return b, cy, sx


def _wgrad_regions(rows: int, hw: int, V: int, x_rows: int):
    es = WGRAD_LANE_BYTES // V
    gh = rows * WARP * V * es
    x = gh + _round_up(rows * hw * es, 128)
    return gh, x, x + x_rows * WARP * V * es


def _cuts(n: int, parts: int) -> list[tuple[int, int]]:
    """``n`` cut into ``parts`` runs ``(start, length)`` of near-equal
    length."""
    return [(k * n // parts, (k + 1) * n // parts - k * n // parts)
            for k in range(parts)]


def wgrad_layout(B, H, W, Ho, Wo, N, M, *, lead=(0, 0),
                 elem_bytes=4) -> WgradLayout:
    """K3's single-channel layout for x ``(B, H, W)``, the cotangent ``(B,
    Ho, Wo)`` and an ``(N, M)`` filter whose lead padding is ``lead``.
    Every footprint is held: one wider than the largest bucket, or taller
    than a block's bands, is cut into tiles. Raises ``ValueError`` naming
    the limit where the walk cannot count its units."""
    ly, lx = lead
    V = WGRAD_LANE_BYTES // elem_bytes
    col_tiles = -(-M // WGRAD_M_BUCKETS[-1])
    m_max = -(-M // col_tiles)
    mb = next(b for b in WGRAD_M_BUCKETS if b >= m_max)
    nb = WGRAD_BAND_ROWS[V][mb]
    wide = wgrad_wide(mb)
    max_bands = 8 if wide else 16
    row_tiles = -(-N // (max_bands * nb))
    n_max = -(-N // row_tiles)
    nbands = -(-n_max // nb)
    tiles = []
    for n0, n in _cuts(N, row_tiles):
        for m0, m in _cuts(M, col_tiles):
            lead_c = lx - m0 - (m - 1)     # the window's first column
            d = lead_c % V
            tiles.append(WgradTile(n0, m0, n, m, ly - n0, lead_c - d, d))
    row_groups = max(1, min(WGRAD_WARPS, max_bands) // nbands)
    warps = nbands * row_groups
    hw = _round_up(max(t.d + t.m - 1 for t in tiles), V)
    red = 4 * warps * nb * mb            # the reduction reuses the ring
    fixed = 256                          # alignment, the barriers

    def stage(rows):
        return _round_up(_wgrad_regions(rows, hw, V, rows + n_max - 1)[2],
                         128)

    def smem(rows, stages):
        return _round_up(fixed + max(stages * stage(rows), red), 16)

    # the chunk's rows: WGRAD_ROWS, halved until x's box (rows + n − 1
    # rows, n ≤ 128) and a ring of two stages fit
    rows = max(1, min(WGRAD_ROWS, Ho))
    while rows > 1 and (rows + n_max - 1 > TMA_MAX_BOX
                        or smem(rows, 2) > SMEM_LIMIT):
        rows //= 2
    strips = -(-W // (WARP * V))
    chunks = -(-Ho // rows)
    units = B * chunks * strips
    if units >= 2 ** 31:
        raise ValueError(f"K3's walk counts units in 31 bits, got {units}")
    regs = 255 if wide else WGRAD_REGS
    by_regs = H100_SM_REGS // (warps * WARP * regs)
    stages = max(2, 1 + -(-WGRAD_FLIGHT_BYTES // stage(rows)))
    stages = min(stages, WGRAD_MAX_STAGES)
    while stages > 2 and smem(rows, stages) > SMEM_LIMIT:
        stages -= 1
    bps = max(1, min(by_regs, H100_SM_SMEM // (smem(rows, stages) + 1024)))
    grid = min(units, bps * H100_SMS)
    return WgradLayout(V, mb, nb, tuple(tiles), nbands, row_groups, warps,
                       rows, strips, chunks, units, hw, stage(rows), stages,
                       smem(rows, stages), bps, grid)


@dataclasses.dataclass(frozen=True)
class WgradPhase:
    """One phase of a strided single-channel weight gradient: the taps
    ``dW[sh·q + pn, sw·u + pm]`` (``n × m`` of them) are the stride-1
    gradient of an ``n × m`` filter at lead ``lead`` on x's phase image
    ``X[i, j] = x[sh·i + a, sw·j + b]`` (``xphase = (a, b)``), since
    ``xp[sh·(o + q) + pn] = X[o + q − lead]``. A stride-1 plan is one
    phase: x itself, the whole filter."""

    offset: tuple[int, int]
    xphase: tuple[int, int]
    n: int
    m: int
    lead: tuple[int, int]


def wgrad_phases(plan: SystolicPlan) -> tuple[WgradPhase, ...]:
    """The phases of :class:`WgradPhase` of a single-channel plan, in
    row-major ``(pn, pm)`` order; every tap lies in exactly one."""
    (sh, sw), (ly, lx) = plan.stride_per_axis(), plan.lead_trail()[0]
    N, M = plan.exts
    out = []
    for pn in range(min(sh, N)):
        for pm in range(min(sw, M)):
            a, b = (pn - ly) % sh, (pm - lx) % sw
            out.append(WgradPhase(
                (pn, pm), (a, b), len(range(pn, N, sh)),
                len(range(pm, M, sw)),
                ((a - pn + ly) // sh, (b - pm + lx) // sw)))
    return tuple(out)


def wgrad_phase_images(x3: torch.Tensor, stride) -> torch.Tensor:
    """x ``(B, H, W)`` as its phase images ``(sh, sw, B, ⌈H/sh⌉,
    ⌈W/sw⌉)``, ``[a, b, :, i, j] = x[:, sh·i + a, sw·j + b]``, zero past
    the edge: one copy of x (a view of x at stride 1). TMA cannot step
    through x's columns (it refuses an innermost element stride), so the
    column phases need the copy; the row phases ride along in it."""
    sh, sw = stride
    if (sh, sw) == (1, 1):
        return x3[None, None]
    B, H, W = x3.shape
    Hq, Wq = -(-H // sh), -(-W // sw)
    xp = F.pad(x3, (0, Wq * sw - W, 0, Hq * sh - H))
    return xp.reshape(B, Hq, sh, Wq, sw).permute(2, 4, 0, 1, 3).contiguous()


def _wgrad_geometry(x, g, plan: SystolicPlan):
    """The single-channel K3's operands as ``(B, H, W)`` and ``(B, Ho,
    Wo)`` tensors, its phases (:func:`wgrad_phases`) and each phase's
    :func:`wgrad_layout` on its phase image."""
    x4, g4 = _wgrad_operands(x, g, plan)
    if x4.shape[1] != 1 or g4.shape[1] != 1:
        raise ValueError("K3's single-channel path takes one channel")
    x3, g3 = x4[:, 0], g4[:, 0]
    (B, H, W), (Ho, Wo) = x3.shape, g3.shape[1:]
    sh, sw = plan.stride_per_axis()
    phases = wgrad_phases(plan)
    lays = tuple(wgrad_layout(B, -(-H // sh), -(-W // sw), Ho, Wo, ph.n,
                              ph.m, lead=ph.lead,
                              elem_bytes=x.element_size())
                 for ph in phases)
    return x3, g3, phases, lays


def emulate_wgrad_kernel(x: torch.Tensor, g: torch.Tensor, *,
                         plan: SystolicPlan, max_grid=None) -> torch.Tensor:
    """K3's single-channel schedule walked in plain torch on the CPU: the
    spec of ``csrc/ssam_wgrad.cuh`` that the CPU tests hold to the plain
    version. The wrapper's operands (pitch-padded copies where a row is not
    a multiple of 16 bytes), :func:`wgrad_layout`, each tile of the
    footprint as its own launch, the persistent walk (block ``k`` takes
    units ``k, k + grid, …``; a stage is waited for by the unit it was
    filled with, refilled once the block has read it), each unit's three
    TMA boxes (:func:`_tma_box`: zeros outside the tensors, which is every
    mask the products need), each warp's band and row group, the register
    cache's rows (asserted inside the staged rows for every row a band
    multiplies), the lane's window of the cotangent ``d`` columns into its
    16-byte chunk (its last lanes reading the halo box), the sums per lane,
    band row and step ``k = m − 1 − j`` of tap ``j``, then the fixed-order
    reduction: a butterfly over the 32 lanes, the row groups in order, the
    tiles' rows and columns of each block's partial, the partials in block
    order. A strided plan walks each of its phases (:func:`wgrad_phases`)
    so, on its phase image (:func:`wgrad_phase_images`), into its taps of
    the gradient. ``max_grid`` caps the blocks, so that a small input
    walks several units a block through the ring. Returns ``(N, M)``
    fp32."""
    x3, g3, phases, lays = _wgrad_geometry(x, g, plan)
    xph = wgrad_phase_images(x3, plan.stride_per_axis())
    sh, sw = plan.stride_per_axis()
    out = torch.zeros(plan.exts)
    for ph, lay in zip(phases, lays):
        if max_grid is not None:    # fewer blocks: more units each
            lay = dataclasses.replace(lay, grid=min(lay.grid, max_grid))
        pn, pm = ph.offset
        out[pn::sh, pm::sw] = _emulate_wgrad_phase(
            xph[ph.xphase], g3, lay, ph.n, ph.m, x.element_size())
    return out


def _emulate_wgrad_phase(x3, g3, lay: WgradLayout, N: int, M: int,
                         es: int) -> torch.Tensor:
    """One launch set of :func:`emulate_wgrad_kernel`: the ``(N, M)``
    gradient of ``x3`` against ``g3`` through ``lay``."""

    W = x3.shape[2]
    Ho, Wo = g3.shape[1:]
    V, SW = lay.V, WARP * lay.V
    assert lay.smem <= SMEM_LIMIT and lay.warps * WARP <= 512
    xt, _ = _tma_operand(x3)
    gt, _ = _tma_operand(g3)
    xm, gm = xt[:, None], gt[:, None]          # (B, 1, rows, pitch)
    rows, lane = lay.rows, torch.arange(WARP)
    partials = torch.zeros((lay.grid, N, M))
    for tile in lay.tiles:
        n, m = tile.n, tile.m
        bands = lay.bands(n)
        assert max(r for _, r in bands) <= lay.nb and m <= lay.mb
        assert tile.goff % V == 0 and 0 <= tile.d < V
        assert lay.hw >= tile.d + m - 1 and lay.hw % V == 0
        xr = rows + n - 1
        win = (lane[:, None] * V + tile.d
               + torch.arange(V + m - 1)[None, :])              # (32, V+m-1)
        done = torch.zeros(lay.units, dtype=torch.int64)
        for k in range(lay.grid):
            mine = list(range(k, lay.units, lay.grid))
            ring = mine[:lay.stages] + [None] * (lay.stages - len(mine))
            acc = torch.zeros((lay.warps, lay.nb, m, WARP))
            for i, u in enumerate(mine):
                s = i % lay.stages
                assert ring[s] == u, "a stage holds another unit"
                b, cy, sx = lay.unit(u)
                j0, oy0 = sx * SW, cy * rows
                a_g = j0 + tile.goff
                assert (a_g * es) % TMA_ALIGN == 0
                g_main = _tma_box(gm, Wo, b, (0, oy0, a_g), (1, rows, SW))[0]
                parts = [g_main.float()]
                if lay.hw:
                    parts.append(_tma_box(gm, Wo, b, (0, oy0, a_g + SW),
                                          (1, rows, lay.hw))[0].float())
                sg = torch.cat(parts, dim=1)                # (rows, SW+hw)
                sxs = _tma_box(xm, W, b, (0, oy0 - tile.ly, j0),
                               (1, xr, SW))[0].float()      # (xr, SW)
                T = min(rows, Ho - oy0)
                for w in range(lay.warps):
                    band, rg = w % lay.nbands, w // lay.nbands
                    n0, nbr = bands[band]
                    r0 = rg * T // lay.row_groups
                    r1 = (rg + 1) * T // lay.row_groups
                    if r0 >= r1:
                        continue
                    t = torch.arange(r0, r1)
                    # the register cache: band row i of row t is staged
                    # row t + n0 + i; the kernel clamps its loads to the
                    # last staged row, which only rows i >= nbr reach
                    srow = t[:, None] + n0 + torch.arange(nbr)[None, :]
                    assert int(srow.max()) < xr, "a band row is not staged"
                    xv = sxs[srow].unflatten(-1, (WARP, V))  # (T, nbr, 32, V)
                    gw = sg[t][:, win]                       # (T, 32, V+m-1)
                    for kk in range(m):
                        acc[w, :nbr, kk] += torch.einsum(
                            "tlv,tnlv->nl", gw[..., kk:kk + V], xv)
                done[u] += 1
                nxt = i + lay.stages        # the block has read it: refill
                ring[s] = mine[nxt] if nxt < len(mine) else None
            for off in (16, 8, 4, 2, 1):    # the lanes' butterfly
                acc = acc + acc[..., lane ^ off]
            red = acc[..., 0]               # (warps, nb, m)
            for band, (n0, nbr) in enumerate(bands):
                s = torch.zeros((nbr, m))
                for rg in range(lay.row_groups):
                    s = s + red[rg * lay.nbands + band, :nbr]
                r = tile.n0 + n0            # step k is tap m − 1 − k
                partials[k, r:r + nbr, tile.m0:tile.m0 + m] = s.flip(-1)
        assert bool((done == 1).all()), "a unit is not walked exactly once"
    out = torch.zeros((N, M))
    for part in partials:
        out = out + part
    return out


# K3's channel path (csrc/ssam_wgrad_tc.cu): wgmma on TMA-staged tiles
WGRAD_TC_TILE = 128             # C_out x (tap, ci) columns per block
WGRAD_TC_ROW_BYTES = 128        # a k-block: 128 bytes of one cotangent row
WGRAD_TC_MAX_STAGES = 4         # the TMA ring
WGRAD_TC_MAX_TAPS = 64
WGRAD_TC_MIN_KBLOCKS = 8        # k-blocks a reduce slice takes at least
WGRAD_TC_BLOCK_COST = 5         # a block's fixed cost (ring fill, partial
                                # tile), in k-blocks


def tma_pitch(width: int, elem_bytes: int) -> int:
    """The row pitch, in elements, of a TMA operand whose rows hold
    ``width`` elements: the next multiple of 16 bytes."""
    per = TMA_ALIGN // elem_bytes
    return -(-width // per) * per


def _tma_operand(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` as TMA reads it: rows (its last axis) at a pitch of a multiple
    of 16 bytes from a 16-byte aligned base. ``t`` itself where it already
    is so; else a pitch-padded copy whose padding holds zeros (K3's maps
    are encoded with the logical width and never read it; K2's channel
    kernel reads rows in 16-byte chunks, so the last chunk's tail must be
    zero). Returns the tensor and its pitch in elements."""
    width = t.shape[-1]
    pitch = tma_pitch(width, t.element_size())
    if pitch == width and t.is_contiguous() \
            and t.data_ptr() % TMA_ALIGN == 0:
        return t, pitch
    buf = torch.empty(t.shape[:-1] + (pitch,), dtype=t.dtype,
                      device=t.device)
    buf.narrow(-1, 0, width).copy_(t)
    if pitch > width:
        buf.narrow(-1, width, pitch - width).zero_()
    return buf, pitch


def phase_split(x4: torch.Tensor, sx: int) -> torch.Tensor:
    """``x``'s columns in ``sx`` phases, ``(B, C, H, sx, ⌈W/sx⌉)``: phase
    ``p``, column ``j`` is ``x[..., sx·j + p]``, zero past ``W``. A view
    of ``x`` (zero-padded to a multiple of ``sx`` columns where needed)."""
    W = x4.shape[-1]
    Wp = -(-W // sx)
    if Wp * sx != W:
        x4 = F.pad(x4, (0, Wp * sx - W))
    return x4.unflatten(-1, (Wp, sx)).transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class WgradTcLayout:
    """K3's channel-path geometry. A block owns 128 output channels × one
    N tile of ``taps_per_tile`` taps × ``ci_tile`` input channels (ordered
    tap-major, so each tap's ci-slab is one TMA box), and walks the
    cotangent's positions in k-blocks of ``kb`` positions (128 bytes) of
    one ``(b, oy)`` row, ``kblocks_per_row`` per row. The k-blocks split
    into ``slices`` reduce slices (as many as keep the waves of blocks
    short) whose partial tiles a second launch adds in order. Tap ``t``'s
    x box for the k-block at ``(b, oy, ox0)`` holds ``box_w`` columns
    from :meth:`box` (a 16-byte aligned column, as TMA requires);
    position ``j`` of the k-block is its column ``tap_shift[t] +
    xstep·j``: x is read in place, every ``xstep = sx``-th column, where
    such a box fits TMA's 256 columns and a ring of 3 stages, else in
    ``phases = sx`` column phases (:func:`phase_split`; the map's rows are
    ``(row, phase)`` pairs, ``xstep`` 1). ``stages`` of ``stage_bytes``
    (the g tile and the x boxes) form the TMA ring."""

    ci_tile: int
    taps_per_tile: int
    ci_tiles: int
    tap_groups: int
    kb: int
    kblocks_per_row: int
    kblocks: int
    slices: int
    grid: tuple[int, int, int]    # (N tiles, C_out tiles, slices)
    row_stride: int               # sy
    xstep: int                    # sx, or 1 when x is split in phases
    phases: int                   # 1, or sx
    box_w: int
    stages: int
    stage_bytes: int
    smem: int
    tap_col: tuple[int, ...]
    tap_shift: tuple[int, ...]
    tap_row: tuple[int, ...]
    tap_phase: tuple[int, ...]

    def box(self, tap: int, b: int, oy: int, ox0: int,
            c0: int) -> tuple[int, int, int, int]:
        """The x map coordinates (column, row, channel, batch) of ``tap``'s
        box for the k-block at ``(b, oy, ox0)``, ci-slab ``c0``."""
        row = self.row_stride * oy + self.tap_row[tap]
        return (self.xstep * ox0 + self.tap_col[tap],
                row * self.phases + self.tap_phase[tap], c0, b)


def wgrad_tc_layout(B, c_in, c_out, Ho, Wo, N, M, *, lead=(0, 0),
                    stride=(1, 1), elem_bytes=4) -> WgradTcLayout:
    taps = N * M
    if taps > WGRAD_TC_MAX_TAPS:
        raise ValueError(f"K3's channel path holds filters of up to "
                         f"{WGRAD_TC_MAX_TAPS} taps, got {N}x{M}")
    (ly, lx), (sy, sx) = lead, stride
    kb = WGRAD_TC_ROW_BYTES // elem_bytes
    align = TMA_ALIGN // elem_bytes
    # the N tile with the fewest tiles of 128 columns (ties: wider slabs)
    best = None
    for ci_tile in range(8, WGRAD_TC_TILE + 1, 8):
        tpt = min(taps, WGRAD_TC_TILE // ci_tile)
        ci_tiles, groups = -(-c_in // ci_tile), -(-taps // tpt)
        key = (ci_tiles * groups, -ci_tile)
        if best is None or key < best[0]:
            best = (key, ci_tile, tpt, ci_tiles, groups)
    _, ci_tile, tpt, ci_tiles, groups = best
    kpr = -(-Wo // kb)
    kblocks = B * Ho * kpr
    co_tiles = -(-c_out // WGRAD_TC_TILE)
    tiles = ci_tiles * groups * co_tiles

    def span(s):
        """The time of ``s`` slices in k-blocks of one SM: waves of one
        block per SM (the shared memory a block takes), each a slice."""
        return (-(-tiles * s // H100_SMS)
                * (-(-kblocks // s) + WGRAD_TC_BLOCK_COST), s)

    slices = min(range(1, max(1, kblocks // WGRAD_TC_MIN_KBLOCKS) + 1),
                 key=span)
    if co_tiles > 65535 or slices > 65535:
        raise ValueError(f"K3's grid cannot hold {c_out} channels")
    tile_bytes = WGRAD_TC_TILE * WGRAD_TC_ROW_BYTES
    # beside the ring: two x operand buffers (fp32: big and small parts),
    # the barriers, the x rows' shifts, and the slack that aligns the ring
    # to the 1024-byte swizzle period
    fixed = 2 * (2 if elem_bytes == 4 else 1) * tile_bytes \
        + 8 * WGRAD_TC_MAX_STAGES + 4 * WGRAD_TC_TILE + 1024

    def ring(box_w):
        stage = tile_bytes + -(-tpt * ci_tile * box_w * elem_bytes
                               // 1024) * 1024
        return stage, min(WGRAD_TC_MAX_STAGES, (SMEM_LIMIT - fixed) // stage)

    # x read in place, every sx-th column of a wider box, where the box
    # fits TMA and a ring of 3; else split in sx column phases
    xstep, phases = sx, 1
    box_w = -(-(sx * (kb - 1) + align) // align) * align
    stage_bytes, stages = ring(box_w)
    if box_w > TMA_MAX_BOX or stages < 3:
        xstep, phases, box_w = 1, sx, kb + align
        stage_bytes, stages = ring(box_w)
    cols, shifts, rows, tap_phases = [], [], [], []
    for tap in range(taps):
        n, m = divmod(tap, M)
        q, p = divmod(m - lx, phases)   # phase p, its column xstep·ox + q
        shifts.append(q % align)
        cols.append(q - shifts[-1])
        rows.append(n - ly)
        tap_phases.append(p)
    return WgradTcLayout(ci_tile, tpt, ci_tiles, groups, kb, kpr, kblocks,
                         slices, (ci_tiles * groups, co_tiles, slices), sy,
                         xstep, phases, box_w, stages, stage_bytes,
                         stages * stage_bytes + fixed, tuple(cols),
                         tuple(shifts), tuple(rows), tuple(tap_phases))


def _wgrad_tc_geometry(x, g, plan: SystolicPlan):
    """K3's channel-path operands as 4-D tensors and its
    :func:`wgrad_tc_layout`."""
    x4, g4 = _wgrad_operands(x, g, plan)
    B, Ci = x4.shape[:2]
    Co, Ho, Wo = g4.shape[1:]
    (ly, lx), _ = plan.lead_trail()
    return x4, g4, wgrad_tc_layout(
        B, Ci, Co, Ho, Wo, *plan.exts, lead=(ly, lx),
        stride=plan.stride_per_axis(), elem_bytes=x.element_size())


class WgradKernel:
    """Wrapper of K3. Channel (NCHW) plans launch the tensor-core kernel
    (``csrc/ssam_wgrad_tc.cu``), single-channel plans the CUDA-core one
    (``csrc/ssam_wgrad.cuh``, entry ``ssam_wgrad.cu``). ``launches``
    counts the kernel launches it made: one per gradient, or two when the
    reduction is split (the partial sums, then the pass that adds them);
    on the single-channel path one per tile of the footprint, then that
    pass, for each phase of a strided plan (:func:`wgrad_phases`;
    :meth:`launches_for`)."""

    name = "ssam_wgrad"
    source = "src/repro_torch/csrc/ssam_wgrad_tc.cu"
    single_channel_source = "src/repro_torch/csrc/ssam_wgrad.cu"
    replaces = ("src/repro/core/engine.py:737 (_wgrad_dense_kernel, "
                "pallas_call at 873)")

    def __init__(self, library: _build.Library):
        self.library = library
        self.launches = 0

    def __call__(self, x: torch.Tensor, g: torch.Tensor, *,
                 plan: SystolicPlan) -> torch.Tensor:
        if not (x.is_cuda and g.device == x.device):
            raise ValueError(f"K3 takes CUDA tensors on one device, got "
                             f"{x.device} and {g.device}")
        if x.dtype not in (torch.float32, torch.bfloat16) \
                or g.dtype != x.dtype:
            raise TypeError(f"K3 takes float32 or bfloat16 x and g of one "
                            f"dtype, got {x.dtype} and {g.dtype}")
        if plan.out_axes:
            return self._channels(x, g, plan)
        x3, g3, phases, lays = _wgrad_geometry(x, g, plan)
        if len(phases) == 1:
            return self._single(x3, g3, lays[0], plan)
        # a strided plan: each phase's taps from its phase image
        xph = wgrad_phase_images(x3, plan.stride_per_axis())
        sh, sw = plan.stride_per_axis()
        out = torch.empty(plan.exts, dtype=torch.float32, device=x.device)
        for ph, lay in zip(phases, lays):
            pn, pm = ph.offset
            out[pn::sh, pm::sw] = self._single(xph[ph.xphase], g3, lay,
                                               plan, (ph.n, ph.m))
        return out

    def _single(self, x3, g3, lay: WgradLayout, plan: SystolicPlan,
                exts=None):
        """One gradient of an ``exts`` filter (default the plan's) of
        ``x3`` against ``g3`` through ``lay``: a launch per tile, then the
        pass that adds the partials."""
        (xs, x_pitch), (gs, g_pitch) = _tma_operand(x3), _tma_operand(g3)
        B, H, W = x3.shape
        Ho, Wo = g3.shape[1:]
        N, M = exts or plan.exts
        out = torch.empty((N, M), dtype=torch.float32, device=x3.device)
        part = (torch.empty((lay.grid, N, M), dtype=torch.float32,
                            device=x3.device) if lay.grid > 1 else out)
        gh_off, x_off, _ = lay.regions
        tiles = [v for t in lay.tiles for v in t.ints()]
        err = self.library.get().ssam_wgrad_launch(
            xs.data_ptr(), gs.data_ptr(), int(x3.dtype == torch.bfloat16),
            part.data_ptr(), out.data_ptr(), B, H, W, x_pitch, Ho, Wo,
            g_pitch, N, M, lay.mb, lay.nb, lay.nbands, lay.row_groups,
            lay.rows, lay.hw, lay.stages, lay.stage_bytes, gh_off, x_off,
            lay.grid, lay.smem, len(lay.tiles),
            (ctypes.c_int * len(tiles))(*tiles),
            torch.cuda.current_stream(x3.device).cuda_stream)
        if err:
            raise RuntimeError(f"K3 launch failed: CUDA error {err} "
                               f"({plan.kind}, {N}x{M}, {tuple(x3.shape)})")
        self.launches += lay.launches
        return out

    def _channels(self, x, g, plan):
        x4, g4, lay = _wgrad_tc_geometry(x, g, plan)
        B, Ci, H, W = x4.shape
        Co, Ho, Wo = g4.shape[1:]
        N, M = plan.exts
        if lay.phases > 1:   # one pass over x: its columns in phases
            xs, x_pitch = _tma_operand(phase_split(x4, lay.phases))
            xs, xw = xs.flatten(2, 3), -(-W // lay.phases)
        else:
            (xs, x_pitch), xw = _tma_operand(x4), W
        gs, g_pitch = _tma_operand(g4)
        out = torch.empty((Co, Ci, N, M), dtype=torch.float32,
                          device=x.device)
        # a split reduction's partial tiles: (slice, N tile, C_out, 128)
        part = (torch.empty((lay.slices, lay.grid[0], Co, WGRAD_TC_TILE),
                            dtype=torch.float32, device=x.device)
                if lay.slices > 1 else out)
        taps = ctypes.c_int * (N * M)
        err = self.library.get().ssam_wgrad_tc_launch(
            xs.data_ptr(), gs.data_ptr(), int(x.dtype == torch.bfloat16),
            part.data_ptr(), out.data_ptr(), xw, H * lay.phases, Ci, B,
            x_pitch, Wo, Ho, Co, B, g_pitch, Co, Ci, N * M, lay.row_stride,
            lay.xstep, lay.phases, lay.ci_tile, lay.taps_per_tile,
            lay.ci_tiles, lay.kblocks_per_row, lay.kblocks, lay.box_w,
            lay.stages, lay.stage_bytes, taps(*lay.tap_col),
            taps(*lay.tap_shift),
            taps(*lay.tap_row), taps(*lay.tap_phase), *lay.grid, lay.smem,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K3 launch failed: CUDA error {err} "
                               f"({plan.kind}, {Co}x{Ci}x{N}x{M})")
        self.launches += 1 + (lay.slices > 1)
        return out

    @staticmethod
    def launches_for(x, g, *, plan: SystolicPlan) -> int:
        """The launches one call on ``x`` and ``g`` makes (any device)."""
        if plan.out_axes:
            return 1 + (_wgrad_tc_geometry(x, g, plan)[2].slices > 1)
        return sum(lay.launches for lay in _wgrad_geometry(x, g, plan)[3])


WGRAD_KERNEL = WgradKernel(_build.LIBRARY)

PERLANE_WGRAD_TARGET_BLOCKS = 4 * 132   # enough blocks for every SM


def perlane_wgrad_layout(batch: int, Tg: int, D: int) -> tuple[int, int]:
    """K4's split of the reduction: ``(rows, slices)``, each block summing
    ``rows`` cotangent rows (a multiple of 4) of one sequence for 128
    lanes, ``slices`` blocks along time, so that lane tiles × sequences ×
    slices fill the card."""
    lane_tiles = -(-D // PERLANE_LANES)
    want = -(-PERLANE_WGRAD_TARGET_BLOCKS // (lane_tiles * batch))
    slices = max(1, min(want, -(-Tg // 32)))
    rows = -(-(-(-Tg // slices)) // 4) * 4
    return rows, -(-Tg // rows)


def perlane_wgrad_launches(batch: int, Tg: int, D: int) -> int:
    """K4's launches for one gradient: the partial sums, and the pass that
    adds them when more than one block shares a lane tile."""
    _, slices = perlane_wgrad_layout(batch, Tg, D)
    return 1 + (batch * slices > 1)


class PerlaneWgradKernel:
    """Wrapper of K4. ``launches`` counts the kernel launches it made: one
    per gradient, or two when the reduction is split
    (:func:`perlane_wgrad_launches`)."""

    name = "ssam_wgrad_perlane"
    source = "src/repro_torch/csrc/ssam_wgrad_perlane.cu"
    replaces = ("src/repro/core/engine.py:757 (_wgrad_perlane_kernel, "
                "pallas_call at 835)")

    def __init__(self, library: _build.Library):
        self.library = library
        self.launches = 0

    def __call__(self, x: torch.Tensor, g: torch.Tensor, *,
                 plan: SystolicPlan) -> torch.Tensor:
        if not (x.is_cuda and g.device == x.device):
            raise ValueError(f"K4 takes CUDA tensors on one device, got "
                             f"{x.device} and {g.device}")
        if x.dtype not in (torch.float32, torch.bfloat16) \
                or g.dtype != x.dtype:
            raise TypeError(f"K4 takes float32 or bfloat16 x and g of one "
                            f"dtype, got {x.dtype} and {g.dtype}")
        if plan.N > PERLANE_MAX_ROWS:
            raise ValueError(f"K4 holds filters of up to {PERLANE_MAX_ROWS} "
                             f"taps, got N={plan.N}")
        x3, g3 = _wgrad_perlane_operands(x, g, plan)
        x3, g3 = x3.contiguous(), g3.contiguous()
        Bn, T, D = x3.shape
        Tg, K = g3.shape[1], plan.N
        (lead, _), _ = plan.lead_trail()
        rows, slices = perlane_wgrad_layout(Bn, Tg, D)
        if Bn > 65535 or slices > 65535:
            raise ValueError(f"K4's grid cannot hold {Bn} sequences")
        out = torch.empty((K, D), dtype=torch.float32, device=x.device)
        parts = Bn * slices
        part = (torch.empty((parts, K, D), dtype=torch.float32,
                            device=x.device) if parts > 1 else out)
        err = self.library.get().ssam_wgrad_perlane_launch(
            x3.data_ptr(), g3.data_ptr(), int(x.dtype == torch.bfloat16),
            part.data_ptr(), out.data_ptr(), Bn, T, D, Tg, K, lead, rows,
            slices, torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K4 launch failed: CUDA error {err} "
                               f"({plan.kind}, {tuple(x.shape)})")
        self.launches += 1 + (parts > 1)
        return out

    @staticmethod
    def launches_for(x, g, *, plan: SystolicPlan) -> int:
        """The launches one call on ``x`` and ``g`` makes (any device)."""
        x3, g3 = _wgrad_perlane_operands(x, g, plan)
        return perlane_wgrad_launches(x3.shape[0], g3.shape[1], x3.shape[2])


PERLANE_WGRAD_KERNEL = PerlaneWgradKernel(_build.LIBRARY)


def run_weight_grad_plan(x: torch.Tensor, g: torch.Tensor, *,
                         plan: SystolicPlan) -> torch.Tensor:
    """Backward-weight of a dense or per-lane windowed plan: ``∂L/∂w`` of
    ``y = run_window_plan(x, w, plan=plan)`` given the cotangent ``g``
    (shaped like the stride-free output). K3 (K4 for a per-lane plan) for
    CUDA tensors, the plain version for CPU tensors. Returns fp32 (the
    accumulator's dtype) in the filter's layout: ``(N, M)``, ``(C_out,
    C_in, N, M)`` or ``(K, D)``."""
    if x.device.type == "cuda":
        if plan.coeff_mode == "perlane":
            return PERLANE_WGRAD_KERNEL(x, g, plan=plan)
        return WGRAD_KERNEL(x, g, plan=plan)
    if x.device.type == "cpu":
        return run_weight_grad_plan_reference(x, g, plan=plan)
    raise ValueError(f"no weight-gradient engine for device {x.device}")


# ---------------------------------------------------------------------------
# Scan family: cumsum / linear recurrence (K5)
# ---------------------------------------------------------------------------

COMBINES = ("add", "linrec")


def check_scan_plan(plan: SystolicPlan, operands) -> None:
    """Raise for a scan plan or operands this port does not run."""
    if plan.combine not in COMBINES:
        raise ValueError(f"{plan.kind!r} plan has combine={plan.combine!r}: "
                         f"run_scan_plan takes {COMBINES}; windowed plans "
                         "run through run_window_plan")
    if plan.epilogue:
        raise NotImplementedError(
            f"{plan.kind!r} plan: epilogues on scan plans are not ported "
            "yet (ROADMAP Queue 1 item 4; no ops.* call reaches it: the "
            "scan ops refuse epilogue=)")
    want = 2 if plan.combine == "linrec" else 1
    if len(operands) != want:
        raise ValueError(f"combine={plan.combine!r} takes {want} operand(s), "
                         f"got {len(operands)}")
    shape = operands[0].shape
    if (len(shape) != 2 or 0 in shape
            or any(o.shape != shape for o in operands)):
        raise ValueError(f"scan operands must share one non-empty (R, T) "
                         f"shape, got {[tuple(o.shape) for o in operands]}")


def _carry_rows(carry, R, like):
    """``carry`` (``(R,)`` or ``(R, 1)``) as ``(R, 1)`` in the operands'
    dtype, as the reference casts it before the kernel reads it."""
    return carry.reshape(R, 1).to(like.dtype)


def run_scan_plan_reference(*operands: torch.Tensor, plan: SystolicPlan,
                            block_r: int = 8, carry=None,
                            return_carry: bool = False):
    """The plain version of K5, on any device: the reference
    ``_scan_kernel`` body over the ``_scan_call`` tiling.

    Operands pad with the combine's identity (``add``: 0; ``linrec``:
    ``(1, 0)``) to ``(gr·BR, gt·S)`` and split into ``(BR, S)`` tiles.
    Row tiles are independent, so they run as one batch. In every tile
    the Kogge–Stone steps of ``plan.steps`` shift by ``d`` and combine
    under ``lane >= d`` (``linrec``: ``A, B = A·As, A·Bs + B``, f_t ∘
    f_{t−d}); the in-tile scan does not read the carry, so all T tiles
    scan at once. The carry then walks the T tiles in order: seeded from
    ``carry`` (else 0), ``add`` adds it after the scan, ``linrec`` applies
    the prefix to it (``h = A·carry + B``), and the tile's last lane is
    the next carry. fp32 accumulation (fp64 for fp64 operands, so that
    fp64 gradcheck holds the scan's gradients to its own precision); the
    output, and the ``(R, 1)`` carry-out, in the operands' dtype.
    """
    check_scan_plan(plan, operands)
    x0 = operands[0]
    R, T = x0.shape
    S = plan.S
    BR = min(block_r, R)
    gr, gt = -(-R // BR), -(-T // S)
    pad = (0, gt * S - T, 0, gr * BR - R)
    acc = acc_dtype(x0)
    if plan.combine == "linrec":
        A = F.pad(operands[0].to(acc), pad, value=1.0)
        B = F.pad(operands[1].to(acc), pad)
    else:
        A = None
        B = F.pad(operands[0].to(acc), pad)
    tiles = (gr * BR, gt, S)
    B = B.reshape(tiles)
    if A is not None:
        A = A.reshape(tiles)
    lane = torch.arange(S, device=x0.device)
    for step in plan.steps:
        ctrl = lane >= step.shift
        Bs = torch.where(ctrl, torch.roll(B, step.shift, dims=-1), 0.0)
        if A is None:
            B = B + Bs
            continue
        As = torch.where(ctrl, torch.roll(A, step.shift, dims=-1), 1.0)
        A, B = A * As, A * Bs + B
    c = (x0.new_zeros((R, 1), dtype=acc) if carry is None
         else _carry_rows(carry, R, x0).to(acc))
    c = F.pad(c, (0, 0, 0, gr * BR - R))
    outs = []
    for j in range(gt):
        h = B[:, j] + c if A is None else A[:, j] * c + B[:, j]
        c = h[:, -1:]
        outs.append(h)
    out = torch.stack(outs, dim=1).reshape(gr * BR, gt * S)[:R, :T]
    out = out.to(x0.dtype)
    if return_carry:
        return out, c[:R].to(x0.dtype)
    return out


class ScanKernel:
    """Wrapper of K5. ``launches`` counts the kernel launches it made."""

    name = "ssam_scan"
    source = "src/repro_torch/csrc/ssam_scan.cu"
    replaces = "src/repro/core/engine.py:897 (_scan_kernel, pallas_call at 1015)"

    def __init__(self, library: _build.Library):
        self.library = library
        self.launches = 0

    def __call__(self, *operands: torch.Tensor, plan: SystolicPlan,
                 carry=None, return_carry: bool = False):
        check_scan_plan(plan, operands)
        x0 = operands[0]
        if not all(o.is_cuda and o.device == x0.device for o in operands):
            raise ValueError(f"K5 takes CUDA tensors on one device, got "
                             f"{[str(o.device) for o in operands]}")
        if x0.dtype not in (torch.float32, torch.bfloat16) or any(
                o.dtype != x0.dtype for o in operands):
            raise TypeError(f"K5 takes float32 or bfloat16 operands of one "
                            f"dtype, got {[o.dtype for o in operands]}")
        R, T = x0.shape
        ops_c = [o.contiguous() for o in operands]
        out = torch.empty_like(ops_c[0])
        cin = None
        if carry is not None:
            if carry.device != x0.device:
                raise ValueError("the carry must lie on the operands' device")
            cin = _carry_rows(carry, R, x0).contiguous()
        cout = (torch.empty((R, 1), dtype=x0.dtype, device=x0.device)
                if return_carry else None)
        err = self.library.get().ssam_scan_launch(
            ops_c[0].data_ptr(),
            ops_c[1].data_ptr() if len(ops_c) == 2 else None,
            None if cin is None else cin.data_ptr(), out.data_ptr(),
            None if cout is None else cout.data_ptr(), R, T,
            COMBINES.index(plan.combine), int(x0.dtype == torch.bfloat16),
            torch.cuda.current_stream(x0.device).cuda_stream)
        if err:
            raise RuntimeError(f"K5 launch failed: CUDA error {err} "
                               f"({plan.combine}, R={R}, T={T})")
        self.launches += 1
        return (out, cout) if return_carry else out


SCAN_KERNEL = ScanKernel(_build.LIBRARY)


def run_scan_plan(*operands: torch.Tensor, plan: SystolicPlan,
                  block_r: int = 8, carry=None, return_carry: bool = False):
    """Run a scan plan over ``(R, T)`` operands: K5 for CUDA tensors, the
    plain version for CPU tensors, an error for anything else.

    ``carry`` (``(R,)`` or ``(R, 1)``) seeds the state h₋₁ entering the
    first tile (default 0); ``return_carry=True`` also returns the final
    raw state ``(R, 1)``. ``plan.S`` and ``block_r`` set the plain
    version's ``(block_r, S)`` tile; K5 walks each row in 32-lane pieces
    whatever the plan's tile. The two compute the same function and
    differ only in rounding.
    """
    check_scan_plan(plan, operands)
    dev = operands[0].device
    if dev.type == "cuda":
        return SCAN_KERNEL(*operands, plan=plan, carry=carry,
                           return_carry=return_carry)
    if dev.type == "cpu":
        return run_scan_plan_reference(*operands, plan=plan, block_r=block_r,
                                       carry=carry, return_carry=return_carry)
    raise ValueError(f"no scan engine for device {dev}")


def check_chunk_geometry(plan: SystolicPlan, chunk: int) -> None:
    """Guards of the chunk-streamed scan schedule: no epilogues (the
    streamed schedule carries the raw state between chunks), and a chunk
    that holds a whole number of lane tiles."""
    if plan.epilogue_op_count():
        raise ValueError(
            f"{plan.kind}: epilogue stages are illegal under chunking — the "
            "chunk-streamed schedule carries the raw scan state between "
            "chunks and recomputes it on backward; apply activations to "
            "the streamed output instead")
    if chunk < plan.S:
        raise ValueError(
            f"{plan.kind}: chunk={chunk} is smaller than the lane tile "
            f"S={plan.S}; a chunk must hold at least one Kogge–Stone tile")
    if chunk % plan.S:
        raise ValueError(
            f"{plan.kind}: chunk={chunk} is not a multiple of the lane "
            f"tile S={plan.S}; partial tiles would shift the carry "
            "hand-off off the tile boundary")


def run_scan_plan_chunked(*operands: torch.Tensor, plan: SystolicPlan,
                          chunk: int, block_r: int = 8, carry=None,
                          return_carry: bool = False, step=None):
    """Stream a scan plan over ``(R, chunk)`` slabs: one
    :func:`run_scan_plan` call per slab (one K5 launch on the card), the
    carry threaded from each slab to the next. T pads to whole chunks
    with the combine's identity.

    ``step(*slabs, carry) -> (out, carry)`` replaces the per-slab call,
    for a caller that wraps it (``ops.chunked_linear_recurrence`` runs
    each slab through its autograd Function under a checkpoint)."""
    check_chunk_geometry(plan, chunk)
    check_scan_plan(plan, operands)
    if step is None:
        def step(*slabs, carry):
            return run_scan_plan(*slabs, plan=plan, block_r=block_r,
                                 carry=carry, return_carry=True)
    x0 = operands[0]
    R, T = x0.shape
    nc = -(-T // chunk)
    pad = (0, nc * chunk - T)
    if plan.combine == "linrec":
        padded = (F.pad(operands[0], pad, value=1.0), F.pad(operands[1], pad))
    else:
        padded = (F.pad(operands[0], pad),)
    c = (x0.new_zeros((R, 1)) if carry is None else _carry_rows(carry, R, x0))
    outs = []
    for i in range(nc):
        out, c = step(*(o[:, i * chunk:(i + 1) * chunk] for o in padded),
                      carry=c)
        outs.append(out)
    out = torch.cat(outs, dim=1)[:, :T]
    return (out, c) if return_carry else out
