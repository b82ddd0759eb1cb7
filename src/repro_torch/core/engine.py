"""The plan engine: windowed plans (K1, K2, K3, K4) and scan plans (K5),
each a CUDA kernel beside its plain version.

:func:`run_window_plan` runs a windowed :class:`SystolicPlan` (2-D and
3-D stencils, dense 2-D convolution, with leading batch axes, NCHW
convolution with a channel reduction, an output stride and a fused
epilogue, and depthwise (per-lane) conv1d with a per-lane bias and an
activation fused) over an input whose lane axis is last. The tensor's
device decides how:

* a CUDA tensor launches K1, the hand-written kernel in
  ``csrc/ssam_window*.cu`` (it replaces the JAX package's
  ``core/engine.py::_window_kernel``), or, for a plan whose
  ``strategy`` is ``'mxu'``, K2, the tensor-core kernel in
  ``csrc/ssam_mxu.cu`` (it replaces ``_apply_plan_mxu``); a failure
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
``∂L/∂w[n,m] = Σ_{b,o} g[b,o]·xp[b,o+(n,m)]`` of a dense plan, K3
(``csrc/ssam_wgrad.cu``, replacing ``_wgrad_dense_kernel``), and
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

import torch
import torch.nn.functional as F

from .. import _build
from .adjoint import apply_epilogue
from .halo import origin_pads
from .plan import EPILOGUE_OPERANDS, SystolicPlan, epilogue_operand_stages

VARIANTS = ("shift_psum", "shift_data")
STRATEGIES = (None, "lanes", "mxu")
MXU_TAP_ALIGN = 8            # K2's im2row taps pad to a multiple of 8
WARP = 32
SMEM_LIMIT = 232448          # bytes of shared memory one H100 block may use
TABLE_SLOTS = 1024           # the kernel's tap-table limit (steps · D · N)
# K1's epilogue codes (csrc/ssam_window_reduce.cu), in the kernel's order
EPILOGUE_CODES = {"bias": 1, "gelu": 2, "silu": 3, "relu": 4, "scale": 5}
MAX_EPILOGUE = 8


def _is_reduce(plan: SystolicPlan) -> bool:
    return bool(plan.reduce_axes or plan.out_axes)


def check_supported(plan: SystolicPlan, time_steps: int, variant: str) -> None:
    """Raise for what the port does not run yet."""
    todo = []
    reduce = _is_reduce(plan)
    if reduce and (plan.reduce_axes, plan.out_axes) != (1, 1):
        todo.append("reduce/out axes other than one of each (ROADMAP "
                    "Queue 1 item 4)")
    if any(v > 1 for v in plan.stride_per_axis()) and not reduce:
        todo.append("output strides on single-channel plans (ROADMAP "
                    "Queue 1 item 4)")
    perlane = plan.coeff_mode == "perlane"
    if plan.epilogue and not reduce and not perlane:
        todo.append("epilogues on single-channel and stencil plans "
                    "(ROADMAP Queue 1 item 4)")
    if any(st.op == "residual_add" for st in plan.epilogue):
        todo.append("residual_add epilogues (ROADMAP Queue 1 item 4)")
    if plan.stages:
        todo.append("fused stages (ROADMAP Queue 1 item 7)")
    if perlane and plan.strategy == "mxu":
        todo.append("strategy='mxu' on per-lane coefficients, the "
                    "lane-batched mat-vec (ROADMAP Queue 1 item 5c)")
    if perlane and time_steps != 1:
        todo.append("temporal blocking of per-lane plans (ROADMAP Queue 1 "
                    "item 4)")
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
    elif time_steps != 1 and any(v > 1 for v in plan.stride_per_axis()):
        raise ValueError("output strides support single plan applications")


def _check_operands(plan: SystolicPlan, x, w, epilogue_args) -> None:
    """Shapes of the filter and the epilogue operands against the plan."""
    if plan.coeff_mode in ("dense", "perlane") and w is None:
        raise ValueError(f"a {plan.coeff_mode} plan needs its filter w")
    need = epilogue_operand_stages(plan.epilogue)
    if len(epilogue_args) != len(need):
        raise ValueError(
            f"epilogue {tuple(s.op for s in plan.epilogue)} needs "
            f"{len(need)} runtime operand(s), got {len(epilogue_args)}")
    if plan.coeff_mode == "perlane":
        rows = 1 + max(t.coeff_id[-1] for t in plan.steps[0].taps)
        if w.ndim != 2 or w.shape[1] != x.shape[-1] or w.shape[0] < rows:
            raise ValueError(
                f"{plan.kind!r}: per-lane filter {tuple(w.shape)} must be "
                f"(>= {rows}, D) with D = x's lane axis {x.shape[-1]}")
        for st, arr in zip(need, epilogue_args):
            if st.op == "bias" and tuple(arr.shape) != (x.shape[-1],):
                raise ValueError(f"bias epilogue wants a per-lane "
                                 f"({x.shape[-1]},) row, got "
                                 f"{tuple(arr.shape)}")
        return
    if not _is_reduce(plan):
        return
    nb = plan.batch_axes
    if x.ndim != nb + 3 or w.ndim != 4 or w.shape[1] != x.shape[nb]:
        raise ValueError(
            f"{plan.kind!r}: x {tuple(x.shape)} must be (B, C_in, H, W) "
            f"against a (C_out, C_in, N, M) filter, got w {tuple(w.shape)}")
    if tuple(w.shape[2:]) != plan.exts:
        raise ValueError(f"filter {tuple(w.shape)} does not match the "
                         f"plan's footprint {plan.exts}")
    for st, arr in zip(need, epilogue_args):
        if st.op == "bias" and tuple(arr.shape) != (w.shape[0],):
            raise ValueError(f"bias epilogue wants a per-C_out "
                             f"({w.shape[0]},) row, got {tuple(arr.shape)}")


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
    reference's ``_apply_plan_mxu`` for 'table' and 'dense' coefficients.

    Each tap's shifted crop of the block (:func:`_mxu_view`) is a row of
    a ``(taps padded to 8, out_elems)`` operand, contracted with the
    coefficient row in the accumulator's dtype. 'table' coefficients
    fold into their rows against a ones row, as the reference does. For
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
        pad = MXU_TAP_ALIGN - len(group)
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
    _check_operands(plan, x, w, epilogue_args)
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

def _epilogue_codes(plan: SystolicPlan, epilogue_args, device):
    """A reduce plan's epilogue as the kernels read it: ``(ops, values,
    count, bias)``, ``ops`` and ``values`` ctypes arrays of
    :data:`MAX_EPILOGUE` entries (codes of :data:`EPILOGUE_CODES`), ``bias``
    the fp32 per-C_out row or None."""
    ops_, vals, bias = [], [], None
    args = iter(epilogue_args)
    for st in plan.epilogue:
        ops_.append(EPILOGUE_CODES[st.op])
        vals.append(st.value or 0.0)
        if st.op in EPILOGUE_OPERANDS:
            arr = next(args)
            if arr.device != device:
                raise ValueError("epilogue operands must lie on x's device")
            bias = arr.detach().to(torch.float32).contiguous()
    if len(ops_) > MAX_EPILOGUE:
        raise ValueError(f"the kernels apply at most {MAX_EPILOGUE} "
                         "epilogue stages")
    return ((ctypes.c_int * MAX_EPILOGUE)(*ops_),
            (ctypes.c_float * MAX_EPILOGUE)(*vals), len(ops_), bias)


def _check_kernel_operands(kernel: str, x, w, plan: SystolicPlan) -> None:
    """Device and dtype checks every windowed kernel (K1, K2) makes."""
    if not x.is_cuda:
        raise ValueError(f"{kernel} takes a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel} takes float32 or bfloat16, got {x.dtype}")
    if plan.coeff_mode in ("dense", "perlane") and w.device != x.device:
        raise ValueError(f"a {plan.coeff_mode} plan takes its filter w on "
                         "the same device as x")


def _tile_launch(plan: SystolicPlan, x, block, t: int):
    """A single-channel launch's geometry, padded to 3-D as both K1 and K2
    read it: ``(x, out, B, head, tile)``, ``x`` contiguous, ``out`` empty,
    ``B`` the output tile, ``head`` the ints ``(batch, zin, hin, win, zo,
    ho, wo, lz, ly, lx)`` (``l*`` the ``t``-fold lead) and ``tile`` ``(bz,
    bh, bw)``."""
    nb, nd = plan.batch_axes, plan.ndim_spatial
    spatial_in, out_sp, B, _ = _geometry(plan, x.shape, block, t)
    x = x.contiguous()
    batch = 1
    for d in x.shape[:nb]:
        batch *= d
    out = torch.empty(tuple(x.shape[:nb]) + out_sp, dtype=x.dtype,
                      device=x.device)
    pad3 = (1,) * (3 - nd)
    lead, _ = plan.lead_trail()
    head = ((batch,) + pad3 + spatial_in + pad3 + out_sp
            + (0,) * (3 - nd) + tuple(t * v for v in lead))
    return x, out, B, head, pad3 + B


@dataclasses.dataclass
class _ReduceLaunch:
    """What both channel-reduce paths (K1's, K2's) launch with: ``args``
    the leading arguments of their C entries (through the plan's ``N``,
    ``M``), ``out`` the empty output, ``keep`` the tensors ``args`` point
    into (alive until the launch is enqueued)."""

    args: list
    out: torch.Tensor
    keep: tuple
    ntaps: int
    c_in: int


def _reduce_launch(kernel: str, plan: SystolicPlan, x, w, epilogue_args,
                   co_tile: int) -> _ReduceLaunch:
    """``x (B, C_in, H, W)`` against ``w (C_out, C_in, N, M)``: the tap
    table, the fp32 filter, the epilogue and the output of one reduce
    launch, the grid checked against CUDA's limits."""
    x4 = (x if plan.batch_axes else x[None]).contiguous()
    Bn, Cr, H, W = x4.shape
    Co = w.shape[0]
    Ho, Wo = plan.out_shape((H, W))
    if Ho > 65535 or Bn * -(-Co // co_tile) > 65535:
        raise ValueError(f"{kernel}'s reduce grid cannot hold {Ho} rows or "
                         f"{Bn} x {Co} channels")
    taps = reduce_tap_table(plan)
    dtaps = _device_ints(taps, x.device)
    wf = w.detach().to(torch.float32).contiguous()
    c_ops, c_vals, n_epi, bias = _epilogue_codes(plan, epilogue_args,
                                                 x.device)
    out = torch.empty((Bn, Co, Ho, Wo), dtype=x.dtype, device=x.device)
    (ly, lx), _ = plan.lead_trail()
    sh, sw = plan.stride_per_axis()
    args = [x4.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            wf.data_ptr(), dtaps.data_ptr(), len(taps) // 3,
            None if bias is None else bias.data_ptr(), c_ops, c_vals, n_epi,
            Bn, Cr, Co, H, W, Ho, Wo, ly, lx, sh, sw, plan.N * plan.M,
            plan.N, plan.M]
    return _ReduceLaunch(args, out, (x4, wf, bias), len(taps) // 3, Cr)


class WindowKernel:
    """Wrapper of K1. ``launches`` counts the kernel launches it made:
    one per call, on the single-channel path (``ssam_window_launch``) and
    on the channel-reduce path (``ssam_window_reduce_launch``) alike."""

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
        t, nd = time_steps, plan.ndim_spatial
        table = tap_table(plan, None if w is None else tuple(w.shape))
        cidx, shifts, cvals = _device_table(table, x.device)
        if plan.coeff_mode == "dense":
            cvals = w.detach().to(torch.float32).contiguous()
        x, out, B, head, tile = _tile_launch(plan, x, block, t)
        smem = smem_bytes(plan, B, t)
        if smem > SMEM_LIMIT:
            raise ValueError(f"block {B} needs {smem} bytes of shared memory "
                             f"(limit {SMEM_LIMIT}); pass a smaller block")
        err = self.library.get().ssam_window_launch(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            cvals.data_ptr(), cidx.data_ptr(), shifts.data_ptr(), *head, nd,
            plan.depth if nd == 3 else 1, plan.N, len(plan.steps),
            table.lanes_used, t, VARIANTS.index(variant), *tile, smem,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                               f"({plan.kind}, block {B}, t={t})")
        self.launches += 1
        return out

    def _reduce(self, x, w, plan, epilogue_args):
        """The channel-reduce path: ``x (B, C_in, H, W)`` against
        ``w (C_out, C_in, N, M)``, output stride and epilogue."""
        r = _reduce_launch("K1", plan, x, w, epilogue_args, REDUCE_CO_TILE)
        ci_t, smem = reduce_smem_plan(plan, r.ntaps, r.c_in)
        err = self.library.get().ssam_window_reduce_launch(
            *r.args, ci_t, smem,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                               f"({plan.kind}, reduce {r.c_in} -> "
                               f"{w.shape[0]})")
        self.launches += 1
        return r.out if plan.batch_axes else r.out[0]

    def _perlane(self, x, w, plan, epilogue_args):
        """The per-lane (depthwise) path: ``x (…, T, D)`` against ``w (K,
        D)``, one thread per lane streaming down time, with the per-lane
        bias and the activations fused (``ssam_window_perlane.cu``)."""
        rows = perlane_row_table(plan)
        nb = plan.batch_axes
        x = x.contiguous()
        batch = 1
        for d in x.shape[:nb]:
            batch *= d
        T, D = x.shape[nb:]
        To = plan.out_shape((T, D))[0]
        if -(-To // PERLANE_ROWS) > 65535 or batch > 65535:
            raise ValueError(f"K1's per-lane grid cannot hold {To} rows of "
                             f"{batch} sequences")
        (lead, _), _ = plan.lead_trail()
        wf = w.detach().to(torch.float32).contiguous()
        c_ops, c_vals, n_epi, bias = _epilogue_codes(plan, epilogue_args,
                                                     x.device)
        out = torch.empty(tuple(x.shape[:nb]) + (To, D), dtype=x.dtype,
                          device=x.device)
        err = self.library.get().ssam_window_perlane_launch(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            wf.data_ptr(), (ctypes.c_int * PERLANE_MAX_ROWS)(*rows),
            plan.N, None if bias is None else bias.data_ptr(), c_ops, c_vals,
            n_epi, batch, T, D, To, lead,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                               f"({plan.kind}, per-lane {tuple(x.shape)})")
        self.launches += 1
        return out


WINDOW_KERNEL = WindowKernel(_build.LIBRARY)

# The per-lane path's block: 128 lanes (one thread each) x 64 output rows.
PERLANE_LANES = 128
PERLANE_ROWS = 64
PERLANE_MAX_ROWS = 8          # footprint rows (filter taps) it holds


def perlane_row_table(plan: SystolicPlan) -> tuple[int, ...]:
    """A per-lane plan's taps as K1 and K4 read them: per footprint row,
    the row of ``w`` its tap multiplies (``-1``: no tap), padded to
    :data:`PERLANE_MAX_ROWS`. The rows are summed in row order, which is
    the plan's order for the depthwise builder and its input adjoint."""
    if plan.N > PERLANE_MAX_ROWS:
        raise ValueError(f"K1's per-lane path holds filters of up to "
                         f"{PERLANE_MAX_ROWS} taps, got N={plan.N}")
    rows = [-1] * PERLANE_MAX_ROWS
    prev = -1
    for tap in plan.steps[0].taps:
        r = tap.row_offset
        if not 0 <= r < plan.N or rows[r] != -1 or r < prev:
            raise ValueError(f"per-lane taps must sit on distinct rows of "
                             f"the footprint in row order, got {tap}")
        rows[r], prev = tap.coeff_id[-1], r
    return tuple(rows)

# The reduce path's block: 8 warps x 4 output channels, 1 row x 128 columns
# (4 per lane); input channels are staged REDUCE_CI_MAX at a time at most.
REDUCE_CO_TILE = 32
REDUCE_COLS = 128
REDUCE_CI_MAX = 16
REDUCE_SMEM_TARGET = 48 * 1024


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


def reduce_smem_plan(plan: SystolicPlan, ntaps: int, c_in: int):
    """``(ci_t, bytes)``: input channels staged per pass and the dynamic
    shared memory of one reduce block (layout of
    ``ssam_window_reduce.cu``: tap table, ``ci_t × taps × 32`` filter
    values, ``ci_t × N`` staged input rows)."""
    sw = plan.stride_per_axis()[1]
    span = (REDUCE_COLS - 1) * sw + plan.M
    table = (3 * ntaps + 3) & ~3
    per_ci = ntaps * REDUCE_CO_TILE + plan.N * span
    ci_t = (REDUCE_SMEM_TARGET // 4 - table) // per_ci
    ci_t = max(1, min(REDUCE_CI_MAX, c_in, ci_t))
    smem = 4 * (table + ci_t * per_ci)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K1's reduce block needs {smem} bytes of shared "
                         f"memory (limit {SMEM_LIMIT})")
    return ci_t, smem


@dataclasses.dataclass(frozen=True)
class TapTable:
    """A plan's taps as the kernel reads them: ``cidx`` holds, per slot
    ``(step, dz, row)``, an index into the coefficient array (the plan's
    immediates or the flattened dense filter), ``-1`` for no tap."""

    cidx: tuple[int, ...]
    shifts: tuple[int, ...]
    coeffs: tuple[float, ...] | None
    lanes_used: int           # M: the lanes one output's column steps span


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
    cidx = [-1] * (steps * D * N)
    for m, step in enumerate(plan.steps):
        for tap in step.taps:
            if not (0 <= tap.row_offset < N and 0 <= tap.z_offset < D):
                raise ValueError(f"tap {tap} lies outside the footprint")
            slot = (m * D + tap.z_offset) * N + tap.row_offset
            if cidx[slot] != -1:
                raise ValueError(f"two taps of step {m} read the same "
                                 f"cell {tap}")
            if plan.coeff_mode == "table":
                if not 0 <= tap.coeff_id[-1] < len(plan.coeffs or ()):
                    raise ValueError(f"tap {tap} has no coefficient in the "
                                     "plan's table")
                cidx[slot] = tap.coeff_id[-1]
            else:
                if len(tap.coeff_id) != len(w_shape) or not all(
                        0 <= i < n for i, n in zip(tap.coeff_id, w_shape)):
                    raise ValueError(f"tap {tap} lies outside the filter of "
                                     f"shape {w_shape}")
                flat = 0
                for i, n in zip(tap.coeff_id, w_shape):
                    flat = flat * n + i
                cidx[slot] = flat
    shifts = [s.shift for s in plan.steps]
    return TapTable(tuple(cidx), tuple(shifts), plan.coeffs, plan.M)


@functools.lru_cache(maxsize=256)
def _device_table(table: TapTable, device):
    """Device copies of a tap table (slot indices, shifts and the plan's
    immediates), kept per (table, device)."""
    cidx = torch.tensor(table.cidx, dtype=torch.int32, device=device)
    shifts = torch.tensor(table.shifts, dtype=torch.int32, device=device)
    const = torch.tensor(table.coeffs or (0.0,), dtype=torch.float32,
                         device=device)
    return cidx, shifts, const


def smem_bytes(plan: SystolicPlan, block, time_steps: int) -> int:
    """Dynamic shared memory of one single-channel K1 block: the tap
    table, the staged skirt and, for ``t > 1``, the buffer of the first
    intermediate iterate (layout of ``ssam_window.cuh``)."""
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, M, steps = plan.N, plan.M, len(plan.steps)
    bz, bh, bw = (1,) * (3 - nd) + tuple(block)
    words = (steps * D * N + steps * D + steps + 3) & ~3

    def tile(k):
        return (bz + k * (D - 1)) * (bh + k * (N - 1)) * (bw + k * (M - 1))

    t = time_steps
    words += tile(t) + (tile(t - 1) if t > 1 else 0)
    return 4 * words


def default_block(plan: SystolicPlan, time_steps: int = 1) -> tuple[int, ...]:
    """The output tile of the block walk: four warp-widths of valid lanes
    across, 64 rows (2-D) or 16 rows by 8 slices (3-D), halved until a
    single-channel K1 block (K2 block, for an mxu plan) takes at most
    half of the shared memory. (The reduce paths tile their output
    themselves: K1 32 channels x 1 row x 128 columns, K2 64 x 1 x 128.)"""
    need = mxu_smem_bytes if plan.strategy == "mxu" else smem_bytes
    V = max(1, WARP - (plan.M - 1))
    if plan.ndim_spatial == 3:
        block = [8, 16, 2 * V]
    else:
        block = [64, 4 * V]
    while need(plan, block, time_steps) > SMEM_LIMIT // 2:
        i = max(range(len(block) - 1), key=lambda a: block[a])
        if block[i] == 1:
            break
        block[i] = max(1, block[i] // 2)
    return tuple(block)


# ---------------------------------------------------------------------------
# K2: the tensor-core kernel (strategy='mxu')
# ---------------------------------------------------------------------------

MXU_MAX_TAPS = 1024           # single-channel taps K2 holds (padded to 8)
# The reduce path's block: 64 output channels x 1 row x 128 columns, the
# GEMM's M x N tile; K = C_in·taps is staged MXU_CI_MAX channels at most.
MXU_CO_TILE = 64
MXU_COLS = 128
MXU_CI_MAX = 32
MXU_SMEM_TARGET = 64 * 1024


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


def mxu_smem_bytes(plan: SystolicPlan, block, time_steps: int) -> int:
    """Dynamic shared memory of one single-channel K2 block: the tap
    offsets and coefficients (taps padded to 8), the staged skirt and,
    for ``t > 1``, the buffer of the first intermediate iterate (layout
    of ``ssam_mxu.cu``)."""
    nd = plan.ndim_spatial
    D = plan.depth if nd == 3 else 1
    N, M = plan.N, plan.M
    bz, bh, bw = (1,) * (3 - nd) + tuple(block)
    taps = sum(len(st.taps) for st in plan.steps)

    def tile(k):
        return (bz + k * (D - 1)) * (bh + k * (N - 1)) * (bw + k * (M - 1))

    t = time_steps
    return 4 * (2 * _round8(taps) + tile(t) + (tile(t - 1) if t > 1 else 0))


@dataclasses.dataclass(frozen=True)
class MxuReduceLayout:
    """K2's reduce-path geometry: ``ci_t`` input channels staged per pass,
    ``kc`` the pass's contraction depth ``ci_t·taps`` padded to 8, ``lda``
    the row pitch of the staged filter tile (``≡ 4 mod 32``: the A
    fragment's 32 loads fall in 32 banks), ``span`` the staged columns of
    an input row, ``smem`` bytes."""

    ci_t: int
    kc: int
    lda: int
    span: int
    smem: int


def mxu_reduce_layout(plan: SystolicPlan, ntaps: int,
                      c_in: int) -> MxuReduceLayout:
    sw = plan.stride_per_axis()[1]
    span = (MXU_COLS - 1) * sw + plan.M

    def layout(ci_t):
        kc = _round8(ci_t * ntaps)
        lda = kc + (36 - kc % 32) % 32
        words = 2 * kc + MXU_CO_TILE * lda + ci_t * plan.N * span
        return MxuReduceLayout(ci_t, kc, lda, span, 4 * words)

    ci_t = max(1, min(MXU_CI_MAX, c_in))
    while ci_t > 1 and layout(ci_t).smem > MXU_SMEM_TARGET:
        ci_t -= 1
    lay = layout(ci_t)
    if lay.smem > SMEM_LIMIT:
        raise ValueError(f"K2's reduce block needs {lay.smem} bytes of "
                         f"shared memory (limit {SMEM_LIMIT})")
    return lay


class MxuKernel:
    """Wrapper of K2. ``launches`` counts the kernel launches it made: one
    per call, on the single-channel path (``ssam_mxu_window_launch``) and
    on the channel-reduce path (``ssam_mxu_reduce_launch``) alike."""

    name = "ssam_mxu"
    source = "src/repro_torch/csrc/ssam_mxu.cu"
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
        t, nd = time_steps, plan.ndim_spatial
        taps = mxu_tap_table(plan, None if w is None else tuple(w.shape))
        dtaps = _device_ints(taps, x.device)
        ntaps = len(taps) // 4
        if plan.coeff_mode == "dense":
            cvals = w.detach().to(torch.float32).contiguous()
        else:
            cvals = _device_floats(plan.coeffs, x.device)
        x, out, B, head, tile = _tile_launch(plan, x, block, t)
        smem = mxu_smem_bytes(plan, B, t)
        if smem > SMEM_LIMIT:
            raise ValueError(f"block {B} needs {smem} bytes of shared memory "
                             f"(limit {SMEM_LIMIT}); pass a smaller block")
        batch, ho, zo = head[0], head[5], head[4]
        if -(-ho // tile[1]) > 65535 or batch * -(-zo // tile[0]) > 65535:
            raise ValueError(f"K2's grid cannot hold {tuple(out.shape)} in "
                             f"blocks of {B}")
        err = self.library.get().ssam_mxu_window_launch(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
            cvals.data_ptr(), dtaps.data_ptr(), ntaps, _round8(ntaps), *head,
            plan.depth if nd == 3 else 1, plan.N, plan.M, t, *tile, smem,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K2 launch failed: CUDA error {err} "
                               f"({plan.kind}, block {B}, t={t})")
        self.launches += 1
        return out

    def _reduce(self, x, w, plan, epilogue_args):
        """The channel-reduce path: the implicit GEMM of ``w (C_out,
        C_in·taps)`` against the im2row operand of ``x (B, C_in, H, W)``,
        output stride and epilogue."""
        r = _reduce_launch("K2", plan, x, w, epilogue_args, MXU_CO_TILE)
        lay = mxu_reduce_layout(plan, r.ntaps, r.c_in)
        err = self.library.get().ssam_mxu_reduce_launch(
            *r.args, lay.ci_t, lay.kc, lay.lda, lay.span, lay.smem,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K2 launch failed: CUDA error {err} "
                               f"({plan.kind}, reduce {r.c_in} -> "
                               f"{w.shape[0]})")
        self.launches += 1
        return r.out if plan.batch_axes else r.out[0]


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
      epilogue_args: runtime operands of the plan's epilogue (a per-C_out
        bias row).
      strategy: pin the lowering for this call, ``'lanes'`` (K1) or
        ``'mxu'`` (K2, the im2row contraction on the tensor cores); None
        keeps whatever the plan carries. An mxu plan that K2 cannot run
        raises; it never retreats to K1.
    """
    if strategy is not None:
        plan = dataclasses.replace(plan, strategy=strategy)
    check_supported(plan, time_steps, variant)
    _check_operands(plan, x, w, epilogue_args)
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


# ---------------------------------------------------------------------------
# Backward-weight: the adjoint correlation (K3)
# ---------------------------------------------------------------------------

def _wgrad_operands(x, g, plan: SystolicPlan):
    """``x`` and ``g`` as ``(B, C_in, H, W)`` and ``(B, C_out, H', W')``,
    checked against the plan's geometry as the reference checks them."""
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
    if any(v > 1 for v in plan.stride_per_axis()):
        raise ValueError("scatter the cotangent of a strided plan into the "
                         "dense lattice and pass the stride-free plan")
    nb, nr = plan.batch_axes, plan.reduce_axes
    x4 = x if nb else x[None]
    x4 = x4 if nr else x4[:, None]
    g4 = g if nb else g[None]
    g4 = g4 if nr else g4[:, None]
    if x4.ndim != 4 or g4.ndim != 4 or x4.shape[0] != g4.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} do not "
                         f"fit the {plan.kind!r} plan")
    N, M = plan.exts
    lead, trail = plan.lead_trail()
    H, W = x4.shape[2:]
    Ho, Wo = g4.shape[2:]
    if (Ho, Wo) != (H + lead[0] + trail[0] - (N - 1),
                    W + lead[1] + trail[1] - (M - 1)):
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
    filter tap, ``dW[:, :, n, m] = Σ_{b,o} g[b, :, o]·xp[b, :, o + (n,
    m)]`` over the input padded by the plan's lead (and trail); per-lane
    plans ``dW[k, d] = Σ_{b,t} g[b,t,d]·xp[b,t+k,d]``. Returns fp32 (fp64
    for fp64 inputs), ``(N, M)``, ``(C_out, C_in, N, M)`` or ``(K, D)``."""
    if plan.coeff_mode == "perlane":
        return _wgrad_perlane_reference(x, g, plan)
    x4, g4 = _wgrad_operands(x, g, plan)
    acc = acc_dtype(x)
    N, M = plan.exts
    (ly, lx), _ = plan.lead_trail()
    H, W = x4.shape[2:]
    Ho, Wo = g4.shape[2:]
    xp = F.pad(x4.to(acc), (lx, Wo + M - 1 - lx - W, ly, Ho + N - 1 - ly - H))
    gf = g4.to(acc)
    out = xp.new_zeros((g4.shape[1], x4.shape[1], N, M))
    for n in range(N):
        for m in range(M):
            out[:, :, n, m] = torch.einsum(
                "bohw,bchw->oc", gf, xp[..., n:n + Ho, m:m + Wo])
    return out if plan.out_axes else out[0, 0]


WGRAD_POSITIONS = 64          # cotangent positions per staged chunk (K3)
WGRAD_THREADS = 256
WGRAD_TARGET_BLOCKS = 4 * 132  # enough blocks for every SM of an H100


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class WgradLayout:
    """K3's launch geometry: a block of 256 threads owns ``co_tile``
    output channels × ``rows_tile`` flattened ``(c_in, n, m)`` rows; its
    threads split as ``cg`` channel groups (``cr`` channels each) ×
    ``rg`` row groups (4 rows each) × ``ph`` position phases, whose
    partial sums the block adds in a fixed order. The cotangent's
    positions, in chunks of 64 along a row, split into ``slices``
    reduce slices (a second kernel adds their partials in order)."""

    cr: int
    cg: int
    rg: int
    ph: int
    grid: tuple[int, int, int]
    chunks: int
    slices: int
    span: int                  # input channels one block stages
    lp: int                    # staged columns per input row (odd)
    smem: int


def wgrad_layout(B, c_in, c_out, Ho, Wo, N, M) -> WgradLayout:
    rows = c_in * N * M
    cr = 4 if c_out > 1 else 1
    cg = min(8, _pow2_ceil(-(-c_out // cr)))
    rg = min(WGRAD_THREADS // cg, _pow2_ceil(-(-rows // 4)))
    ph = WGRAD_THREADS // (cg * rg)
    co_tile, rows_tile = cg * cr, 4 * rg
    grid_xy = (-(-rows // rows_tile), -(-c_out // co_tile))
    chunks = B * Ho * -(-Wo // WGRAD_POSITIONS)
    slices = max(1, min(chunks, -(-WGRAD_TARGET_BLOCKS
                                  // (grid_xy[0] * grid_xy[1]))))
    # channels a block's rows can touch (a tile may start mid-channel)
    span = min(c_in, rows_tile // (N * M) + 2)
    lp = (WGRAD_POSITIONS + M - 1) | 1
    staged = WGRAD_POSITIONS * co_tile + span * N * lp
    smem = 4 * max(staged, WGRAD_THREADS * cr * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K3 needs {smem} bytes of shared memory for a "
                         f"{N}x{M} filter (limit {SMEM_LIMIT})")
    if grid_xy[1] > 65535 or slices > 65535:
        raise ValueError(f"K3's grid cannot hold {c_out} channels")
    return WgradLayout(cr, cg, rg, ph, grid_xy + (slices,), chunks, slices,
                       span, lp, smem)


def _wgrad_geometry(x, g, plan: SystolicPlan):
    """K3's operands as 4-D tensors and its :func:`wgrad_layout`."""
    x4, g4 = _wgrad_operands(x, g, plan)
    B, Ci = x4.shape[:2]
    Co, Ho, Wo = g4.shape[1:]
    return x4, g4, wgrad_layout(B, Ci, Co, Ho, Wo, *plan.exts)


class WgradKernel:
    """Wrapper of K3. ``launches`` counts the kernel launches it made: one
    per gradient, or two when the reduction is split (the partial sums,
    then the pass that adds them; :meth:`launches_for`)."""

    name = "ssam_wgrad"
    source = "src/repro_torch/csrc/ssam_wgrad.cu"
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
        x4, g4, lay = _wgrad_geometry(x, g, plan)
        x4, g4 = x4.contiguous(), g4.contiguous()
        B, Ci, H, W = x4.shape
        Co, Ho, Wo = g4.shape[1:]
        N, M = plan.exts
        (ly, lx), _ = plan.lead_trail()
        out = torch.empty((Co, Ci, N, M), dtype=torch.float32,
                          device=x.device)
        part = (torch.empty((lay.slices, Co, Ci * N * M), dtype=torch.float32,
                            device=x.device) if lay.slices > 1 else out)
        err = self.library.get().ssam_wgrad_launch(
            x4.data_ptr(), g4.data_ptr(), int(x.dtype == torch.bfloat16),
            part.data_ptr(), out.data_ptr(), B, Ci, Co, H, W, Ho, Wo, N, M,
            ly, lx, lay.cr, lay.cg, lay.rg, lay.ph, *lay.grid, lay.chunks,
            lay.span, lay.lp, lay.smem,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"K3 launch failed: CUDA error {err} "
                               f"({plan.kind}, {Co}x{Ci}x{N}x{M})")
        self.launches += 1 + (lay.slices > 1)
        return out if plan.out_axes else out[0, 0]

    @staticmethod
    def launches_for(x, g, *, plan: SystolicPlan) -> int:
        """The launches one call on ``x`` and ``g`` makes (any device)."""
        return 1 + (_wgrad_geometry(x, g, plan)[2].slices > 1)


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
            "yet (ROADMAP Queue 1 item 4)")
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
