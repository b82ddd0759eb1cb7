"""Public ops of the port: ``stencil`` and ``conv2d`` (windowed plans,
K1, or K2 under ``strategy='mxu'``, with gradients through the same
kernel and K3), ``conv1d_causal`` (K1's per-lane path, or K2's under
``strategy='mxu'``, gradients through the same kernel and K4) and the
scan family ``cumsum``, ``sat``,
``linear_recurrence``, ``linear_recurrence_carry`` and
``chunked_linear_recurrence`` (K5, gradients through K5 in reversed
time).

The device of the input decides the path: a CUDA tensor launches the
hand-written kernel, and a CPU tensor runs its plain torch version
(:func:`repro_torch.core.engine.run_window_plan_reference`,
:func:`repro_torch.core.engine.run_weight_grad_plan_reference`,
:func:`repro_torch.core.engine.run_scan_plan_reference`). Nothing falls
back: a CUDA failure raises. There is no autotuner, mesh, guard lattice
or device ``impl=`` switch; ``chunked_linear_recurrence``'s ``impl``
names the schedule, as in the reference.

The windowed ops are differentiable: :class:`WindowOp` is the
``torch.autograd.Function`` of the reference's ``_window_op`` custom VJP
(``ops.py:353-435``). Its backward recomputes the pre-activation with
the linear plan, differentiates the epilogue there (which also gives the
bias gradient), runs the weight-gradient correlation for ``dW`` (K3) on
the cotangent as the strided forward produced it, then runs the
input adjoint through the engine for ``dx``: a strided plan's dx phase
by phase on that cotangent, one launch of the forward's strategy's
kernel (K1, or K2 under ``strategy='mxu'``; ``engine.run_adjoint_phases``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..core import adjoint as adj
from ..core import engine as _engine
from ..core.plan import (SystolicPlan, epilogue_operand_stages,
                         linear_recurrence_plan, normalize_epilogue)
from . import ssam_conv1d as _c1
from . import ssam_conv2d as _c2
from . import ssam_scan as _sc
from . import ssam_stencil2d as _s2
from . import ssam_stencil3d as _s3
from .stencils import BENCHMARKS, StencilDef


@dataclasses.dataclass(frozen=True)
class WindowCfg:
    """Static configuration of one windowed engine call."""

    plan: SystolicPlan
    block: tuple[int, ...] | None = None
    time_steps: int = 1
    variant: str = "shift_psum"


def _run(cfg: WindowCfg, plan: SystolicPlan, x, w, epi=()):
    return _engine.run_window_plan(
        x, w, plan=plan, block=cfg.block, time_steps=cfg.time_steps,
        variant=cfg.variant, epilogue_args=tuple(epi))


def window_backward(cfg: WindowCfg, x, w, epi, g, *, need_x: bool = True,
                    need_w: bool = True):
    """``(dx, dw, depi)`` of ``y = run_window_plan(x, w, plan=cfg.plan,
    epilogue_args=epi)`` given the cotangent ``g``: the epilogue VJP at
    the recomputed pre-activation, then ``dW`` through the weight-gradient
    correlation of the (strided) linear plan on that cotangent (when
    ``need_w`` and the plan has runtime coefficients), then, for ``dx``
    (when ``need_x``), the input-adjoint plan; a strided plan's dx runs
    phase by phase on the cotangent as it is (K1, or K2 under the mxu
    strategy)."""
    plan = cfg.plan
    if cfg.time_steps != 1 and plan.coeff_mode != "table":
        raise ValueError(
            "gradients of temporally-blocked convolutions are not "
            "supported (the weight enters every fused iterate); stencil "
            "plans (compile-time coefficients) differentiate at any "
            "time_steps")
    depi = (None,) * len(epi)
    if plan.epilogue:
        plan = dataclasses.replace(plan, epilogue=())
        z = _run(cfg, plan, x, w)
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            aa = [a.detach().requires_grad_(True) for a in epi]
            y = adj.apply_epilogue(cfg.plan, zz, aa)
            grads = torch.autograd.grad(y, [zz, *aa], g.to(z.dtype))
        g, depi = grads[0], tuple(grads[1:])
    dx = dw = None
    if need_w and w is not None and plan.coeff_mode != "table":
        # on the cotangent as the strided forward produced it: the
        # reduction runs over the real positions only
        adj.record_lowering(adj.weight_adjoint_plan(plan).kind)
        dw = _engine.run_weight_grad_plan(x, g.to(x.dtype),
                                          plan=plan).to(w.dtype)
    if need_x:
        if any(v > 1 for v in plan.stride_per_axis()):
            # each output phase of dx from the taps that reach it, written
            # in place: no scatter, no inserted zeros multiplied (one launch
            # of the plan's strategy's kernel: K1, or K2 under mxu)
            adj.record_lowering("adj_" + plan.kind)
            nb = plan.batch_axes + plan.reduce_axes
            dx = _engine.run_adjoint_phases(
                g, adj.adjoint_coeff_array(plan, w), plan=plan,
                in_spatial=tuple(x.shape[nb:])).to(x.dtype)
            return dx, dw, depi
        aplan = adj.input_adjoint_plan(plan)
        adj.record_lowering(aplan.kind)
        dx = _run(cfg, aplan, g, adj.adjoint_coeff_array(plan, w)).to(x.dtype)
    return dx, dw, depi


class WindowOp(torch.autograd.Function):
    """A windowed engine call with its adjoint-plan backward."""

    @staticmethod
    def forward(ctx, cfg: WindowCfg, x, w, *epi):
        ctx.cfg = cfg
        ctx.save_for_backward(x, w, *epi)
        return _run(cfg, cfg.plan, x, w, epi)

    @staticmethod
    def backward(ctx, g):
        x, w, *epi = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, depi = window_backward(ctx.cfg, x, w, tuple(epi), g,
                                       need_x=need[1], need_w=need[2])
        return (None, dx, dw, *depi)


def _strategy_plan(plan: SystolicPlan, strategy, op: str) -> SystolicPlan:
    """Pin a lowering strategy onto the plan, as the reference's
    ``_strategy_plan`` does: the strategy lives on the plan, so the
    backward's plans (``dataclasses.replace`` of it) inherit it and an mxu
    forward transposes to an mxu dx. ``None``/``'auto'`` leave the plan as
    it is (lanes: the tuner that would choose is not ported)."""
    if strategy in (None, "auto"):
        return plan
    if strategy not in ("lanes", "mxu"):
        raise ValueError(
            f"ops.{op}: strategy must be 'lanes', 'mxu', 'auto' or None, "
            f"got {strategy!r}")
    return dataclasses.replace(plan, strategy=strategy)


def window_op(plan: SystolicPlan, x, w=None, epilogue_args=(), *, block=None,
              time_steps: int = 1, variant: str = "shift_psum"):
    """``run_window_plan`` under autograd (:class:`WindowOp`)."""
    cfg = WindowCfg(plan, None if block is None else tuple(block),
                    time_steps, variant)
    return WindowOp.apply(cfg, x, w, *epilogue_args)


def stencil(x: torch.Tensor, sdef: StencilDef | str, *, time_steps: int = 1,
            variant: str = "shift_psum", block=None, epilogue=None,
            epilogue_args=(), mesh=None,
            strategy: str | None = None) -> torch.Tensor:
    """Apply a Table-3 stencil ``time_steps`` times to an ``(H, W)`` or
    ``(D, H, W)`` grid (zero boundary, same shape, pad-once semantics).
    ``strategy='mxu'`` runs the im2row contraction (K2 on the card)
    instead of the lanes schedule (K1). ``epilogue=`` fuses elementwise
    stages into the kernel's store, applied once after the last of the
    ``time_steps`` applications: a scalar ``bias`` and a grid-shaped
    ``residual_add`` ride in ``epilogue_args``. Differentiable in ``x``
    (the input-adjoint plan, under the same strategy) and in the
    epilogue's operands."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded stencils are ROADMAP Queue 1 item 12")
    if isinstance(sdef, str):
        sdef = BENCHMARKS[sdef]
    if x.ndim != sdef.ndim:
        raise ValueError(f"{sdef.name} is {sdef.ndim}-D, x has shape "
                         f"{tuple(x.shape)}")
    mod = _s2 if sdef.ndim == 2 else _s3
    plan = _strategy_plan(mod.plan_for(sdef), strategy, "stencil")
    epi_stages = normalize_epilogue(epilogue)
    if epi_stages:
        plan = dataclasses.replace(plan, epilogue=epi_stages)
    return window_op(plan, x, None, tuple(epilogue_args), block=block,
                     time_steps=time_steps, variant=variant)


def _normalize_stride(stride):
    if stride is None:
        return None
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if len(stride) != 2 or any(int(v) != v or v < 1 for v in stride):
        raise ValueError(f"conv2d: stride must be two ints >= 1, got {stride}")
    stride = tuple(int(v) for v in stride)
    return None if stride == (1, 1) else stride


def _conv2d_grouped(x, w, *, groups, mode, variant, block, stride,
                    epilogue, epilogue_args, strategy):
    """Grouped NCHW conv as per-group reduce slices (the reference's
    ``_conv2d_grouped``): each group is an ordinary NCHW call on its
    ``(C_in/groups, C_out/groups)`` slice of the operands, one K1 launch
    (K2 under ``strategy='mxu'``) a group, and the group outputs are
    concatenated on C_out. A bias row and a residual are sliced per group
    along C_out. ``groups == C_in`` is depthwise 2-D."""
    if x.ndim != 4:
        raise ValueError(
            f"conv2d: groups={groups} needs a 4-D NCHW input against an "
            f"OIHW filter (grouped channels), got a {x.ndim}-D input")
    if w.ndim != 4:
        raise ValueError(
            f"conv2d: groups={groups} needs an OIHW "
            f"(C_out, C_in/groups, N, M) filter, got w shape "
            f"{tuple(w.shape)}")
    # the plan builder owns the named divisibility checks
    _c2.plan_for_nchw(x.shape, w.shape, mode, groups)
    stages = epilogue_operand_stages(normalize_epilogue(epilogue))
    args = tuple(epilogue_args)
    if len(args) != len(stages):
        raise ValueError(
            f"conv2d: epilogue {epilogue!r} needs {len(stages)} runtime "
            f"operand(s), got {len(args)}")
    Cg, Og = x.shape[1] // groups, w.shape[0] // groups
    outs = []
    for g in range(groups):
        o = slice(g * Og, (g + 1) * Og)
        args_g = tuple(arr[o] if st.op == "bias" and arr.ndim == 1
                       else arr[:, o] if st.op == "residual_add" else arr
                       for st, arr in zip(stages, args))
        outs.append(conv2d(x[:, g * Cg:(g + 1) * Cg], w[o], mode=mode,
                           variant=variant, block=block, stride=stride,
                           epilogue=epilogue, epilogue_args=args_g,
                           strategy=strategy))
    return torch.cat(outs, dim=1)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, mode: str = "same",
           variant: str = "shift_psum", block=None, groups: int = 1,
           stride=None, epilogue=None, epilogue_args=(),
           mesh=None, strategy: str | None = None) -> torch.Tensor:
    """2-D cross-correlation, by input rank:

    * ``(H, W)`` — one image against an ``(N, M)`` filter;
    * ``(B, H, W)`` — a stack of single-channel images against one
      ``(N, M)`` filter;
    * ``(B, C_in, H, W)`` — an NCHW minibatch against an OIHW
      ``(C_out, C_in, N, M)`` filter through the reduce-axes plan, with
      an fp32 accumulator across the channel reduction.

    ``mode`` is ``'same'`` (zero boundary, centre anchor) or ``'valid'``.
    ``stride=(sh, sw)`` computes only every ``s``-th output (the kernels
    read input ``l·s + cum`` for output ``l``; no dense pass), and
    ``epilogue=`` fuses elementwise output stages
    (``bias``/``gelu``/``silu``/``relu``/``scale``/``residual_add``)
    applied to the summed value before the store: a bias is a per-C_out
    row on NCHW inputs and a scalar otherwise, a residual is shaped like
    the output; both ride in ``epilogue_args``. ``groups=`` (NCHW only)
    runs a grouped convolution as per-group slices against a ``(C_out,
    C_in/groups, N, M)`` filter (``groups == C_in``: depthwise 2-D).
    ``strategy='mxu'`` pins the tap-set contraction to the im2row
    lowering (K2, the tensor cores; NCHW contracts over ``C_in·taps``),
    ``'lanes'`` or None to the lanes schedule (K1). Differentiable in
    ``x``, ``w`` and the epilogue's operands: ``dx`` under the same
    strategy, ``dW`` through K3.
    """
    if mesh is not None:
        raise NotImplementedError("sharded conv2d is ROADMAP Queue 1 item 12")
    if int(groups) != groups or groups < 1:
        raise ValueError(f"conv2d: groups must be an int >= 1, got {groups}")
    if mode not in ("same", "valid"):
        raise ValueError(
            f"conv2d: mode must be 'same' or 'valid', got {mode!r}")
    stride = _normalize_stride(stride)
    if groups != 1:
        return _conv2d_grouped(x, w, groups=int(groups), mode=mode,
                               variant=variant, block=block, stride=stride,
                               epilogue=epilogue,
                               epilogue_args=epilogue_args,
                               strategy=strategy)
    epi_stages = normalize_epilogue(epilogue)
    if x.ndim == 4:
        if w.ndim != 4:
            raise ValueError(
                f"conv2d on a 4-D NCHW input needs an OIHW "
                f"(C_out, C_in, N, M) filter, got w shape {tuple(w.shape)}")
        plan = _c2.plan_for_nchw(x.shape, w.shape, mode)
    else:
        if w.ndim != 2:
            raise ValueError(f"conv2d takes an (N, M) filter for (H, W) or "
                             f"(B, H, W) input, got w shape {tuple(w.shape)}")
        if x.ndim == 3:
            plan = _c2.plan_for_batched(tuple(w.shape), mode)
        elif x.ndim == 2:
            plan = _c2.plan_for(tuple(w.shape), mode)
        else:
            raise ValueError(f"conv2d takes (H, W), (B, H, W) or "
                             f"(B, C, H, W), got {tuple(x.shape)}")
    if stride is not None or epi_stages:
        plan = dataclasses.replace(plan, stride=stride, epilogue=epi_stages)
    plan = _strategy_plan(plan, strategy, "conv2d")
    return window_op(plan, x, w, tuple(epilogue_args), block=block,
                     variant=variant)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, *, epilogue=None,
                  epilogue_args=(), strategy: str | None = None,
                  block=None) -> torch.Tensor:
    """Depthwise causal conv through the D-optimal plan (§5.4):
    ``y[b,t,d] = Σ_k x[b, t−K+1+k, d]·w[k, d]`` for ``x (B, T, D)`` and
    ``w (K, D)``.

    ``epilogue=`` fuses elementwise output stages into the kernel:
    ``bias`` takes a per-channel ``(D,)`` row (channels are the plan's
    lanes), which is Mamba's ``conv → +b → silu`` seam with no store
    between the conv and the activation; ``residual_add`` takes an
    output-shaped operand. ``block`` is the plain version's ``(block_t,
    block_d)`` tile. On the card K1's per-lane path runs the forward and
    ``dx`` (the input-adjoint plan), K4 ``dW``; ``strategy='mxu'`` runs
    the forward and ``dx`` on K2's per-lane path instead (each lane's taps
    a Toeplitz band on the tensor cores, the reference's lane-batched
    mat-vec), ``dW`` still on K4. Differentiable in ``x``, ``w`` and the
    epilogue's operands.

    Unlike the plain version, K2's per-lane path multiplies every input
    step of a tile row's 16-step fragment by its band coefficient, zero
    or not: a non-finite ``x`` (or, for ``dx``, gradient) at step ``s``
    makes each output of the 8-step rows whose fragment holds ``s`` nan,
    up to 15 steps before the outputs its taps reach and 7 after, where
    the plain version's sum gives a non-finite value only where the taps
    reach ``s``.
    """
    if w.ndim != 2 or w.shape[-1] != x.shape[-1]:
        # checked before anything runs: the oracle would otherwise
        # broadcast a mismatched filter across channels
        raise ValueError(f"conv1d_causal: filter lanes {tuple(w.shape)} do "
                         f"not match input channels {tuple(x.shape)}")
    if x.ndim != 3:
        raise ValueError(f"conv1d_causal takes (B, T, D), got "
                         f"{tuple(x.shape)}")
    plan = _strategy_plan(_c1.plan_for(w.shape[0]), strategy,
                          "conv1d_causal")
    epi_stages = normalize_epilogue(epilogue)
    if epi_stages:
        plan = dataclasses.replace(plan, epilogue=epi_stages)
    return window_op(plan, x, w, tuple(epilogue_args),
                     block=block or _c1.BLOCK)


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


@dataclasses.dataclass(frozen=True)
class ScanCfg:
    """Static configuration of one scan-engine call: the plain version's
    ``(block_r, block_t)`` tile (K5 walks each row whatever the tile)."""

    block_r: int = SCAN_BLOCK[0]
    block_t: int = SCAN_BLOCK[1]


def _cumsum_run(cfg: ScanCfg, x):
    return _sc.cumsum(x, block_r=cfg.block_r, block_t=cfg.block_t)


def _linrec_run(cfg: ScanCfg, a, b, carry=None, return_carry=False):
    return _sc.linear_recurrence(a, b, block_r=cfg.block_r,
                                 block_t=cfg.block_t, carry=carry,
                                 return_carry=return_carry)


def _lambda(cfg: ScanCfg, a, g):
    """The adjoint state ``λ_t = g_t + a_{t+1}·λ_{t+1}``: the forward
    recurrence in reversed time through the same engine (K5 on the
    card)."""
    abar = adj.reversed_recurrence_coeffs(a)
    return adj.time_reversed(_linrec_run(
        cfg, adj.time_reversed(abar), adj.time_reversed(g.to(a.dtype))))


class CumsumOp(torch.autograd.Function):
    """The Kogge–Stone prefix sum; its transpose is the time-reversed scan
    (the reference's ``_cumsum_op``)."""

    @staticmethod
    def forward(ctx, cfg: ScanCfg, x):
        ctx.cfg = cfg
        return _cumsum_run(cfg, x)

    @staticmethod
    def backward(ctx, g):
        adj.record_lowering("adj_scan")
        return None, adj.time_reversed(_cumsum_run(ctx.cfg,
                                                   adj.time_reversed(g)))


class LinrecOp(torch.autograd.Function):
    """``h_t = a_t·h_{t−1} + b_t`` from a zero state, with the reference's
    ``_linrec_op`` VJP: ``db = λ``, ``da = λ·h_{t−1}``."""

    @staticmethod
    def forward(ctx, cfg: ScanCfg, a, b):
        ctx.cfg = cfg
        h = _linrec_run(cfg, a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        adj.record_lowering("adj_recurrence")
        lam = _lambda(ctx.cfg, a, g)
        acc = _engine.acc_dtype(a)
        da = (lam.to(acc) * adj.shifted_state(h).to(acc)).to(a.dtype)
        return None, da, lam.to(a.dtype)


class LinrecCarryOp(torch.autograd.Function):
    """One chunk of the streamed recurrence: ``(h, h_T)`` from the carry
    ``h0`` ``(R, 1)``, with the reference's ``_linrec_carry_op`` VJP: the
    carry-out cotangent folds into the last λ seed (``h_T`` is
    ``h[:, -1]``), λ runs reversed through the engine, and the carry-in
    cotangent ``a₀·λ₀`` leaves for the next-older chunk."""

    @staticmethod
    def forward(ctx, cfg: ScanCfg, a, b, h0):
        ctx.cfg = cfg
        h, hT = _linrec_run(cfg, a, b, carry=h0, return_carry=True)
        ctx.save_for_backward(a, h, h0)
        return h, hT

    @staticmethod
    def backward(ctx, g, gc):
        a, h, h0 = ctx.saved_tensors
        adj.record_lowering("adj_recurrence_chunk")
        acc = _engine.acc_dtype(a)
        g = g.to(acc, copy=True)           # the incoming cotangent stays
        g[..., -1:] += gc.to(acc).reshape(g.shape[:-1] + (1,))
        lam = _lambda(ctx.cfg, a, g)
        da = (lam.to(acc) * adj.shifted_state(h, h0).to(acc)).to(a.dtype)
        dh0 = adj.chunk_carry_cotangent(a, lam).to(h0.dtype).reshape(
            h0.shape)
        return None, da, lam.to(a.dtype), dh0


def cumsum(x: torch.Tensor, **kw) -> torch.Tensor:
    """Inclusive prefix sum along the last axis of ``(R, T)``;
    differentiable (the time-reversed scan)."""
    block_r, block_t = _scan_blocks("cumsum", kw)
    return CumsumOp.apply(ScanCfg(block_r, block_t), x)


def sat(x: torch.Tensor, **kw) -> torch.Tensor:
    """Summed-area table (§3.6): two passes of the Kogge–Stone cumsum —
    rows, then columns (the transposed rows)."""
    _reject_scan_kwargs("sat", kw)
    return cumsum(cumsum(x, **kw).T, **kw).T


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """h_t = a_t·h_{t−1} + b_t along the last axis of (R, T)-shaped a, b;
    differentiable in both (λ through the engine in reversed time)."""
    block_r, block_t = _scan_blocks("linear_recurrence", kw)
    return LinrecOp.apply(ScanCfg(block_r, block_t), a, b)


def linear_recurrence_carry(a: torch.Tensor, b: torch.Tensor,
                            h0: torch.Tensor, **kw):
    """``h_t = a_t·h_{t−1} + b_t`` over (R, T) rows with an explicit carry.

    Returns ``(h, h_T)``, ``h_T`` the final raw state ``(R, 1)``; ``h0``
    is ``(R,)`` or ``(R, 1)``. One chunk of the streamed schedule,
    differentiable through ``h`` and through the carry pair."""
    block_r, block_t = _scan_blocks("linear_recurrence_carry", kw)
    return LinrecCarryOp.apply(ScanCfg(block_r, block_t), a, b,
                               h0.reshape(a.shape[0], 1))


def chunked_linear_recurrence(a: torch.Tensor, b: torch.Tensor, *,
                              chunk: int = 128, impl: str = "engine",
                              **kw) -> torch.Tensor:
    """Same math as :func:`linear_recurrence`; a, b shaped (..., T).

    Leading axes flatten to the engine's rows. ``impl`` names the
    schedule: ``"engine"`` streams ``(R, chunk)`` slabs through the scan
    engine with the carry threaded between them (one K5 launch per slab
    on the card, each slab checkpointed under autograd);
    ``"engine_unchunked"`` runs all of T in one call. Both are
    differentiable.
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
        cfg = ScanCfg(block_r, min(block_t, chunk))
        grad = torch.is_grad_enabled() and (a.requires_grad
                                            or b.requires_grad)

        def step(a_c, b_c, carry):
            # Checkpointed under autograd (the reference's jax.checkpoint
            # per chunk): the backward keeps only the chunk-boundary
            # carries and re-runs each slab, so live state is O(R·chunk).
            if grad:
                return checkpoint(LinrecCarryOp.apply, cfg, a_c, b_c, carry,
                                  use_reentrant=False)
            return LinrecCarryOp.apply(cfg, a_c, b_c, carry)

        out = _engine.run_scan_plan_chunked(
            rows_a, rows_b, plan=linear_recurrence_plan(
                _sc._lane_tile(cfg.block_t, chunk)),
            chunk=chunk, block_r=block_r, step=step)
    else:
        block_r, block_t = _scan_blocks("chunked_linear_recurrence", kw,
                                        block_t=chunk)
        out = LinrecOp.apply(ScanCfg(block_r, block_t), rows_a, rows_b)
    return out.reshape(a.shape)
