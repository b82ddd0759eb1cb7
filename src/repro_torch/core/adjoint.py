"""Adjoint plans — the symbolic transposition of windowed plans.

The port's copy of the plan transforms of the JAX package's
``core/adjoint.py``, and of its epilogue replay in torch. Every windowed
op is linear in its data input (and, for convolutions, in its
coefficients), so its backward pass is again a windowed plan of the same
family:

* **backward-input** (:func:`input_adjoint_plan`): the forward computes
  ``y[o] = Σ_k xp[o + k]·c_k`` over the tap footprint ``k ∈ [0, ext)``
  with ``lead``/``trail`` origin padding. Its transpose is the same
  windowed form on the cotangent with the point-reflected tap set
  (``k → ext − 1 − k``, coefficients riding along) and the halo swapped
  through the footprint: ``lead' = ext − 1 − lead``,
  ``trail' = ext − 1 − trail``. For reduce plans (NCHW) the channel
  roles flip: the forward's out axis is the adjoint's reduction.
* **backward-weight** (:func:`weight_adjoint_plan`): the correlation
  ``∂L/∂c_k = Σ_o g[o]·xp[o + k]``, run by
  :func:`repro_torch.core.engine.run_weight_grad_plan` (K3 on the card).
  'table' plans (stencils) have no runtime coefficients and no weight
  gradient.

* **scan plans** transpose to the same scan in reversed time
  (:func:`time_reversed`): the adjoint state of ``h_t = a_t·h_{t−1} +
  b_t`` is ``λ_t = g_t + a_{t+1}·λ_{t+1}``, run through the same engine
  (K5 on the card) on :func:`reversed_recurrence_coeffs`; the
  coefficient gradient reads :func:`shifted_state`, and a streamed
  chunk's carry-in cotangent is :func:`chunk_carry_cotangent`.

The adjoint of an adjoint is the original plan. Backward lowerings are
counted in :data:`BACKWARD_LOWERINGS` (plan kind → count), so a test can
show that a gradient went through the engine.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterator

import torch
import torch.nn.functional as F

from .plan import Step, SystolicPlan, Tap

# kind → number of backward lowerings dispatched through the engine.
BACKWARD_LOWERINGS: collections.Counter = collections.Counter()


def record_lowering(kind: str) -> None:
    BACKWARD_LOWERINGS[kind] += 1


def reset_lowering_counts() -> None:
    BACKWARD_LOWERINGS.clear()


# ---------------------------------------------------------------------------
# Windowed plans: backward-input
# ---------------------------------------------------------------------------

def iter_tap_offsets(
    plan: SystolicPlan,
) -> Iterator[tuple[tuple[int, ...], tuple[int, ...]]]:
    """Yield ``(offset, coeff_id)`` per tap of a windowed plan.

    ``offset`` is the tap's read position relative to the output point's
    window origin, axes ordered like ``plan.exts`` (lane axis last); the
    lane coordinate is the cumulative partial-sum shift at the tap's step.
    """
    if plan.combine != "fma":
        raise ValueError(f"windowed plans only, got combine={plan.combine!r}")
    cum = 0
    for step in plan.steps:
        if step.masked:
            raise ValueError("windowed plans carry no masked steps")
        cum += step.shift
        for tap in step.taps:
            if plan.ndim_spatial == 3:
                yield (tap.z_offset, tap.row_offset, cum), tap.coeff_id
            else:
                yield (tap.row_offset, cum), tap.coeff_id


def _steps_from_offsets(
    taps: list[tuple[tuple[int, ...], tuple[int, ...]]], M: int
) -> tuple[Step, ...]:
    """Regroup footprint-coordinate taps into the engine's column steps."""
    cols: dict[int, list] = {}
    for off, cid in taps:
        if len(off) == 3:
            z, row, col = off
        else:
            z, (row, col) = 0, off
        cols.setdefault(col, []).append((z, row, cid))
    steps = []
    for m in range(M):
        col_taps = tuple(
            Tap(row, cid, z_offset=z) for z, row, cid in sorted(
                cols.get(m, ()), key=lambda t: (t[0], t[1])))
        steps.append(Step(shift=1 if m > 0 else 0, taps=col_taps))
    return tuple(steps)


def input_adjoint_plan(plan: SystolicPlan) -> SystolicPlan:
    """The backward-input plan: point-reflected taps, swapped halo.

    ``run_window_plan(g, adjoint_coeff_array(p, w),
    plan=input_adjoint_plan(p))`` computes ``∂L/∂x`` of
    ``y = run_window_plan(x, w, plan=p)`` given the cotangent ``g``. The
    adjoint is of the linear part only: any epilogue is stripped (the ops
    layer differentiates it at the recomputed pre-activation). A fused
    pipeline transposes to the reversed chain of its stage adjoints, again
    a fused plan, so a linear chain differentiates through one fused
    backward launch.
    """
    if plan.combine != "fma":
        raise ValueError(
            f"input_adjoint_plan wants a windowed plan, got combine="
            f"{plan.combine!r}; scan plans transpose to time-reversed "
            "scans (see reversed_recurrence_coeffs)")
    if any(v > 1 for v in plan.stride_per_axis()):
        raise ValueError(
            "the transpose of an output-strided plan is input-dilated, "
            "which is not a windowed plan; the ops layer dilates the "
            "cotangent and transposes the stride-free plan instead")
    # all-zero pads normalise to None (the builders' default), so that the
    # adjoint of an adjoint is identically the original plan
    norm = lambda t: t if any(t) else None
    exts = plan.exts
    lead, trail = plan.lead_trail()
    if plan.stages:
        # (P_k ∘ … ∘ P_1)ᵀ = P_1ᵀ ∘ … ∘ P_kᵀ, itself a fused plan. Stage
        # strategies ride unchanged; one pinned only on the composite is
        # pushed down, so the transposed chain stays on the same lowering.
        # The composite's frame transposes as a plan's does: a chain run in
        # valid mode (a segment of one no launch holds) transposes to
        # 'full'; a shape-preserving one to the frame fuse_plans sums.
        from .fuse import fuse_plans
        return dataclasses.replace(fuse_plans(*[
            input_adjoint_plan(dataclasses.replace(
                s, epilogue=(), strategy=s.strategy or plan.strategy))
            for s in reversed(plan.stages)]),
            lead=norm(tuple(e - 1 - l for e, l in zip(exts, lead))),
            trail=norm(tuple(e - 1 - r for e, r in zip(exts, trail))))
    reflected = [
        (tuple(e - 1 - o for e, o in zip(exts, off)), cid)
        for off, cid in iter_tap_offsets(plan)
    ]
    kind = plan.kind[4:] if plan.kind.startswith("adj_") else \
        "adj_" + plan.kind
    return dataclasses.replace(
        plan,
        kind=kind,
        steps=_steps_from_offsets(reflected, plan.M),
        lead=norm(tuple(e - 1 - l for e, l in zip(exts, lead))),
        trail=norm(tuple(e - 1 - r for e, r in zip(exts, trail))),
        reduce_axes=plan.out_axes,
        out_axes=plan.reduce_axes,
        epilogue=(),
    )


@dataclasses.dataclass(frozen=True)
class AdjointPhase:
    """One output phase of a strided plan's input adjoint.

    ``offset`` ``(py, px)``: the phase holds ``dx``'s positions ``(sh·q +
    py, sw·u + px)``. ``taps`` are ``(dr, dc, coeff_id)`` in the forward's
    plan order: ``dx[sh·q + py, sw·u + px]`` sums ``g[q + dr, u + dc]``
    times the adjoint coefficient at ``coeff_id`` (zero where ``g`` has no
    such position). ``plan`` is the same sum as a stride-1 windowed plan
    on ``g`` (taps at ``(dr, dc) + lead``, its own ``(N', M')`` footprint,
    coefficients read from :meth:`filter`), None for a phase no tap
    reaches: its ``dx`` is zero."""

    offset: tuple[int, int]
    stride: tuple[int, int]
    taps: tuple[tuple[int, int, tuple[int, ...]], ...]
    plan: SystolicPlan | None

    def extent(self, in_spatial) -> tuple[int, int]:
        """The phase's ``(rows, columns)`` in ``dx`` of spatial shape
        ``in_spatial``."""
        return tuple(max(0, -(-(n - p) // s)) for n, p, s in zip(
            in_spatial, self.offset, self.stride))

    def filter(self, wa):
        """The adjoint coefficient array ``wa`` (``adjoint_coeff_array``'s
        layout) gathered onto the phase plan's footprint, zeros where no
        tap sits."""
        p = self.plan
        (lr, lc), _ = p.lead_trail()
        out = wa.new_zeros(tuple(wa.shape[:-2]) + (p.N, p.M))
        for dr, dc, cid in self.taps:
            out[..., dr + lr, dc + lc] = wa[(...,) + tuple(cid)]
        return out


def strided_input_adjoint_phases(plan: SystolicPlan) -> tuple[AdjointPhase, ...]:
    """The input adjoint of an output-strided 2-D plan, phase by phase.

    For stride ``(sh, sw)`` the forward reads ``x[oy·sh + n − ly, ox·sw + m
    − lx]``, so ``dx`` splits into ``sh·sw`` output phases ``(py, px)``.
    On each axis a phase ``p`` receives exactly the taps ``m ≡ p + lead
    (mod s)``, each reading the cotangent at ``q + (p + lead − m)/s``
    (zero outside it), with the coefficient ``adjoint_coeff_array`` gives
    today. This is :func:`input_adjoint_plan` of the stride-free plan on
    the cotangent scattered onto the dense lattice, without the scatter
    and without multiplying the inserted zeros. Phases in row-major
    ``(py, px)`` order; a phase's taps in the forward's plan order.
    """
    if plan.combine != "fma" or plan.ndim_spatial != 2:
        raise ValueError("strided_input_adjoint_phases takes 2-D windowed "
                         f"plans, got {plan.kind!r}")
    if plan.stages:
        raise ValueError(
            "a fused pipeline has no strided input adjoint: fuse_plans "
            "refuses output-strided stages, so a chain is never strided "
            "(its adjoint is input_adjoint_plan's reversed chain)")
    stride = plan.stride_per_axis()
    (ly, lx), _ = plan.lead_trail()
    sh, sw = stride
    phases = []
    for py in range(sh):
        for px in range(sw):
            taps = tuple(((py + ly - n) // sh, (px + lx - m) // sw, cid)
                         for (n, m), cid in iter_tap_offsets(plan)
                         if (n - py - ly) % sh == 0
                         and (m - px - lx) % sw == 0)
            phases.append(AdjointPhase((py, px), stride, taps,
                                       _phase_plan(plan, taps)))
    return tuple(phases)


def _phase_plan(plan: SystolicPlan, taps) -> SystolicPlan | None:
    """The stride-1 windowed plan of one adjoint phase on the cotangent:
    its taps at ``(dr, dc) + lead``, ``lead`` the most negative offset
    (none positive), channel roles flipped as in the input adjoint."""
    if not taps:
        return None
    lr = max(0, -min(t[0] for t in taps))
    lc = max(0, -min(t[1] for t in taps))
    offs = [((dr + lr, dc + lc), (dr + lr, dc + lc)) for dr, dc, _ in taps]
    N = 1 + max(o[0] for o, _ in offs)
    M = 1 + max(o[1] for o, _ in offs)
    kind = plan.kind[4:] if plan.kind.startswith("adj_") else \
        "adj_" + plan.kind
    return dataclasses.replace(
        plan, kind=kind, N=N, M=M, C=N + plan.P - 1,
        steps=_steps_from_offsets(offs, M),
        lead=(lr, lc) if lr or lc else None, trail=None, stride=None,
        reduce_axes=plan.out_axes, out_axes=plan.reduce_axes, epilogue=())


def adjoint_coeff_array(plan: SystolicPlan, w):
    """The forward coefficient array in the adjoint plan's layout (out and
    reduce axes swapped); ``w`` itself for plans without them."""
    if w is None or not (plan.out_axes or plan.reduce_axes):
        return w
    no, nr = plan.out_axes, plan.reduce_axes
    perm = tuple(range(no, no + nr)) + tuple(range(no)) + tuple(
        range(no + nr, w.ndim))
    return w.permute(perm)


# ---------------------------------------------------------------------------
# Epilogues: the plain replay (its autograd gives the VJP)
# ---------------------------------------------------------------------------

def apply_epilogue(plan: SystolicPlan, y: torch.Tensor, args) -> torch.Tensor:
    """Replay a plan's epilogue stages on ``y`` in plain torch.

    The semantics of what K1 applies at the flush, and, differentiated by
    autograd at the recomputed pre-activation, the VJP of the epilogue
    chain. ``gelu`` is the tanh form (``jax.nn.gelu(approximate=True)``).
    A bias is per out channel ahead of the spatial axes for out-axes
    plans, per lane for perlane plans, per filter for a plan with a filter
    per image (image ``i`` of ``y`` takes ``bias[i mod filters]``), a
    scalar otherwise.
    """
    ai = 0
    for st in plan.epilogue:
        if st.op == "gelu":
            y = F.gelu(y, approximate="tanh")
        elif st.op == "silu":
            y = F.silu(y)
        elif st.op == "relu":
            y = torch.clamp_min(y, 0)
        elif st.op == "scale":
            y = y * st.value
        elif st.op == "bias":
            b = args[ai].to(y.dtype)
            ai += 1
            if plan.out_axes:
                b = b.reshape(b.shape + (1,) * plan.ndim_spatial)
            elif plan.filters > 1:      # image i's bias[i mod C]
                b = b.repeat(y.shape[0] // plan.filters).reshape(
                    (-1,) + (1,) * plan.ndim_spatial)
            y = y + b
        elif st.op == "residual_add":
            y = y + args[ai].to(y.dtype)
            ai += 1
        else:
            raise ValueError(st.op)
    return y


# ---------------------------------------------------------------------------
# Windowed plans: backward-weight
# ---------------------------------------------------------------------------

def weight_adjoint_plan(plan: SystolicPlan) -> SystolicPlan:
    """Descriptor plan of the backward-weight correlation: the forward
    schedule under a ``wgrad_``-prefixed kind. The lowering reads its
    extents off the operand shapes."""
    if plan.coeff_mode == "table":
        raise ValueError(
            f"{plan.kind!r} has compile-time 'table' coefficients — no "
            "runtime coefficient array, hence no weight gradient")
    return dataclasses.replace(plan, kind="wgrad_" + plan.kind)


# ---------------------------------------------------------------------------
# Scan plans: time reversal
# ---------------------------------------------------------------------------

def time_reversed(x: torch.Tensor) -> torch.Tensor:
    """Reverse the systolic time (lane) axis: the data movement of a
    transposed scan plan (the Kogge–Stone schedule itself is symmetric)."""
    return torch.flip(x, dims=(-1,))


def reversed_recurrence_coeffs(a: torch.Tensor) -> torch.Tensor:
    """Coefficients of the adjoint recurrence, in forward-time layout.

    The adjoint state of ``h_t = a_t·h_{t−1} + b_t`` obeys
    ``λ_t = g_t + a_{t+1}·λ_{t+1}`` (``λ`` at the last step = ``g``
    there): the same affine recurrence in reversed time with ``a``
    shifted one step toward the past. Returns ``ā_t = a_{t+1}`` (the
    identity 1 in the final slot); ``λ = rev(linrec(rev(ā), rev(g)))``.
    """
    return torch.cat([a[..., 1:], torch.ones_like(a[..., :1])], dim=-1)


def shifted_state(h: torch.Tensor, h0=None) -> torch.Tensor:
    """The ``h_{t−1}`` stream of ``∂a_t = λ_t·h_{t−1}``: ``h0`` (the carry
    entering the block, ``(..., 1)``; None: the zero initial state) ahead
    of ``h`` without its last step."""
    if h0 is None:
        h0 = torch.zeros_like(h[..., :1])
    return torch.cat([h0.to(h.dtype), h[..., :-1]], dim=-1)


def chunk_carry_cotangent(a: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Cotangent of a chunk's carry-in state: only the first step reads
    the carry, so ``∂L/∂h₋₁ = a₀·λ₀``. Streamed over chunks it flows
    backward as the next-older chunk's carry-out cotangent."""
    return a[..., :1] * lam[..., :1]
