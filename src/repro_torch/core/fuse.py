"""Fused plan pipelines: chain composition in the plan IR.

The port's copy of the JAX package's ``core/fuse.py`` (DESIGN.md §11).
The paper's §6.4 temporal blocking fuses ``t`` applications of the *same*
plan inside one block; :func:`fuse_plans` takes that from "same plan × t"
to a **plan list**: consecutive shape-preserving windowed plans compose
into one :class:`~repro_torch.core.plan.SystolicPlan` whose ``stages``
carry each stage's taps and coefficients and whose top-level footprint,
lead and trail are the *summed* stage geometry.

Because the composite is an ordinary plan, the layers below take chains
as they are: the engine walks ``plan.stages`` inside the block where
temporal blocking walked ``time_steps`` copies (K1 on the card keeps the
intermediate in shared memory, in fp32, and never writes it to HBM), and
the adjoint of a chain is the reversed chain of stage adjoints
(:func:`repro_torch.core.adjoint.input_adjoint_plan` recurses into
stages), so a linear chain differentiates through one fused backward
launch.

Legality (named errors, before anything launches):

* every stage is a windowed (``combine='fma'``) plan: scans carry a
  sequential inter-block carry;
* no stage has reduce/out axes: a channel reduction must finish its
  accumulator sweep before the next stage reads the summed output;
* no stage has per-lane coefficients or an output stride;
* every stage is shape-preserving per axis (``lead + trail = ext − 1``);
* epilogues between stages fix zero (gelu/silu/relu/scale) or are a
  ``bias``; ``residual_add`` is legal on the final stage only.

Semantics are pad-once (trapezoidal), shared with temporal blocking: the
domain is zero-padded once by the *summed* leads and trails, then the
stages apply as valid windows in order. Intermediates are not re-zeroed
at the domain edge, so a mid-chain ``bias`` shifts the halo positions
too; there fused and per-op same-shape application differ near the
boundary.
"""
from __future__ import annotations

import dataclasses

from .plan import SystolicPlan, epilogue_operand_stages


def _check_stage(i: int, p: SystolicPlan, n: int) -> None:
    tag = f"fuse_plans: stage {i} ({p.kind!r})"
    if p.strategy not in (None, "lanes", "mxu"):
        raise ValueError(
            f"{tag} has unknown lowering strategy {p.strategy!r}: expected "
            "None (auto), 'lanes' or 'mxu' (DESIGN.md §13)")
    if p.combine != "fma":
        raise ValueError(
            f"{tag} is a scan plan (combine={p.combine!r}); only windowed "
            "plans chain-fuse — scans carry a sequential inter-block carry")
    if p.stages:
        raise ValueError(f"{tag} is already a fused chain; flatten the "
                         "stage list instead of nesting pipelines")
    if p.reduce_axes or p.out_axes:
        raise ValueError(
            f"{tag} carries reduce/out axes: a channel reduction must "
            "complete its accumulator sweep before the next stage can read "
            "the summed output, so NCHW conv stages cannot chain-fuse — "
            "fuse their activation as an epilogue instead (DESIGN.md §11)")
    if p.coeff_mode == "perlane":
        raise ValueError(
            f"{tag} uses per-lane coefficients; depthwise plans do not "
            "chain-fuse (their lane axis is the channel axis)")
    if p.stride and any(v > 1 for v in p.stride):
        raise ValueError(
            f"{tag} is output-strided; a strided stage changes the domain "
            "extent mid-chain, so strides fuse only as the final engine "
            "call's own grid (unfused)")
    lead, trail = p.lead_trail()
    for a in range(p.ndim_spatial):
        if lead[a] + trail[a] != p.exts[a] - 1:
            raise ValueError(
                f"{tag} is not shape-preserving on axis {a} "
                f"(lead+trail={lead[a] + trail[a]} != ext-1="
                f"{p.exts[a] - 1}); only shape-preserving stages chain "
                "(for conv2d use mode='same')")
    if i < n - 1:
        bad = [s.op for s in epilogue_operand_stages(p.epilogue)
               if s.op != "bias"]
        if bad:
            raise ValueError(
                f"{tag} carries a residual_add epilogue ({bad}) mid-chain: "
                "the residual operand is output-shaped and would have to "
                "materialize the intermediate it skips, so residual_add is "
                "only legal on the final stage of a fused pipeline (bias "
                "may sit mid-chain)")


def summed_lead_trail(
    plans,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Per-axis (Σ lead, Σ trail) of a chain: the pad-once frame that the
    fused composite plan and the unfused sequence share."""
    nd = plans[0].ndim_spatial
    lead = tuple(sum(p.lead_trail()[0][a] for p in plans)
                 for a in range(nd))
    trail = tuple(sum(p.lead_trail()[1][a] for p in plans)
                  for a in range(nd))
    return lead, trail


def fuse_plans(*plans: SystolicPlan) -> SystolicPlan:
    """Compose consecutive windowed plans into one fused pipeline plan.

    ``fuse_plans(p1, p2, p3)`` runs ``p3(p2(p1(x)))`` as one engine call.
    The returned plan's ``stages`` are the inputs in application order;
    its top-level footprint, lead and trail are the summed stage
    geometry. One plan comes back as it is. Raises named
    ``ValueError``\\ s for chains that do not qualify (see the module
    docstring); ``ops.pipeline(fuse='auto')`` catches them and runs the
    unfused sequence.
    """
    if not plans:
        raise ValueError("fuse_plans needs at least one plan")
    if len(plans) == 1:
        return plans[0]
    head = plans[0]
    n = len(plans)
    for i, p in enumerate(plans):
        _check_stage(i, p, n)
        if p.ndim_spatial != head.ndim_spatial:
            raise ValueError(
                f"fuse_plans: stage {i} is {p.ndim_spatial}-D but stage 0 "
                f"is {head.ndim_spatial}-D; chains must share the domain")
        if p.S != head.S:
            raise ValueError(
                f"fuse_plans: stage {i} has lane width S={p.S} != {head.S}")
        if p.batch_axes != head.batch_axes:
            raise ValueError(
                f"fuse_plans: stage {i} has batch_axes={p.batch_axes} != "
                f"{head.batch_axes}; every stage must see the same batch")

    strategies = {p.strategy for p in plans if p.strategy is not None}
    if len(strategies) > 1:
        raise ValueError(
            "fuse_plans: stages pin conflicting lowering strategies "
            f"{sorted(strategies)}: the chain lowers as ONE kernel over a "
            "shared VMEM tile, so every stage must agree (pin one strategy "
            "for the whole chain, or leave stages on auto — DESIGN.md §13)")

    exts = tuple(
        1 + sum(p.exts[a] - 1 for p in plans)
        for a in range(head.ndim_spatial))
    lead, trail = summed_lead_trail(plans)
    if head.ndim_spatial == 3:
        depth, N, M = exts
    else:
        depth, (N, M) = 1, exts
    return dataclasses.replace(
        head,
        kind="pipe%d_%s" % (n, "+".join(p.kind for p in plans)),
        stages=tuple(plans),
        steps=(),                   # per-stage steps live on the stages
        M=M, N=N, depth=depth,
        C=N + head.P - 1,
        lead=lead if any(lead) else None,
        trail=trail if any(trail) else None,
        coeffs=None,
        coeff_mode="dense" if any(p.coeff_mode == "dense" for p in plans)
        else "table",
        epilogue=(),                # stage epilogues live on the stages
        # one pinned stage pins the chain (one kernel); else auto, each
        # stage then running as stage.strategy or the composite's
        strategy=strategies.pop() if strategies else None,
    )


def pipeline_coeff_count(plan: SystolicPlan) -> int:
    """Runtime coefficient operands a fused plan takes (one per 'dense'
    stage, in stage order); 0 or 1 for unfused plans."""
    if plan.stages:
        return sum(1 for s in plan.stages if s.coeff_mode == "dense")
    return 0 if plan.coeff_mode == "table" else 1


def stage_epilogue_args(plans, epilogue_args) -> list[tuple]:
    """Split a chain's ``epilogue_args`` (chain order: mid-chain biases
    first, the final stage's operands last) into one tuple a stage."""
    out, off = [], 0
    for p in plans:
        k = len(epilogue_operand_stages(p.epilogue))
        out.append(tuple(epilogue_args[off:off + k]))
        off += k
    return out
