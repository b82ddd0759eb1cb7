"""Halo geometry of windowed plans — one module, three consumers.

Everything about *how much extra input a windowed plan needs around an
output region* lives here, factored out of the engine so the same
arithmetic serves:

* :mod:`repro_torch.core.engine` — origin padding + overlapped-block
  halos for the plain block walk, and the in-place zero-filled reads of
  the CUDA kernel (§4.5 of the paper);
* a sharded execution layer (not yet ported) — the per-shard halo
  widths neighbouring devices must exchange, and the crop that maps a
  halo-extended engine output back to the local shard.

Two distinct "halos" appear and must not be conflated:

* the **block halo** ``t·(ext−1)`` per axis (``plan.halo(t)``) — the
  input-over-output overlap of adjacent engine blocks *within* one
  device; it is symmetric-free (all of it trails the block origin).
* the **shard halo** ``(t·lead, t·trail)`` per axis — the split of that
  same total into data that lies *before* vs *after* a shard's rows in
  the global domain. A shard needs ``t·lead`` rows from its low-side
  neighbor and ``t·trail`` from its high side; for shape-preserving
  plans ``lead + trail = ext − 1`` so the two views carry the same
  total, ``shard_halo_lo + shard_halo_hi = plan.halo(t)`` per axis.
"""
from __future__ import annotations

from .plan import SystolicPlan


def origin_pads(
    plan: SystolicPlan,
    spatial_in: tuple[int, ...],
    grid: tuple[int, ...],
    block: tuple[int, ...],
    time_steps: int = 1,
) -> list[tuple[int, int]]:
    """Per-windowed-axis (lo, hi) zero padding for the engine's input.

    ``t·lead`` zeros ahead of the origin (the plan's semantic boundary
    padding), then enough behind so every — including the last —
    overlapped input block of the ``grid × block`` tiling is in-bounds:
    the tiling reads ``(g·b − 1)·stride + 1 + halo`` input rows per axis
    (stride 1 ⇒ the familiar ``g·b + halo``). Fused chains need no case
    here: their composite ``exts``/``lead`` already carry the summed
    stage footprints (DESIGN.md §11).
    """
    lead, _ = plan.lead_trail()
    halo = plan.halo(time_steps)
    stride = plan.stride_per_axis()
    # A strided tiling can need *fewer* input rows than provided (the
    # stride skips the tail); clamp at zero — the surplus rows are
    # simply never read by any block.
    return [
        ((time_steps * l),
         max(0, (g * b - 1) * v + 1 + h - time_steps * l - s))
        for l, g, b, h, s, v in zip(lead, grid, block, halo, spatial_in,
                                    stride)
    ]


def shard_halo(
    plan: SystolicPlan, time_steps: int = 1
) -> tuple[tuple[int, int], ...]:
    """Per-axis (lo, hi) halo a shard must import from its neighbors.

    ``lo = t·lead`` rows ride in from the low-side neighbor (they sit
    *before* the shard's rows in the global domain), ``hi = t·trail``
    from the high side. Exchanging exactly these widths once per
    ``time_steps``-fused engine call — one engine-halo per temporal
    step, batched — reproduces the single-device pad-once semantics:
    domain-edge shards receive zeros from ``ppermute``'s unsourced
    links, which is exactly the engine's own origin padding.
    """
    lead, trail = plan.lead_trail()
    t = time_steps
    return tuple((t * l, t * r) for l, r in zip(lead, trail))


def is_shape_preserving(plan: SystolicPlan, axis: int) -> bool:
    """True when the plan keeps an axis's extent: ``lead+trail == ext−1``.

    Only such axes can be sharded — every shard then owns an equal slice
    of both the input and the output, so the ``shard_map`` output spec
    mirrors the input spec.
    """
    lead, trail = plan.lead_trail()
    return lead[axis] + trail[axis] == plan.exts[axis] - 1


def extended_crop(
    plan: SystolicPlan,
    time_steps: int,
    axis: int,
    local_extent: int,
) -> slice:
    """Slice mapping the engine's output on a halo-extended input back
    to the shard's own rows.

    Feeding ``[halo_lo | local | halo_hi]`` through the engine yields
    ``local + t·(lead+trail)`` output rows on a shape-preserving axis
    (the engine re-applies its origin padding outside the halo); the
    shard's rows start after the ``t·lead`` outputs that belong to the
    low-side neighbor.
    """
    lo, _ = shard_halo(plan, time_steps)[axis]
    return slice(lo, lo + local_extent)


def check_shard_geometry(
    plan: SystolicPlan,
    global_spatial: tuple[int, ...],
    mesh_per_axis: tuple[tuple[str, int] | None, ...],
    time_steps: int = 1,
) -> tuple[int, ...]:
    """Validate a sharding layout; return the shard-local spatial shape.

    ``mesh_per_axis[a]`` is ``(mesh_axis_name, size)`` for sharded
    domain axes, None for replicated ones. Raises ``ValueError`` — not
    an XLA shape error deep inside ``pallas_call`` — when a mesh axis
    does not divide its domain axis, when the halo is wider than the
    whole domain axis (no exchange schedule can source rows that do not
    exist), or when a sharded axis is not shape-preserving. A halo
    wider than one *shard* is fine: the exchange layer chains
    ``ppermute`` hops across as many neighbors as the width spans
    (``halo_exchange._multihop_slab``).
    """
    halos = shard_halo(plan, time_steps)
    local = []
    for a, (n, assign) in enumerate(zip(global_spatial, mesh_per_axis)):
        if assign is None:
            local.append(n)
            continue
        name, size = assign
        if not is_shape_preserving(plan, a):
            raise ValueError(
                f"cannot shard domain axis {a} of a {plan.kind!r} plan over "
                f"mesh axis {name!r}: the axis is not shape-preserving "
                f"(lead+trail={sum(plan.lead_trail()[i][a] for i in (0, 1))} "
                f"!= ext-1={plan.exts[a] - 1}), so shards would not own "
                "equal input and output slices")
        if n % size != 0:
            raise ValueError(
                f"mesh axis {name!r} (size {size}) does not divide domain "
                f"axis {a} (size {n}) for {plan.kind!r}; pad the domain or "
                "pick a mesh whose axis divides it")
        shard = n // size
        lo, hi = halos[a]
        if size > 1 and max(lo, hi) > n:
            raise ValueError(
                f"the plan's halo is wider than domain axis {a} itself: "
                f"time_steps={time_steps} needs a ({lo}, {hi}) halo but the "
                f"axis has only {n} rows in total; no exchange over mesh "
                f"axis {name!r} can source rows beyond the domain — shrink "
                "time_steps or grow the domain")
        local.append(shard)
    return tuple(local)
