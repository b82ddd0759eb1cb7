"""SSAM plan formulation — the paper's four-tuple 𝒥 = (O, D, X, Y) (§3.4).

A :class:`SystolicPlan` is the static description of how a regular
memory-bound kernel executes on a software systolic array of ``S`` lanes
(GPU warp: S=32; TPU VREG lane axis: S=128):

* ``O`` (operations)  — the ``(⊗, ⊕)`` pair of Eq. 1, here fixed to
  (multiply, add) for convolution/stencil plans and exposed as the
  ``combine`` field for scan/recurrence plans.
* ``D`` (dependencies) — the ordered :class:`Step` list. Each step first
  *shifts* the partial-sum vector along the lane axis (the CUDA
  ``__shfl_up_sync`` of §4.4 / the TPU lane roll), then accumulates a set
  of *taps* — vertical, in-lane register reads (cheap direction of
  Fig. 1d).
* ``X`` / ``Y`` (inputs/outputs) — the register-cache geometry: each lane
  caches ``C = N + P − 1`` elements (Eq. 3) and produces ``P`` outputs by
  the sliding window of §4.2; a step's valid outputs live in lanes
  ``[M−1, S)`` (§4.4).

Plans are *data*: they are executed by :mod:`repro_torch.core.executor`
(plain torch, lane rolls) and by the windowed engine in
:mod:`repro_torch.core.engine`, which launches the hand-written CUDA
kernel for tensors on the card and runs the same block walk in plain
torch for tensors on the CPU. The modules in :mod:`repro_torch.kernels`
are thin plan builders over that engine.

This module is the PyTorch port's own copy of the JAX package's plan IR:
field for field the same dataclasses and builders, so a plan built here
compares equal (``dataclasses.astuple``) to the reference's. The ``S``
field keeps the reference's default of 128 lanes; the CUDA kernel maps
the lane axis onto 32-lane warps whatever ``S`` says.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

# Lane widths of the "warp" on each target. The paper's S is WarpSize=32;
# on TPU the natural systolic lane axis is the 128-wide VREG minor dim.
GPU_WARP_LANES = 32
TPU_VREG_LANES = 128

# Closed vocabulary of fusable elementwise epilogue stages (DESIGN.md §11).
# Applied in VMEM between the accumulator flush and the output store, so a
# conv→activation seam stops round-tripping HBM. The activations all fix 0
# (gelu(0) = silu(0) = relu(0) = s·0 = 0), so they sit *between* fused
# pipeline stages without disturbing the zero-boundary pad-once semantics.
# `bias` may also sit mid-chain: it applies to the whole pad-once
# intermediate, exactly matching the unfused per-stage fallback (though
# near the boundary both differ from per-op same-shape application, since
# bias(0) != 0). `residual_add` stays final-only — its operand is
# output-shaped and a mid-chain residual would have to materialize the
# intermediate it skips.
EPILOGUE_OPS = ("bias", "gelu", "silu", "relu", "scale", "residual_add")
# op → number of runtime operands it consumes from ``epilogue_args``.
EPILOGUE_OPERANDS = {"bias": 1, "residual_add": 1}


@dataclasses.dataclass(frozen=True)
class EpilogueStage:
    """One elementwise output stage: ``op`` from :data:`EPILOGUE_OPS`.

    ``value`` is the static operand of ``'scale'`` (compile-time, like a
    'table' coefficient); ``'bias'``/``'residual_add'`` take *runtime*
    operands from the ``epilogue_args`` of the engine call instead.
    """

    op: str
    value: float | None = None


def normalize_epilogue(epilogue) -> tuple[EpilogueStage, ...]:
    """Normalize user epilogue spec → ``tuple[EpilogueStage, ...]``.

    Accepts None, a single op name, an :class:`EpilogueStage`, a
    ``(op, value)`` pair, or any sequence of those. Unknown ops raise a
    named ``ValueError`` here — before any ``pallas_call``.
    """
    if epilogue is None:
        return ()
    if isinstance(epilogue, (str, EpilogueStage)):
        epilogue = (epilogue,)
    elif (isinstance(epilogue, tuple) and len(epilogue) == 2
          and isinstance(epilogue[0], str)
          and isinstance(epilogue[1], (int, float))):
        epilogue = (epilogue,)
    out = []
    for st in epilogue:
        if isinstance(st, str):
            st = EpilogueStage(st)
        elif isinstance(st, tuple):
            op, value = st
            st = EpilogueStage(op, float(value))
        if not isinstance(st, EpilogueStage) or st.op not in EPILOGUE_OPS:
            raise ValueError(
                f"unknown epilogue stage {st!r}: the fusable vocabulary is "
                f"{EPILOGUE_OPS} (DESIGN.md §11)")
        if st.op == "scale" and st.value is None:
            raise ValueError("epilogue stage 'scale' needs a static value: "
                             "pass ('scale', s)")
        if st.op != "scale" and st.value is not None:
            raise ValueError(
                f"epilogue stage {st.op!r} takes no static value (got "
                f"{st.value!r}); only 'scale' does — bias/residual operands "
                "ride in epilogue_args")
        out.append(st)
    return tuple(out)


def epilogue_operand_stages(
    stages: tuple[EpilogueStage, ...]
) -> tuple[EpilogueStage, ...]:
    """The subsequence of stages that consume a runtime operand, in order."""
    return tuple(st for st in stages if st.op in EPILOGUE_OPERANDS)


def chain_epilogue_operand_stages(plan) -> tuple[EpilogueStage, ...]:
    """Operand-bearing epilogue stages across a whole plan, in
    application order.

    For a fused pipeline this walks ``plan.stages`` — mid-chain ``bias``
    entries first, the final stage's operands last — which is the order
    the engine consumes ``epilogue_args``. For an unfused plan it equals
    ``epilogue_operand_stages(plan.epilogue)``.
    """
    if getattr(plan, "stages", ()):
        return tuple(st for s in plan.stages
                     for st in epilogue_operand_stages(s.epilogue))
    return epilogue_operand_stages(plan.epilogue)


@dataclasses.dataclass(frozen=True)
class Tap:
    """A vertical (in-lane) register read: ``data[window + row_offset] * coeff``.

    ``coeff_id`` indexes into the plan's coefficient table — for conv2d it
    is ``(row, col)`` into the filter; for stencils it is the index of the
    coefficient grouped into this column (Listing 2 groups {West},
    {North, Current, South}, {East}).

    ``z_offset`` is the depth (Z-slice) offset of the read for 3-D plans —
    on TPU the Z window is VREG-resident, so a Z tap is just another cheap
    vertical read (DESIGN.md §7.5); 2-D plans leave it at 0.
    """

    row_offset: int
    coeff_id: tuple[int, ...]
    z_offset: int = 0


@dataclasses.dataclass(frozen=True)
class Step:
    """One systolic cycle: shift partial sums ``shift`` lanes, then accumulate taps.

    ``shift`` encodes an edge set of the dependency graph ``D``: lane ``j``
    receives lane ``j - shift``'s partial result. ``masked`` marks steps whose
    ctrl() (Eq. 1) gates the shifted operand by lane index (Kogge–Stone scan
    arrows in Fig. 1e); convolution steps are unmasked because out-of-range
    lanes are halo lanes that are discarded anyway (§4.5).
    """

    shift: int
    taps: tuple[Tap, ...] = ()
    masked: bool = False


@dataclasses.dataclass(frozen=True)
class SystolicPlan:
    """Static schedule for one SSAM kernel — see module docstring.

    Beyond the paper's (O, D, X, Y) fields, a plan carries the geometry the
    generic lowering (:mod:`repro_torch.core.engine`) needs to run a plan
    without per-family code:

    * ``depth``/``ndim_spatial`` — footprint extent along Z and the number
      of windowed (blocked, overlapped) axes; the lane axis is always last.
    * ``batch_axes`` — leading axes iterated by the grid with block size 1
      (the depthwise-conv batch dimension). Batch axes appear on both the
      input and the output.
    * ``reduce_axes`` — leading input axes (after the batch axes)
      iterated by the grid with block size 1 whose partial results are
      **accumulated** rather than written separately: the engine carries
      an fp32 accumulator across the reduce iterates and writes the
      output on the last one. This is the §2 shift-psum dataflow applied
      across channels instead of lanes — each reduce iterate runs the
      plan's full tap schedule (the *channel-reduction tap group*) and
      ⊕-combines into the running block sum. The NCHW ``C_in`` axis.
    * ``out_axes`` — leading axes of the *output and the coefficient
      array* that the input lacks (the NCHW ``C_out``): iterated by the
      grid with block size 1, selecting which coefficient slice the tap
      group reads. Operand shapes for a reduce plan are therefore
      ``x: batch + reduce + spatial``, ``w: out + reduce + filter``,
      ``out: batch + out + spatial``.
    * ``lead``/``trail`` — semantic zero-padding per windowed axis applied
      ahead of / behind the data origin *per temporal iterate*: a stencil
      plan pads by its footprint (same-shape output), a causal conv pads
      ``K−1`` in front, a valid conv pads nothing (output shrinks).
    * ``coeffs``/``coeff_mode`` — where tap coefficients come from:
      ``'table'`` (compile-time immediates stored on the plan, §4.8),
      ``'dense'`` (a runtime filter array indexed by ``coeff_id``), or
      ``'perlane'`` (runtime per-lane coefficient rows, depthwise conv).
    """

    kind: str            # 'conv1d' | 'conv2d' | 'stencil2d' | 'stencil3d' | 'scan' | 'recurrence'
    S: int               # systolic array width (lanes)
    C: int               # register-cache depth per lane (Eq. 3)
    P: int               # outputs per lane (sliding-window length, §4.2)
    M: int               # horizontal extent of the dependency footprint (filter cols)
    N: int               # vertical extent (filter rows) — taps per column upper bound
    steps: tuple[Step, ...]
    combine: str = "fma"  # O of Eq. 1: 'fma' (r⊗x ⊕ s) or 'add' (scan) or 'linrec'
    depth: int = 1        # Z extent of the footprint (3-D plans)
    ndim_spatial: int = 2  # windowed axes (lane axis last): 2 or 3
    batch_axes: int = 0   # leading grid axes with block size 1 (x and out)
    reduce_axes: int = 0  # contracted leading x axes (fp32 grid accumulator)
    out_axes: int = 0     # leading out/coeff axes the input lacks (C_out)
    lead: tuple[int, ...] | None = None   # zero-pad ahead of origin per axis
    trail: tuple[int, ...] | None = None  # zero-pad behind the data per axis
    coeffs: tuple[float, ...] | None = None  # immediates for 'table' mode
    coeff_mode: str = "dense"  # 'table' | 'dense' | 'perlane'
    # ---- fused pipelines + output epilogues (DESIGN.md §11) ---------------
    epilogue: tuple[EpilogueStage, ...] = ()  # elementwise output stages
    stride: tuple[int, ...] | None = None  # output stride per windowed axis
    stages: tuple["SystolicPlan", ...] = ()  # fused chain (core.fuse); the
    #   top-level fields then carry the *composite* footprint/lead/trail
    # ---- lowering strategy (DESIGN.md §13) --------------------------------
    # How the engine executes the tap-set contraction per block:
    #   None     — auto: lanes unless the autotuner picks otherwise
    #   'lanes'  — the paper's VPU schedule (lane shifts + per-tap FMA)
    #   'mxu'    — im2row over the tap set in VMEM + one dot_general on
    #              the MXU (arxiv 2603.00477's answer to "do we need
    #              tensor cores for stencils?")
    # Adjoints and fused chains derive plans with dataclasses.replace, so
    # the strategy rides the plan IR unchanged through both.
    strategy: str | None = None

    # ---- X geometry: what the engine lowers from --------------------------
    @property
    def exts(self) -> tuple[int, ...]:
        """Footprint extent per windowed axis, lane axis last."""
        if self.ndim_spatial == 3:
            return (self.depth, self.N, self.M)
        return (self.N, self.M)

    def lead_trail(self) -> tuple[tuple[int, ...], tuple[int, ...]]:
        zeros = (0,) * self.ndim_spatial
        return (self.lead or zeros, self.trail or zeros)

    def stride_per_axis(self) -> tuple[int, ...]:
        """Output stride per windowed axis (1 = dense)."""
        return self.stride or (1,) * self.ndim_spatial

    def halo(self, time_steps: int = 1) -> tuple[int, ...]:
        """Input-over-output overlap per windowed axis — the §4.5 halo,
        widened ``time_steps``-fold under temporal blocking (§6.4). For a
        fused chain (``stages``) the top-level ``exts`` already carry the
        summed stage footprints, so the same expression yields the
        chain-widened halo (DESIGN.md §11)."""
        return tuple(time_steps * (e - 1) for e in self.exts)

    def out_shape(self, in_shape: tuple[int, ...], time_steps: int = 1) -> tuple[int, ...]:
        """Windowed-axes output shape: each valid application shrinks an
        axis by ``ext−1``, the lead/trail zero-pad grows it back, and an
        output stride subsamples what remains."""
        lead, trail = self.lead_trail()
        return tuple(
            (s + time_steps * (l + r) - time_steps * (e - 1) - 1) // v + 1
            for s, l, r, e, v in zip(in_shape, lead, trail, self.exts,
                                     self.stride_per_axis())
        )

    def block_in_shape(self, block: tuple[int, ...], time_steps: int = 1) -> tuple[int, ...]:
        """Overlapped input block for a given output block (§4.5):
        ``(b−1)·stride + 1 + halo`` per axis (stride 1 ⇒ ``b + halo``)."""
        return tuple(
            (b - 1) * v + 1 + h
            for b, h, v in zip(block, self.halo(time_steps),
                               self.stride_per_axis())
        )

    # ---- Y geometry -------------------------------------------------------
    @property
    def valid_lane_lo(self) -> int:
        """First lane holding a valid output (paper: laneId ≥ M−1)."""
        return self.M - 1

    @property
    def valid_lanes(self) -> int:
        """Valid outputs per window step per warp: S − M + 1 (§4.4)."""
        return self.S - self.M + 1

    @property
    def outputs_per_block(self) -> int:
        return self.valid_lanes * self.P

    # ---- redundancy analysis (§5.3) --------------------------------------
    def halo_ratio(self) -> float:
        """Exact fraction of loaded elements that are halo.

        The paper bounds this as HR_rc = (S·C − (S−M)(C−N)) / (S·C); we
        report the exact value 1 − (valid lanes × P)/(S·C).
        """
        loaded = self.S * self.C
        useful = self.valid_lanes * self.P
        return 1.0 - useful / loaded

    def halo_ratio_paper_bound(self) -> float:
        """The paper's §5.3 closed form (an upper-bound style estimate)."""
        s, c, m, n = self.S, self.C, self.M, self.N
        return (s * c - (s - m) * (c - n)) / (s * c)

    def shift_count(self) -> int:
        """Total lane shifts per window step (the (M−1)·T_shfl term of
        Eq. 4); summed over the chain for a fused plan."""
        if self.stages:
            return sum(s.shift_count() for s in self.stages)
        return sum(1 for st in self.steps if st.shift)

    def mads_per_output_window(self) -> int:
        """MAD ops per window step per lane (M·N for dense conv); summed
        over the chain for a fused plan — the §5 flop terms of the whole
        pipeline priced against a single load+store (DESIGN.md §11)."""
        if self.stages:
            return sum(s.mads_per_output_window() for s in self.stages)
        return sum(len(st.taps) for st in self.steps)

    def epilogue_op_count(self) -> int:
        """Total elementwise epilogue stages across the plan/chain."""
        n = len(self.epilogue)
        return n + sum(len(s.epilogue) for s in self.stages)

    def final_epilogue(self) -> tuple[EpilogueStage, ...]:
        """The epilogue applied at the output store: the last stage's for
        a fused chain, the plan's own otherwise (mid-chain epilogues are
        applied between stages inside the kernel)."""
        return self.stages[-1].epilogue if self.stages else self.epilogue


# ---------------------------------------------------------------------------
# Plan builders
# ---------------------------------------------------------------------------

def _check_origin_straddle(kind: str, bounds: tuple[tuple[int, int], ...]):
    """Stencil offsets must straddle the output point on every axis
    (lo ≤ 0 ≤ hi) — same-shape zero-boundary semantics need non-negative
    lead/trail padding. Caught here so the failure names the stencil
    instead of surfacing as a negative-pad error inside the jitted engine.
    """
    for axis, (lo, hi) in enumerate(bounds):
        if not (lo <= 0 <= hi):
            raise ValueError(
                f"{kind}: offsets must straddle the origin on every axis; "
                f"axis {axis} spans [{lo}, {hi}]")

def conv1d_plan(M: int, *, S: int = TPU_VREG_LANES, P: int = 1) -> SystolicPlan:
    """§3.5 motivating example: 1-D convolution of filter width M.

    One tap per step (N=1); the register cache holds C = P elements (the
    window slides along the lane axis, not the cache axis, for 1-D).
    """
    steps = tuple(
        Step(shift=1 if m > 0 else 0, taps=(Tap(0, (m,)),)) for m in range(M)
    )
    return SystolicPlan("conv1d", S=S, C=P, P=P, M=M, N=1, steps=steps)


def conv2d_plan(M: int, N: int, *, S: int = TPU_VREG_LANES, P: int = 4) -> SystolicPlan:
    """Listing 1: M×N filter → M shift-steps of N taps each; C = N + P − 1."""
    steps = tuple(
        Step(
            shift=1 if m > 0 else 0,
            taps=tuple(Tap(n, (n, m)) for n in range(N)),
        )
        for m in range(M)
    )
    return SystolicPlan("conv2d", S=S, C=N + P - 1, P=P, M=M, N=N, steps=steps)


def conv2d_same_plan(M: int, N: int, *, S: int = TPU_VREG_LANES, P: int = 4) -> SystolicPlan:
    """'Same'-mode conv2d: Listing 1's schedule with the centre-anchor
    boundary folded into the plan's lead/trail fields.

    Same steps/taps as :func:`conv2d_plan`; the ``(N−1)//2`` /
    ``(M−1)//2`` zero rows/cols a 'same' convolution needs around the
    domain become plan geometry instead of a manual ``jnp.pad`` — which
    makes the plan shape-preserving per axis (``lead+trail = ext−1``)
    and therefore shardable by a halo-exchange layer.
    """
    base = conv2d_plan(M, N, S=S, P=P)
    top, left = (N - 1) // 2, (M - 1) // 2
    return dataclasses.replace(
        base, lead=(top, left), trail=(N - 1 - top, M - 1 - left))


def conv2d_batched_plan(
    M: int, N: int, *, S: int = TPU_VREG_LANES, P: int = 4,
    mode: str = "valid",
) -> SystolicPlan:
    """A minibatch of single-channel images through Listing 1's schedule.

    Identical steps/taps to :func:`conv2d_plan`; the leading image axis
    becomes a block-1 grid axis (``batch_axes=1``), so a ``(B, H, W)``
    stack convolves against one ``(N, M)`` filter in a single engine
    call — no Python loop over images.
    """
    base = conv2d_same_plan(M, N, S=S, P=P) if mode == "same" \
        else conv2d_plan(M, N, S=S, P=P)
    return dataclasses.replace(base, batch_axes=1)


def conv2d_nchw_plan(
    B: int, C_in: int, C_out: int, M: int, N: int,
    *, S: int = TPU_VREG_LANES, P: int = 4, mode: str = "valid",
    groups: int = 1,
) -> SystolicPlan:
    """Batched multi-channel NCHW convolution — the paper's headline
    convolution workload (2.5× over NPP for general 2-D filters),
    expressed as reduction axes over Listing 1's schedule.

    The plan is :func:`conv2d_plan`'s M-step/N-tap schedule with three
    grid axes layered on top: the minibatch ``B`` (``batch_axes=1``),
    the output channel ``C_out`` (``out_axes=1`` — selects the
    ``w[c_out]`` coefficient slice per iterate) and the input channel
    ``C_in`` (``reduce_axes=1`` — the engine ⊕-accumulates the tap
    group's partial sums across iterates in an fp32 scratch block and
    writes the output on the last one). Operands:
    ``x (B, C_in, H, W)``, ``w (C_out, C_in, N, M)``,
    ``out (B, C_out, H', W')``.

    ``B``/``C_in``/``C_out`` are validated here but *not* baked into the
    frozen plan: the engine reads the grid extents off the operand
    shapes, so one plan signature covers every batch/channel count and
    the tuning sidecar's nearest-shape seeding keeps working across
    them (shapes carry B/C; the schedule does not need to).

    ``groups`` validates a grouped convolution (``lax``'s
    ``feature_group_count``): both channel counts must divide evenly.
    The returned plan describes ONE group's reduce sweep — its
    ``reduce_axes`` contraction covers the group's ``C_in/groups``
    slice; :func:`ops.conv2d` slices operands per group
    and runs this same plan over each (depthwise-2d is
    ``groups == C_in``).
    """
    for nm, v in (("B", B), ("C_in", C_in), ("C_out", C_out),
                  ("groups", groups)):
        if v < 1:
            raise ValueError(f"conv2d_nchw_plan: {nm} must be >= 1, got {v}")
    if C_in % groups or C_out % groups:
        raise ValueError(
            f"conv2d_nchw_plan: groups={groups} must divide both "
            f"C_in={C_in} and C_out={C_out} (per-group reduce slices)")
    base = conv2d_same_plan(M, N, S=S, P=P) if mode == "same" \
        else conv2d_plan(M, N, S=S, P=P)
    return dataclasses.replace(
        base, kind="conv2d_nchw", batch_axes=1, reduce_axes=1, out_axes=1)


def stencil2d_plan(
    offsets: Sequence[tuple[int, int]],
    *,
    coeffs: Sequence[float] | None = None,
    S: int = TPU_VREG_LANES,
    P: int = 4,
) -> SystolicPlan:
    """Listing 2 generalized: group stencil taps by column offset (dx).

    ``offsets`` are (dy, dx) pairs relative to the output point. The plan
    walks columns left→right (dx ascending), shifting partial sums once per
    column — {West}, {North,Current,South}, {East} for the 5-point stencil.
    """
    dys = [dy for dy, _ in offsets]
    dxs = [dx for _, dx in offsets]
    lo_dy, hi_dy = min(dys), max(dys)
    lo_dx, hi_dx = min(dxs), max(dxs)
    _check_origin_straddle("stencil2d", ((lo_dy, hi_dy), (lo_dx, hi_dx)))
    M = hi_dx - lo_dx + 1
    N = hi_dy - lo_dy + 1
    cols: dict[int, list[tuple[int, int]]] = {}
    for k, (dy, dx) in enumerate(offsets):
        cols.setdefault(dx - lo_dx, []).append((dy - lo_dy, k))
    steps = []
    for m in range(M):
        taps = tuple(Tap(row, (k,)) for row, k in sorted(cols.get(m, ())))
        steps.append(Step(shift=1 if m > 0 else 0, taps=taps))
    return SystolicPlan(
        "stencil2d", S=S, C=N + P - 1, P=P, M=M, N=N, steps=tuple(steps),
        lead=(-lo_dy, -lo_dx), trail=(hi_dy, hi_dx),
        coeffs=None if coeffs is None else tuple(float(c) for c in coeffs),
        coeff_mode="table",
    )


def stencil3d_plan(
    offsets: Sequence[tuple[int, int, int]],
    *,
    coeffs: Sequence[float] | None = None,
    S: int = TPU_VREG_LANES,
    P: int = 2,
) -> SystolicPlan:
    """§4.9: 3-D stencils. (dz, dy, dx) taps.

    The X–Y plane is handled exactly like :func:`stencil2d_plan`; the Z
    direction becomes additional *vertical* taps (in-lane register reads of
    the neighbouring Z-slices held in the same register cache). On GPU the
    paper spills Z-partials to shared memory (inter-warp); on TPU we keep
    the whole Z window in VREG-resident accumulators (DESIGN.md §7.5), so a
    3-D plan is structurally a 2-D plan whose taps carry a dz coordinate.
    """
    dzs = [o[0] for o in offsets]
    dys = [o[1] for o in offsets]
    dxs = [o[2] for o in offsets]
    lo_dz, hi_dz = min(dzs), max(dzs)
    lo_dy, hi_dy = min(dys), max(dys)
    lo_dx, hi_dx = min(dxs), max(dxs)
    _check_origin_straddle(
        "stencil3d", ((lo_dz, hi_dz), (lo_dy, hi_dy), (lo_dx, hi_dx)))
    M = hi_dx - lo_dx + 1
    N = hi_dy - lo_dy + 1
    depth = hi_dz - lo_dz + 1
    cols: dict[int, list[tuple[int, int, int]]] = {}
    for k, (dz, dy, dx) in enumerate(offsets):
        cols.setdefault(dx - lo_dx, []).append((dz - lo_dz, dy - lo_dy, k))
    steps = []
    for m in range(M):
        taps = tuple(
            Tap(row, (k,), z_offset=z) for z, row, k in sorted(cols.get(m, ()))
        )
        steps.append(Step(shift=1 if m > 0 else 0, taps=taps))
    return SystolicPlan(
        "stencil3d", S=S, C=N + P - 1, P=P, M=M, N=N, steps=tuple(steps),
        depth=depth, ndim_spatial=3,
        lead=(-lo_dz, -lo_dy, -lo_dx), trail=(hi_dz, hi_dy, hi_dx),
        coeffs=None if coeffs is None else tuple(float(c) for c in coeffs),
        coeff_mode="table",
    )


def depthwise_conv1d_plan(K: int, *, S: int = TPU_VREG_LANES) -> SystolicPlan:
    """Depthwise causal 1-D conv in the *D-optimal* SSAM mapping (§5.4).

    Channels ride the lane axis and time rides sublanes, so every tap is a
    vertical (in-lane, cheap) register read and no lane shifts are needed
    at all — M=1, N=K. Coefficients are per-lane rows of a runtime
    ``(K, D)`` filter (``coeff_mode='perlane'``). The leading batch axis is
    iterated by the grid (``batch_axes=1``); causality is the ``K−1`` lead
    zeros on the time axis.
    """
    taps = tuple(Tap(k, (k,)) for k in range(K))
    return SystolicPlan(
        "conv1d", S=S, C=K, P=1, M=1, N=K, steps=(Step(shift=0, taps=taps),),
        batch_axes=1, lead=(K - 1, 0), coeff_mode="perlane",
    )


def scan_plan(n: int, *, S: int | None = None) -> SystolicPlan:
    """§3.6: Kogge–Stone inclusive scan over ``n`` lanes (Fig. 1e).

    log2(n) masked steps with doubling shift; r ≡ 1 so steps carry no taps.
    """
    S = S or n
    assert n & (n - 1) == 0, "Kogge–Stone scan wants a power-of-two width"
    steps = tuple(Step(shift=1 << k, masked=True) for k in range(int(math.log2(n))))
    return SystolicPlan("scan", S=S, C=1, P=1, M=1, N=1, steps=steps, combine="add")


def linear_recurrence_plan(n: int, *, S: int | None = None) -> SystolicPlan:
    """Kogge–Stone over the associative operator of ``h_t = a_t·h_{t−1} + b_t``.

    (a₂,b₂)∘(a₁,b₁) = (a₁a₂, b₁a₂ + b₂). This is Eq. 1 with ⊗/⊕ acting on
    transfer pairs; it executes the RWKV6 WKV recurrence and the Mamba/Hymba
    selective-scan inner loop (DESIGN.md §3).
    """
    S = S or n
    assert n & (n - 1) == 0, "Kogge–Stone scan wants a power-of-two width"
    steps = tuple(Step(shift=1 << k, masked=True) for k in range(int(math.log2(n))))
    return SystolicPlan(
        "recurrence", S=S, C=1, P=1, M=1, N=1, steps=steps, combine="linrec"
    )
