"""Fused plan pipelines on the CPU, against the JAX package.

Mirrors the reference's ``tests/test_fused.py`` (``TestFusePlans``,
``TestPipelineEquivalence``, ``TestPipelineGradients`` and the pipeline
rejections): ``core/fuse.py``'s composite plans, legality errors and
chain adjoints equal the reference's pure plan functions
(``repro.core.fuse.fuse_plans``, ``repro.core.adjoint.input_adjoint_plan``);
``ops.pipeline`` fused and unfused equals the reference's
``ops.pipeline(impl="xla")`` (its ``_pipeline_ref``; the JAX windowed
engine is never called, ROADMAP R1) and its gradients ``jax.grad`` of
that form. K1's walk of a chain (``engine.emulate_window_kernel``) is
held to the plain version. Tolerance: fp32 ``rtol = 3e-5, atol =
3e-5·max|ref|`` (DESIGN.md §6), gradients 3e-5·max|leaf|, bf16 3e-2.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adjoint as jadj
from repro.core import fuse as jfuse
from repro.core import plan as jplan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssam_conv2d as jc2
from repro.kernels import ssam_stencil2d as js2
from repro.kernels import ssam_stencil3d as js3
from repro.kernels import stencils as jstencils
from repro_torch.core import adjoint, engine, fuse, plan
from repro_torch.kernels import ops, ssam_conv2d, ssam_stencil2d
from repro_torch.kernels import ssam_stencil3d, stencils

CUH = Path(engine.__file__).resolve().parents[1] / "csrc" / "ssam_window.cuh"


def _close(got, want, rtol=3e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _plans(names, port=True):
    """Stencil plans of ``names`` from the port's or the reference's
    builders."""
    out = []
    for n in names:
        sd = (stencils if port else jstencils).BENCHMARKS[n]
        if port:
            mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
        else:
            mod = js2 if sd.ndim == 2 else js3
        out.append(mod.plan_for(sd))
    return out


def _both(chain, w=None):
    """A descriptor chain for both packages: ``"W"`` stands for the filter
    ``w`` (numpy), tuples carry epilogues."""
    def conv(desc, mk):
        if isinstance(desc, tuple):
            return (conv(desc[0], mk), desc[1])
        return mk(w) if isinstance(desc, str) and desc == "W" else desc
    return ([conv(d, torch.from_numpy) for d in chain],
            [conv(d, jnp.asarray) for d in chain])


# ---------------------------------------------------------------------------
# fuse_plans: composite geometry and plan algebra
# ---------------------------------------------------------------------------

CHAINS = [["2d5pt", "2d9pt", "2d5pt"], ["2d9pt", "2d25pt"],
          ["3d7pt", "3d27pt"], ["3d7pt", "3d125pt", "poisson"],
          ["2d5pt"] * 3]


@pytest.mark.parametrize("names", CHAINS, ids=str)
def test_composite_plan_matches_reference(names):
    got = fuse.fuse_plans(*_plans(names))
    want = jfuse.fuse_plans(*_plans(names, port=False))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert fuse.summed_lead_trail(got.stages) == jfuse.summed_lead_trail(
        want.stages)
    assert fuse.pipeline_coeff_count(got) == jfuse.pipeline_coeff_count(want)


def test_composite_geometry():
    p5, p9 = _plans(["2d5pt", "2d9pt"])
    f = fuse.fuse_plans(p5, p9, p5)
    assert f.exts == (9, 9) and f.halo(1) == (8, 8)
    assert f.lead_trail() == ((4, 4), (4, 4))
    assert f.out_shape((64, 64)) == (64, 64)
    assert f.mads_per_output_window() == (
        2 * p5.mads_per_output_window() + p9.mads_per_output_window())
    assert fuse.fuse_plans(p5) is p5
    # a conv stage makes the chain 'dense' with one coefficient operand
    c = fuse.fuse_plans(p5, ssam_conv2d.plan_for((3, 5), "same"), p9)
    jc = jfuse.fuse_plans(*_plans(["2d5pt"], False),
                          jc2.plan_for((3, 5), "same"),
                          *_plans(["2d9pt"], False))
    assert dataclasses.astuple(c) == dataclasses.astuple(jc)
    assert c.coeff_mode == "dense" and fuse.pipeline_coeff_count(c) == 1


def test_strategy_pins_the_chain():
    p5, p9 = _plans(["2d5pt", "2d9pt"])
    mxu = dataclasses.replace(p9, strategy="mxu")
    assert fuse.fuse_plans(p5, mxu).strategy == "mxu"
    assert fuse.fuse_plans(p5, p9).strategy is None
    lanes = dataclasses.replace(p5, strategy="lanes")
    with pytest.raises(ValueError) as got:
        fuse.fuse_plans(lanes, mxu)
    j5, j9 = _plans(["2d5pt", "2d9pt"], port=False)
    with pytest.raises(ValueError) as want:
        jfuse.fuse_plans(dataclasses.replace(j5, strategy="lanes"),
                         dataclasses.replace(j9, strategy="mxu"))
    assert str(got.value) == str(want.value)


def _illegal(pk):
    """The reference's legality cases, built with the package ``pk``'s
    plan module (port or reference) and stencil plans."""
    p5 = _plans(["2d5pt"], port=pk is plan)[0]
    p3d = _plans(["3d7pt"], port=pk is plan)[0]
    return {
        "reduce": (p5, pk.conv2d_nchw_plan(1, 2, 2, 3, 3, mode="same")),
        "shape": (p5, pk.conv2d_plan(3, 3)),
        "scan": (p5, pk.scan_plan(128)),
        "perlane": (pk.depthwise_conv1d_plan(4),
                    pk.depthwise_conv1d_plan(4)),
        "mid-residual": (dataclasses.replace(
            p5, epilogue=pk.normalize_epilogue("residual_add")), p5),
        "strided": (p5, dataclasses.replace(
            pk.conv2d_same_plan(3, 3), stride=(2, 2))),
        "rank": (p5, p3d),
        "batch": (p5, dataclasses.replace(p5, batch_axes=1)),
        "strategy": (p5, dataclasses.replace(p5, strategy="tpu")),
    }


@pytest.mark.parametrize("case", sorted(_illegal(plan)))
def test_fuse_legality_errors_match_reference(case):
    with pytest.raises(ValueError) as got:
        fuse.fuse_plans(*_illegal(plan)[case])
    with pytest.raises(ValueError) as want:
        jfuse.fuse_plans(*_illegal(jplan)[case])
    assert str(got.value) == str(want.value)
    nested = fuse.fuse_plans(*_plans(["2d5pt", "2d5pt"]))
    with pytest.raises(ValueError, match="already a fused chain"):
        fuse.fuse_plans(nested, _plans(["2d5pt"])[0])
    with pytest.raises(ValueError, match="at least one plan"):
        fuse.fuse_plans()


def test_mid_chain_bias_is_legal():
    p5 = _plans(["2d5pt"])[0]
    biased = dataclasses.replace(p5, epilogue=plan.normalize_epilogue("bias"))
    fused = fuse.fuse_plans(biased, p5)
    assert fused.stages[0].epilogue[0].op == "bias"
    assert fused.epilogue == () and fused.final_epilogue() == ()


def test_adjoint_of_chain_is_reversed_stage_adjoints():
    p5, p9 = _plans(["2d5pt", "2d9pt"])
    f = fuse.fuse_plans(p5, dataclasses.replace(
        p9, epilogue=plan.normalize_epilogue("gelu")))
    af = adjoint.input_adjoint_plan(f)
    assert af.stages == (adjoint.input_adjoint_plan(p9),
                         adjoint.input_adjoint_plan(p5))
    assert adjoint.input_adjoint_plan(af) == fuse.fuse_plans(p5, p9)
    j5, j9 = _plans(["2d5pt", "2d9pt"], port=False)
    jf = jfuse.fuse_plans(j5, dataclasses.replace(
        j9, epilogue=jplan.normalize_epilogue("gelu")))
    assert dataclasses.astuple(af) == dataclasses.astuple(
        jadj.input_adjoint_plan(jf))
    # a strategy pinned only on the composite is pushed down to the stages
    pinned = dataclasses.replace(fuse.fuse_plans(p5, p9), strategy="mxu")
    ap = adjoint.input_adjoint_plan(pinned)
    assert ap.strategy == "mxu" and all(s.strategy == "mxu"
                                        for s in ap.stages)
    # strided phases refuse a chain, naming the real reason
    with pytest.raises(ValueError, match="never strided"):
        adjoint.strided_input_adjoint_phases(f)


# ---------------------------------------------------------------------------
# ops.pipeline: argument errors
# ---------------------------------------------------------------------------

def test_pipeline_rejections():
    x = torch.from_numpy(_x((16, 32), 1))
    with pytest.raises(ValueError, match="OIHW"):
        ops.pipeline(x, ["2d5pt", torch.zeros(2, 2, 3, 3)])
    with pytest.raises(ValueError, match="unknown stencil"):
        ops.pipeline(x, ["nope"])
    with pytest.raises(ValueError, match="mid-chain"):
        ops.pipeline(x, [("2d5pt", "residual_add"), "2d9pt"],
                     epilogue_args=(x,))
    with pytest.raises(ValueError, match="scalar"):
        ops.pipeline(x, [("2d5pt", "bias"), "2d9pt"],
                     epilogue_args=(torch.ones(32),))
    with pytest.raises(ValueError, match="is 3-D"):
        ops.pipeline(x, ["3d7pt"])
    with pytest.raises(ValueError, match="at least one stage"):
        ops.pipeline(x, [])
    with pytest.raises(ValueError, match="fuse must be"):
        ops.pipeline(x, ["2d5pt"], fuse="maybe")
    with pytest.raises(ValueError, match="not a stencil"):
        ops.pipeline(x, [lambda: None])
    with pytest.raises(ValueError, match="runtime operand"):
        ops.pipeline(x, [("2d5pt", "bias"), "2d9pt"])
    with pytest.raises(ValueError, match="2-D .N, M. array"):
        ops.pipeline(x, [torch.zeros(3)])
    with pytest.raises(ValueError, match="output-shaped"):
        ops.pipeline(x, ["2d5pt", ("2d9pt", "residual_add")],
                     epilogue_args=(torch.zeros(16, 31),))
    with pytest.raises(ValueError, match="scalar"):
        ops.pipeline(x, ["2d5pt", ("2d9pt", "bias")],
                     epilogue_args=(torch.zeros(3),))
    x3 = torch.from_numpy(_x((4, 16, 32), 2))
    with pytest.raises(ValueError, match="same trailing spatial axes"):
        ops.pipeline(x3, ["3d7pt", "2d5pt"])
    with pytest.raises(ValueError, match="strategy must be"):
        ops.pipeline(x, ["2d5pt"], strategy="tpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        ops.pipeline(x, ["2d5pt"], mesh=object())


def test_pipeline_rejections_match_reference():
    """The reference's messages, word for word, on the same bad calls."""
    xn = _x((16, 32), 3)
    x, xj = torch.from_numpy(xn), jnp.asarray(xn)
    bad = [
        (["2d5pt", "W4"], ()), (["nope"], ()), (["3d7pt"], ()),
        ([("2d5pt", "residual_add"), "2d9pt"], ("X",)),
        ([("2d5pt", "bias"), "2d9pt"], ("V",)),
        ([("2d5pt", "bias"), "2d9pt"], ()),
    ]
    for chain, args in bad:
        def port(d):
            if isinstance(d, tuple):
                return (port(d[0]), d[1])
            return torch.zeros(2, 2, 3, 3) if d == "W4" else d

        def ref(d):
            if isinstance(d, tuple):
                return (ref(d[0]), d[1])
            return jnp.zeros((2, 2, 3, 3)) if d == "W4" else d
        pa = tuple(x if a == "X" else torch.ones(32) for a in args)
        ja = tuple(xj if a == "X" else jnp.ones((32,)) for a in args)
        with pytest.raises(ValueError) as got:
            ops.pipeline(x, [port(d) for d in chain], epilogue_args=pa)
        with pytest.raises(ValueError) as want:
            jops.pipeline(xj, [ref(d) for d in chain], impl="xla",
                          epilogue_args=ja)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Fused and unfused against the reference's oracle
# ---------------------------------------------------------------------------

EQUIV = [
    ("2d", (40, 72), ["2d5pt", "2d9pt", "2d5pt"], ()),
    ("2d-wide", (40, 72), ["2d9pt", "2d25pt"], ()),
    ("2d-gelu", (40, 72), ["2d5pt", ("2d9pt", "gelu"), "2d5pt"], ()),
    ("2d-relu-scale", (40, 72),
     [("2d5pt", "relu"), ("2d5pt", ("scale", 0.5)), "2d9pt"], ()),
    ("3d", (10, 14, 40), ["3d7pt", "poisson"], ()),
    ("3d-mixed", (9, 12, 30), ["3d7pt", "3d125pt"], ()),
    ("batched", (3, 24, 40), ["2d5pt", "2d9pt"], ()),
    ("nchw", (2, 3, 20, 36), ["2d5pt", ("W", "gelu")], ()),
    ("conv", (32, 64), [("2d5pt", "gelu"), "W"], ()),
    ("final-bias-residual", (24, 48),
     ["2d5pt", ("2d9pt", ("bias", "gelu", "residual_add"))], ("b", "r")),
    ("mid-bias", (24, 48), [("2d5pt", ("bias", "gelu")), ("2d9pt", "bias")],
     ("b", "b")),
    ("conv-mid-bias-residual", (30, 50),
     [("W", ("bias", "gelu")), ("2d9pt", "bias"), ("W", "residual_add")],
     ("b", "b", "r")),
]


def _epi(codes, shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape if c == "r" else (1,)).astype(
        np.float32) for c in codes)


@pytest.mark.parametrize("variant", engine.VARIANTS)
@pytest.mark.parametrize("case", EQUIV, ids=lambda c: c[0])
def test_fused_unfused_and_reference_agree(case, variant):
    tag, shape, chain, codes = case
    xn = _x(shape, 4)
    w = _x((3, 5), 5)
    pc, jc = _both(chain, w)
    args = _epi(codes, shape, 6)
    pa = tuple(map(torch.from_numpy, args))
    want = jops.pipeline(jnp.asarray(xn), jc, impl="xla",
                         epilogue_args=tuple(map(jnp.asarray, args)))
    x = torch.from_numpy(xn)
    fused = ops.pipeline(x, pc, fuse=True, variant=variant, epilogue_args=pa)
    unfused = ops.pipeline(x, pc, fuse=False, variant=variant,
                           epilogue_args=pa)
    _close(fused, want)
    _close(unfused, want)


def test_mxu_chain_runs_its_plain_version_on_the_cpu():
    xn = _x((40, 72), 7)
    chain = ["2d5pt", ("2d9pt", "gelu"), "2d5pt"]
    got = ops.pipeline(torch.from_numpy(xn), chain, strategy="mxu")
    _close(got, jops.pipeline(jnp.asarray(xn), chain, impl="xla"))


def test_homogeneous_chain_is_temporal_blocking():
    xn = _x((24, 48), 8)
    x = torch.from_numpy(xn)
    got = ops.pipeline(x, ["2d5pt"] * 3)
    torch.testing.assert_close(got, ops.stencil(x, "2d5pt", time_steps=3),
                               rtol=0, atol=0)
    _close(got, jref.stencil_iterate(jnp.asarray(xn),
                                     jstencils.BENCHMARKS["2d5pt"], 3))


def test_interior_matches_per_op_loop():
    """Pad-once chains agree with per-op same-shape calls at distance >
    Σ radius from the boundary; a mid-chain bias also shifts the halo, so
    there it differs near the boundary but stays the reference's."""
    xn = _x((40, 64), 9)
    x = torch.from_numpy(xn)
    fused = ops.pipeline(x, ["2d5pt", "2d9pt"])
    loop = ops.stencil(ops.stencil(x, "2d5pt"), "2d9pt")
    r = 3                                   # Σ radius = 1 + 2
    _close(fused[r:-r, r:-r], loop[r:-r, r:-r].numpy())
    b = torch.tensor([2.0])
    biased = ops.pipeline(x, [("2d5pt", "bias"), "2d9pt"], epilogue_args=(b,))
    per_op = ops.stencil(ops.stencil(x, "2d5pt", epilogue="bias",
                                     epilogue_args=(b,)), "2d9pt")
    _close(biased[r:-r, r:-r], per_op[r:-r, r:-r].numpy())
    assert (biased[0] - per_op[0]).abs().max() > 0.1
    _close(biased, jops.pipeline(jnp.asarray(xn), [("2d5pt", "bias"),
                                                   "2d9pt"], impl="xla",
                                 epilogue_args=(jnp.asarray([2.0]),)))


def test_bf16_fused_and_unfused_each_to_their_own():
    """Fused keeps the intermediates fp32 (as the reference's xb stays in
    acc_dtype); unfused rounds to bf16 between stages: each at 3e-2."""
    xn = _x((40, 72), 10)
    chain = ["2d5pt", ("2d9pt", "gelu"), "2d5pt"]
    xb = torch.from_numpy(xn).to(torch.bfloat16)
    fused = ops.pipeline(xb, chain)
    unfused = ops.pipeline(xb, chain, fuse=False)
    assert fused.dtype == unfused.dtype == torch.bfloat16
    want = jops.pipeline(jnp.asarray(xn, jnp.bfloat16), chain, impl="xla")
    _close(fused, np.asarray(want, np.float32), 3e-2)
    steps = xb
    plans = [ops._pipeline_stage_plan(xb, d, i)[0]
             for i, d in enumerate(chain)]
    lead, trail = fuse.summed_lead_trail(plans)
    steps = torch.nn.functional.pad(xb, (lead[1], trail[1], lead[0],
                                         trail[0]))
    for p in plans:
        steps = engine.run_window_plan_reference(
            steps, plan=dataclasses.replace(p, lead=None, trail=None))
    _close(unfused, steps.float().numpy(), 3e-2)


# ---------------------------------------------------------------------------
# fuse='auto' decides by legality only
# ---------------------------------------------------------------------------

def test_auto_fuses_exactly_when_fuse_plans_accepts(monkeypatch):
    seen = []
    real = engine.run_window_plan

    def spy(x, w=None, **kw):
        seen.append(kw["plan"])
        return real(x, w, **kw)

    monkeypatch.setattr(engine, "run_window_plan", spy)
    x = torch.from_numpy(_x((48, 64), 11))
    # a legal chain K1 cannot hold in one launch (33 column steps of 32)
    # still fuses: the CPU runs it in one call, the card as its segments
    big = ["2d121pt"] * 3
    assert "column steps" in engine.tap_table_refusal(
        fuse.fuse_plans(*_plans(big)))
    ops.pipeline(x, big)
    assert len(seen) == 1 and len(seen[0].stages) == 3
    seen.clear()
    ops.pipeline(x, big, fuse=False)
    assert len(seen) == 3 and not any(p.stages for p in seen)
    # a chain fuse_plans refuses: auto runs unfused, True raises its error
    def refuse(*plans):
        raise ValueError("fuse_plans: stage 1 refused")

    monkeypatch.setattr(ops, "fuse_plans", refuse)
    seen.clear()
    got = ops.pipeline(x, ["2d5pt", "2d9pt"])
    assert len(seen) == 2 and not any(p.stages for p in seen)
    with pytest.raises(ValueError, match="stage 1 refused"):
        ops.pipeline(x, ["2d5pt", "2d9pt"], fuse=True)
    monkeypatch.undo()
    _close(got, ops.pipeline(x, ["2d5pt", "2d9pt"]).numpy())


# ---------------------------------------------------------------------------
# Gradients: the engine path end to end
# ---------------------------------------------------------------------------

def _grad_close(got, want, rtol=3e-5):
    _close(got, want, rtol)


def test_linear_chain_one_fused_adjoint():
    xn = _x((28, 56), 12)
    chain = ["2d5pt", "2d9pt"]
    x = torch.from_numpy(xn).requires_grad_(True)
    adjoint.reset_lowering_counts()
    ops.pipeline(x, chain).sum().backward()
    assert dict(adjoint.BACKWARD_LOWERINGS) == {
        "pipe2_adj_stencil2d+adj_stencil2d": 1}
    want = jax.grad(lambda v: jnp.sum(jops.pipeline(
        v, chain, impl="xla")))(jnp.asarray(xn))
    _grad_close(x.grad, want)


@pytest.mark.parametrize("shape", [(24, 48), (2, 20, 36)], ids=str)
def test_nonlinear_chain_gradients(shape):
    xn = _x(shape, 13)
    wn = _x((3, 3), 14)
    chain = lambda ww: [("2d5pt", "gelu"), ww, ("2d9pt", "silu")]
    x = torch.from_numpy(xn).requires_grad_(True)
    w = torch.from_numpy(wn).requires_grad_(True)
    adjoint.reset_lowering_counts()
    (ops.pipeline(x, chain(w)) ** 2).sum().backward()
    gx, gw = jax.grad(lambda v, ww: jnp.sum(jops.pipeline(
        v, chain(ww), impl="xla") ** 2), (0, 1))(jnp.asarray(xn),
                                                 jnp.asarray(wn))
    _grad_close(x.grad, gx)
    _grad_close(w.grad, gw)
    low = adjoint.BACKWARD_LOWERINGS
    assert low["adj_stencil2d"] == 2 and low["adj_conv2d"] == 1
    assert low["wgrad_conv2d"] == 1


def test_epilogue_operand_gradients():
    """Mid-chain biases and the final residual: dx, each bias and the
    residual against jax.grad."""
    xn = _x((20, 40), 15)
    rn = _x((20, 40), 16)
    wn = _x((5, 5), 17)
    chain = lambda ww: [("2d5pt", "bias"), (ww, ("bias", "gelu")),
                        ("2d9pt", ("bias", "residual_add"))]
    b = [np.float32(v).reshape(1) for v in (0.5, -0.25, 0.1)]
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (xn, wn, *b, rn)]
    x, w, b0, b1, b2, r = leaves
    (ops.pipeline(x, chain(w), epilogue_args=(b0, b1, b2, r)) ** 2
     ).sum().backward()
    want = jax.grad(lambda v, ww, c0, c1, c2, rr: jnp.sum(jops.pipeline(
        v, chain(ww), impl="xla", epilogue_args=(c0, c1, c2, rr)) ** 2),
        tuple(range(6)))(*map(jnp.asarray, (xn, wn, *b, rn)))
    for got, exp in zip(leaves, want):
        _grad_close(got.grad, exp)


# ---------------------------------------------------------------------------
# K1's walk of a chain
# ---------------------------------------------------------------------------

EMU = [
    ("2d", (37, 61), ["2d5pt", "2d9pt", "2d5pt"], None),
    ("2d-rows", (29, 70), ["2d25pt", ("2d5pt", ("relu", ("scale", 0.5))),
                           "2d121pt"], (8, 32)),
    ("conv-mid-bias", (33, 47), [("W", ("bias", "gelu")), ("2d9pt", "bias"),
                                 ("W", "silu")], (16, 40)),
    ("3d", (9, 11, 37), ["3d7pt", "3d125pt", "3d13pt"], (4, 8, 16)),
    ("bf16", (25, 41), ["2d9pt", ("2d5pt", "bias")], None),
]


@pytest.mark.parametrize("variant", engine.VARIANTS)
@pytest.mark.parametrize("case", EMU, ids=lambda c: c[0])
def test_chain_walk_matches_plain_version(case, variant):
    tag, shape, chain, block = case
    x = torch.from_numpy(_x(shape, 18))
    if tag == "bf16":
        x = x.to(torch.bfloat16)
    w = torch.from_numpy(_x((5, 3), 19))
    pc, _ = _both(chain, w.numpy())
    args = tuple(torch.tensor([v]) for v in (0.3, -0.6)[
        :sum(isinstance(d, tuple) and "bias" in str(d[1]) for d in chain)])
    resolved = [ops._pipeline_stage_plan(x, d, i) for i, d in enumerate(pc)]
    p = fuse.fuse_plans(*[q for q, _ in resolved])
    ws = tuple(v for _, v in resolved)
    got = engine.emulate_window_kernel(x, ws, plan=p, block=block,
                                       variant=variant, epilogue_args=args)
    want = engine.run_window_plan_reference(x, ws, plan=p, block=block,
                                            variant=variant,
                                            epilogue_args=args)
    assert got.dtype == x.dtype
    _close(got, want.float().numpy(), 3e-5 if tag != "bf16" else 3e-2)


def test_chain_table_and_layout():
    """The chain's records as the C entry reads them: the stages' steps
    one after another, slots in the instantiation's (D, N), coefficient
    indices into the concatenated array, mid-chain biases after the
    filters; the iterate buffers sized by each stage's own shrinkage."""
    p5, p25 = _plans(["2d5pt", "2d25pt"])
    conv = ssam_conv2d.plan_for((3, 3), "same")
    relu = dataclasses.replace(p5, epilogue=plan.normalize_epilogue(
        ("bias", "relu")))
    p = fuse.fuse_plans(relu, conv, p25)
    assert engine.window_inst(p) == (1, 5) and engine.window_p(p) == 32
    ct = engine.chain_table(p)
    assert [r[:2] for r in ct.records] == [(0, 3), (3, 3), (6, 5)]
    assert [(r[2] & 255, r[2] >> 16) for r in ct.records] == [
        (3, 3), (3, 3), (5, 5)]
    assert ct.records[0][3] == 0 | 2 << 8 and ct.records[1][3] == 0
    assert ct.mid == ((1, 0.0, 5 + 9 + len(p25.coeffs)), (4, 0.0, -1))
    # slots dz·5 + row: the 3-row stages' taps sit in rows < 3
    first = ct.table.steps[3][1]
    assert max(ct.table.slots[:first]) < 3
    assert max(ct.table.cidx[:5]) < 5 and min(ct.table.cidx[5:14]) >= 5
    lay = engine.window_layout(p, (1, 1, 40, 80, 1, 40, 80, 0, 4, 4),
                               (1, 16, 64), 1)
    assert lay.chain[:4] == (3, 5, 1, 2)
    assert lay.chain[4:16] == tuple(v for r in ct.records for v in r)
    # application k writes the tile widened by the stages after it: the
    # last the tile (even), the middle +4 (odd), the first +4+2 (even)
    assert lay.bufs[1] == (16 + 4) * (64 + 4)
    assert lay.bufs[2] == (16 + 6) * (64 + 6)
    text = CUH.read_text()
    assert int(re.search(r"kMaxChain = (\d+)", text).group(1)) == \
        engine.WINDOW_MAX_STEPS
    # the chain tables hold the buckets window_inst picks from
    two = (CUH.parent / "ssam_window_chain_2d.cu").read_text()
    three = (CUH.parent / "ssam_window_chain_3d.cu").read_text()
    assert tuple(int(v) for v in re.findall(r"SSAM_CHAIN_2D\((\d+)\)",
                                            two)) == engine.WINDOW_CHAIN_ROWS
    assert sorted({int(v) for pair in re.findall(
        r"SSAM_CHAIN_3D\((\d+), (\d+)\)", three) for v in pair}) == list(
        engine.WINDOW_CHAIN_3D)
    mixed = fuse.fuse_plans(*_plans(["3d7pt", "3d125pt"]))
    assert engine.window_inst(mixed) == (5, 5)
    assert engine.window_inst(fuse.fuse_plans(*_plans(
        ["2d5pt", "2d25pt", "2d64pt"]))) == (1, 9)
    assert int(re.search(r"kMaxMid = (\d+)", text).group(1)) == \
        engine.WINDOW_MAX_MID


def test_chain_beyond_k1_is_refused_by_name():
    big = fuse.fuse_plans(*_plans(["2d121pt"] * 3))
    assert "33 column steps" in engine.tap_table_refusal(big)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        engine.chain_table(big)
    x = torch.zeros(30, 40)
    with pytest.raises(NotImplementedError, match="column steps"):
        engine.emulate_window_kernel(x, (None,) * 3, plan=big)
    many = fuse.fuse_plans(*[dataclasses.replace(
        p, epilogue=plan.normalize_epilogue(("relu",) * 6))
        for p in _plans(["2d5pt"] * 4)])
    assert "mid-chain epilogue ops" in engine.tap_table_refusal(many)
    # each stage must fit on its own
    wide = fuse.fuse_plans(_plans(["2d5pt"])[0],
                           ssam_conv2d.plan_for((3, 33), "same"))
    assert engine.tap_table_refusal(wide).startswith("stage 1")
    # (a 3 x 33 stage alone is walked in bands, which no chain fuses)
    assert "in bands" in engine.tap_table_refusal(wide)
