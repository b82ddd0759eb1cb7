"""Parity of the port's adjoint plans and epilogue replay with the JAX
package: ``input_adjoint_plan`` and ``weight_adjoint_plan`` give plans
equal by ``dataclasses.astuple`` to the reference's for every windowed
conv builder and all 15 Table-3 stencils, and the adjoint of the adjoint
is the original plan. Pure plan transforms: no JAX engine is called."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adjoint as jadj
from repro.core import plan as jplan
from repro.kernels import ssam_stencil2d as js2
from repro.kernels import ssam_stencil3d as js3
from repro.kernels import stencils as jstencils
from repro_torch.core import adjoint, plan
from repro_torch.kernels import ops, ssam_stencil2d, ssam_stencil3d, stencils

NAMES = sorted(jstencils.BENCHMARKS)

CONV_BUILDERS = [
    ("conv1d_plan", (5,), {}),
    ("conv1d_plan", (3,), {"S": 32, "P": 2}),
    ("conv2d_plan", (5, 3), {}),
    ("conv2d_plan", (20, 20), {"S": 32, "P": 8}),
    ("conv2d_same_plan", (5, 3), {}),
    ("conv2d_same_plan", (3, 1), {}),
    ("conv2d_same_plan", (4, 2), {"P": 2}),
    ("conv2d_batched_plan", (3, 5), {}),
    ("conv2d_batched_plan", (3, 5), {"mode": "same"}),
    ("conv2d_nchw_plan", (2, 4, 6, 3, 3), {}),
    ("conv2d_nchw_plan", (8, 80, 512, 3, 1), {"mode": "same"}),
    ("conv2d_nchw_plan", (2, 4, 6, 3, 5), {"mode": "same", "groups": 2}),
    ("depthwise_conv1d_plan", (4,), {}),
]
IDS = [f"{b[0]}-{i}" for i, b in enumerate(CONV_BUILDERS)]


def _astuple_eq(a, b):
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


def _is_original(aa, p):
    """The adjoint of the adjoint is ``p`` (all-zero pads normalise to
    None, as in the reference)."""
    assert aa.lead_trail() == p.lead_trail()
    assert dataclasses.replace(aa, lead=p.lead, trail=p.trail) == p


def _stencil_plans(name):
    sd, jsd = stencils.BENCHMARKS[name], jstencils.BENCHMARKS[name]
    if sd.ndim == 2:
        return ssam_stencil2d.plan_for(sd), js2.plan_for(jsd)
    return ssam_stencil3d.plan_for(sd), js3.plan_for(jsd)


@pytest.mark.parametrize("name,args,kw", CONV_BUILDERS, ids=IDS)
def test_conv_adjoint_plans_match_reference(name, args, kw):
    p = getattr(plan, name)(*args, **kw)
    jp = getattr(jplan, name)(*args, **kw)
    _astuple_eq(adjoint.input_adjoint_plan(p), jadj.input_adjoint_plan(jp))
    _astuple_eq(adjoint.weight_adjoint_plan(p), jadj.weight_adjoint_plan(jp))
    _is_original(adjoint.input_adjoint_plan(adjoint.input_adjoint_plan(p)), p)
    assert list(adjoint.iter_tap_offsets(p)) == list(
        jadj.iter_tap_offsets(jp))


@pytest.mark.parametrize("name", NAMES)
def test_stencil_adjoint_plans_match_reference(name):
    p, jp = _stencil_plans(name)
    a = adjoint.input_adjoint_plan(p)
    _astuple_eq(a, jadj.input_adjoint_plan(jp))
    _is_original(adjoint.input_adjoint_plan(a), p)
    # a shape-preserving stencil transposes to one: lead and trail swap
    assert a.lead_trail() == tuple(reversed(p.lead_trail()))
    with pytest.raises(ValueError, match="table"):
        adjoint.weight_adjoint_plan(p)
    with pytest.raises(ValueError, match="table"):
        jadj.weight_adjoint_plan(jp)


def test_adjoint_of_strided_and_fused_plans_raises():
    p = dataclasses.replace(plan.conv2d_nchw_plan(1, 2, 3, 3, 1),
                            stride=(1, 2))
    with pytest.raises(ValueError, match="input-dilated"):
        adjoint.input_adjoint_plan(p)
    fused = dataclasses.replace(plan.conv2d_plan(3, 3),
                                stages=(plan.conv2d_plan(3, 3),))
    with pytest.raises(NotImplementedError, match="item 7"):
        adjoint.input_adjoint_plan(fused)
    with pytest.raises(ValueError, match="windowed"):
        adjoint.input_adjoint_plan(plan.scan_plan(16))


def test_adjoint_strips_the_epilogue_and_swaps_channels():
    p = dataclasses.replace(plan.conv2d_nchw_plan(2, 3, 5, 3, 1, mode="same"),
                            epilogue=plan.normalize_epilogue(("bias", "gelu")))
    a = adjoint.input_adjoint_plan(p)
    assert a.epilogue == () and (a.reduce_axes, a.out_axes) == (1, 1)
    _astuple_eq(a, jadj.input_adjoint_plan(dataclasses.replace(
        jplan.conv2d_nchw_plan(2, 3, 5, 3, 1, mode="same"),
        epilogue=jplan.normalize_epilogue(("bias", "gelu")))))


def test_adjoint_coeff_array_matches_reference():
    w = np.random.default_rng(0).standard_normal((5, 3, 1, 3)).astype(
        np.float32)
    p = plan.conv2d_nchw_plan(2, 3, 5, 3, 1)
    jp = jplan.conv2d_nchw_plan(2, 3, 5, 3, 1)
    got = adjoint.adjoint_coeff_array(p, torch.from_numpy(w))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jadj.adjoint_coeff_array(jp, jnp.asarray(w))))
    w2 = torch.ones(3, 3)
    assert adjoint.adjoint_coeff_array(plan.conv2d_plan(3, 3), w2) is w2


EPILOGUES = [("bias",), ("gelu",), ("silu",), ("relu",), (("scale", 0.5),),
             ("bias", "gelu"), ("bias", "silu", ("scale", -2.0))]


@pytest.mark.parametrize("epi", EPILOGUES, ids=lambda e: "-".join(map(str, e)))
def test_apply_epilogue_matches_reference(epi):
    rng = np.random.default_rng(1)
    y = (3 * rng.standard_normal((2, 4, 3, 7))).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    p = dataclasses.replace(plan.conv2d_nchw_plan(2, 3, 4, 3, 3),
                            epilogue=plan.normalize_epilogue(epi))
    jp = dataclasses.replace(jplan.conv2d_nchw_plan(2, 3, 4, 3, 3),
                             epilogue=jplan.normalize_epilogue(epi))
    args = (b,) if "bias" in epi else ()
    got = adjoint.apply_epilogue(p, torch.from_numpy(y),
                                 [torch.from_numpy(a) for a in args])
    want = jadj.apply_epilogue(jp, jnp.asarray(y),
                               [jnp.asarray(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_backward_lowerings_are_counted():
    adjoint.reset_lowering_counts()
    x = torch.randn(2, 3, 1, 10, requires_grad=True)
    w = torch.randn(4, 3, 1, 3, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    y = ops.conv2d(x, w, stride=(1, 2), epilogue=("bias", "gelu"),
                   epilogue_args=(b,))
    y.sum().backward()
    assert dict(adjoint.BACKWARD_LOWERINGS) == {
        "adj_conv2d_nchw": 1, "wgrad_conv2d_nchw": 1}
    g = torch.randn(12, 14, requires_grad=True)
    ops.stencil(g, "2d5pt").sum().backward()
    assert adjoint.BACKWARD_LOWERINGS["adj_stencil2d"] == 1
    adjoint.reset_lowering_counts()
    assert not adjoint.BACKWARD_LOWERINGS
