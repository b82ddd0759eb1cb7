"""Parity of the port's plan IR, stencil zoo and halo geometry with the
JAX package: the same builders on the same arguments give plans equal by
``dataclasses.astuple``, and a reference plan carried across with
``convert.plan_from_reference`` is the port's own plan."""
import dataclasses

import pytest

from repro.core import fuse as jfuse
from repro.core import halo as jhalo
from repro.core import plan as jplan
from repro.kernels import ssam_conv2d as jc2
from repro.kernels import ssam_stencil2d as js2
from repro.kernels import ssam_stencil3d as js3
from repro.kernels import stencils as jstencils
from repro_torch import convert
from repro_torch.core import halo, plan
from repro_torch.kernels import ssam_conv2d, ssam_stencil2d, ssam_stencil3d
from repro_torch.kernels import stencils

NAMES = sorted(jstencils.BENCHMARKS)

BUILDERS = [
    ("conv1d_plan", (5,), {}),
    ("conv1d_plan", (3,), {"S": 32, "P": 2}),
    ("conv2d_plan", (5, 3), {}),
    ("conv2d_plan", (20, 20), {"S": 32, "P": 8}),
    ("conv2d_same_plan", (5, 3), {}),
    ("conv2d_same_plan", (4, 2), {"P": 2}),
    ("conv2d_batched_plan", (3, 5), {}),
    ("conv2d_batched_plan", (3, 5), {"mode": "same"}),
    ("conv2d_nchw_plan", (2, 4, 6, 3, 3), {}),
    ("conv2d_nchw_plan", (2, 4, 6, 3, 5), {"mode": "same", "groups": 2}),
    ("stencil2d_plan", (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),),
     {"coeffs": (0.2,) * 5}),
    ("stencil2d_plan", (((0, 0), (0, 2), (1, 0)),), {}),
    ("stencil3d_plan", (((0, 0, 0), (-1, 0, 0), (1, 1, 1)),),
     {"coeffs": (1.0, 2.0, 3.0), "P": 4}),
    ("depthwise_conv1d_plan", (4,), {}),
    ("scan_plan", (16,), {}),
    ("linear_recurrence_plan", (32,), {"S": 64}),
]


def _same(port_plan, ref_plan):
    assert dataclasses.astuple(port_plan) == dataclasses.astuple(ref_plan)
    assert convert.plan_from_reference(dataclasses.asdict(ref_plan)) \
        == port_plan


@pytest.mark.parametrize("name,args,kw", BUILDERS,
                         ids=[f"{b[0]}-{i}" for i, b in enumerate(BUILDERS)])
def test_builder_matches_reference(name, args, kw):
    _same(getattr(plan, name)(*args, **kw), getattr(jplan, name)(*args, **kw))


@pytest.mark.parametrize("name", NAMES)
def test_benchmark_entry_matches_reference(name):
    port, ref = stencils.BENCHMARKS[name], jstencils.BENCHMARKS[name]
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert port.radius == ref.radius
    mod, jmod = ((ssam_stencil2d, js2) if port.ndim == 2
                 else (ssam_stencil3d, js3))
    _same(mod.plan_for(port), jmod.plan_for(ref))


def test_benchmark_zoo_is_table_3():
    assert sorted(stencils.BENCHMARKS) == NAMES and len(NAMES) == 15


@pytest.mark.parametrize("mode", ["valid", "same"])
def test_conv2d_family_builders(mode):
    _same(ssam_conv2d.plan_for((3, 5), mode), jc2.plan_for((3, 5), mode))
    _same(ssam_conv2d.plan_for_batched((7, 2), mode),
          jc2.plan_for_batched((7, 2), mode))
    _same(ssam_conv2d.plan_for_nchw((2, 4, 9, 9), (6, 2, 3, 3), mode, 2),
          jc2.plan_for_nchw((2, 4, 9, 9), (6, 2, 3, 3), mode, 2))
    with pytest.raises(ValueError):
        ssam_conv2d.plan_for_nchw((2, 4, 9, 9), (6, 3, 3, 3), mode)


def test_fused_plan_with_epilogues_crosses_over():
    """Nested stages and epilogue stages survive plan_from_reference."""
    a = dataclasses.replace(jplan.conv2d_same_plan(3, 3),
                            epilogue=jplan.normalize_epilogue("relu"))
    b = dataclasses.replace(jplan.conv2d_same_plan(5, 5),
                            epilogue=jplan.normalize_epilogue(
                                ("bias", ("scale", 2.0))))
    fused = jfuse.fuse_plans(a, b)
    port = convert.plan_from_reference(dataclasses.asdict(fused))
    assert dataclasses.astuple(port) == dataclasses.astuple(fused)
    assert len(port.stages) == 2
    assert port.final_epilogue() == plan.normalize_epilogue(
        ("bias", ("scale", 2.0)))
    assert port.shift_count() == fused.shift_count()
    assert port.mads_per_output_window() == fused.mads_per_output_window()
    assert port.epilogue_op_count() == fused.epilogue_op_count()
    assert [s.op for s in plan.chain_epilogue_operand_stages(port)] == \
        [s.op for s in jplan.chain_epilogue_operand_stages(fused)]


@pytest.mark.parametrize("spec", [
    None, "gelu", ("scale", 0.5), ["bias", "silu", ("scale", 3)],
    plan.EpilogueStage("residual_add")])
def test_normalize_epilogue(spec):
    jspec = (jplan.EpilogueStage("residual_add")
             if isinstance(spec, plan.EpilogueStage) else spec)
    port = plan.normalize_epilogue(spec)
    ref = jplan.normalize_epilogue(jspec)
    assert [dataclasses.astuple(s) for s in port] == \
        [dataclasses.astuple(s) for s in ref]
    assert [s.op for s in plan.epilogue_operand_stages(port)] == \
        [s.op for s in jplan.epilogue_operand_stages(ref)]


@pytest.mark.parametrize("bad", ["tanh", ("scale",), ("bias", 1.0)])
def test_normalize_epilogue_rejects(bad):
    with pytest.raises((ValueError, TypeError)):
        plan.normalize_epilogue(bad)


@pytest.mark.parametrize("name", ["2d5pt", "2d64pt", "2ds25pt", "3d27pt",
                                  "poisson"])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_plan_geometry_matches_reference(name, t):
    sd = stencils.BENCHMARKS[name]
    mod, jmod = ((ssam_stencil2d, js2) if sd.ndim == 2
                 else (ssam_stencil3d, js3))
    p, j = mod.plan_for(sd), jmod.plan_for(jstencils.BENCHMARKS[name])
    shape = (20, 40) if sd.ndim == 2 else (6, 10, 40)
    block = (8, 16) if sd.ndim == 2 else (2, 4, 16)
    assert p.exts == j.exts and p.halo(t) == j.halo(t)
    assert p.out_shape(shape, t) == j.out_shape(shape, t)
    assert p.block_in_shape(block, t) == j.block_in_shape(block, t)
    assert (p.valid_lane_lo, p.valid_lanes, p.outputs_per_block) == \
        (j.valid_lane_lo, j.valid_lanes, j.outputs_per_block)
    assert p.halo_ratio() == j.halo_ratio()
    assert p.halo_ratio_paper_bound() == j.halo_ratio_paper_bound()
    out = p.out_shape(shape, t)
    g = tuple(-(-o // b) for o, b in zip(out, block))
    assert halo.origin_pads(p, shape, g, block, t) == \
        jhalo.origin_pads(j, shape, g, block, t)
    assert halo.shard_halo(p, t) == jhalo.shard_halo(j, t)
    for axis in range(sd.ndim):
        assert halo.is_shape_preserving(p, axis) == \
            jhalo.is_shape_preserving(j, axis)
        assert halo.extended_crop(p, t, axis, 7) == \
            jhalo.extended_crop(j, t, axis, 7)


@pytest.mark.parametrize("per_axis", [(("x", 2), None), (None, ("y", 4))])
def test_check_shard_geometry_matches_reference(per_axis):
    p = plan.conv2d_same_plan(3, 3)
    j = jplan.conv2d_same_plan(3, 3)
    assert halo.check_shard_geometry(p, (16, 32), per_axis, 2) == \
        jhalo.check_shard_geometry(j, (16, 32), per_axis, 2)


@pytest.mark.parametrize("case", ["indivisible", "not_shape_preserving",
                                  "halo_wider_than_domain"])
def test_check_shard_geometry_raises_like_reference(case):
    if case == "indivisible":
        args = (plan.conv2d_same_plan(3, 3), (15, 32), (("x", 2), None), 1)
    elif case == "not_shape_preserving":
        args = (plan.conv2d_plan(3, 3), (16, 32), (("x", 2), None), 1)
    else:
        args = (plan.conv2d_same_plan(3, 3), (4, 32), (("x", 2), None), 5)
    jargs = (jplan.conv2d_same_plan(3, 3) if case != "not_shape_preserving"
             else jplan.conv2d_plan(3, 3),) + args[1:]
    with pytest.raises(ValueError):
        halo.check_shard_geometry(*args)
    with pytest.raises(ValueError):
        jhalo.check_shard_geometry(*jargs)


def test_origin_straddle_is_checked():
    with pytest.raises(ValueError, match="straddle"):
        plan.stencil2d_plan(((1, 0), (2, 0)))
