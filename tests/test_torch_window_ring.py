"""K1's single-channel schedule, walked on the CPU.

``engine.emulate_window_kernel`` is the plain-torch spec of
``csrc/ssam_window.cuh``: the persistent tile walk, each ring stage's TMA
boxes (16-byte aligned starts, zeros outside the domain, at most 256
elements per axis), the warp items of ``V = 33 − M`` valid lanes with
32-lane shuffles, the compacted per-step tap lists and the shared-memory
budget. It is held here to the plain version
(``engine.run_window_plan_reference``) and to the JAX package's oracles
(``repro.kernels.ref``) on numpy inputs from a seed. Tolerance: fp32
3e-5·max|want| (DESIGN.md §6), bf16 3e-2.
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import stencils as jstencils
from repro_torch import convert
from repro_torch.core import engine, plan
from repro_torch.kernels import ssam_conv2d, ssam_stencil2d, ssam_stencil3d
from repro_torch.kernels import stencils

NAMES = sorted(stencils.BENCHMARKS)
VARIANTS = engine.VARIANTS
FILTERS = (2, 3, 5, 7, 9, 13, 17, 20)
CUH = Path(engine.__file__).resolve().parents[1] / "csrc" / "ssam_window.cuh"


def _close(got, want, rtol=3e-5):
    want = (want.float() if isinstance(want, torch.Tensor)
            else torch.tensor(np.asarray(want, dtype=np.float32)))
    assert tuple(got.shape) == tuple(want.shape)
    scale = want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=rtol * scale)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _stencil_plan(name):
    sd = stencils.BENCHMARKS[name]
    return (ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d).plan_for(sd)


@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", NAMES)
def test_stencil_schedule_matches_plain_and_oracle(name, variant, t):
    """Ragged tiles on a width of 37 (148 bytes: not 16-byte aligned)."""
    sd = stencils.BENCHMARKS[name]
    x = _x((19, 37) if sd.ndim == 2 else (7, 9, 37), 11)
    p = _stencil_plan(name)
    block = (8, 16) if sd.ndim == 2 else (2, 4, 16)
    tx = torch.from_numpy(x)
    got = engine.emulate_window_kernel(tx, plan=p, block=block,
                                       time_steps=t, variant=variant)
    _close(got, engine.run_window_plan_reference(
        tx, plan=p, block=block, time_steps=t, variant=variant))
    _close(got, jref.stencil_iterate(jnp.asarray(x),
                                     jstencils.BENCHMARKS[name], t))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("k", FILTERS)
@pytest.mark.parametrize("mode", ["valid", "same"])
def test_filter_sweep_schedule_matches_plain_and_oracle(mode, k, variant):
    x = _x((29, 50), k)
    w = _x((k, k), 100 + k)
    p = ssam_conv2d.plan_for((k, k), mode)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = engine.emulate_window_kernel(tx, tw, plan=p, variant=variant)
    _close(got, engine.run_window_plan_reference(tx, tw, plan=p,
                                                 variant=variant))
    fn = jref.conv2d_same if mode == "same" else jref.conv2d_valid
    _close(got, fn(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("block", [None, (7, 13), (1, 1), (5, 300),
                                   (270, 9)])
@pytest.mark.parametrize("mode", ["valid", "same"])
def test_batched_ragged_and_wide_tiles(mode, block):
    """A batch of 3 on rows of 37, tiles that leave ragged edges, a 1x1
    tile, a tile wider than one TMA box (x-boxes as blocks, each padded
    to 128 bytes) and one taller (y-boxes stacked)."""
    x = _x((3, 283, 37) if block == (270, 9) else (3, 23, 37), 5)
    w = _x((5, 3), 6)
    p = ssam_conv2d.plan_for_batched((5, 3), mode)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = engine.emulate_window_kernel(tx, tw, plan=p, block=block)
    _close(got, engine.run_window_plan_reference(tx, tw, plan=p))
    _close(got, jref.conv2d_batched(jnp.asarray(x), jnp.asarray(w), mode))


def test_wide_tile_stages_several_x_boxes():
    p = ssam_conv2d.plan_for_batched((5, 3), "same")
    head = (3, 1, 23, 600, 1, 23, 600, 0, 1, 2)
    lay = engine.window_layout(p, head, (1, 5, 590), 1)
    assert lay.boxes[2] == 3 and all(1 <= b <= 256 for b in lay.box)
    tall = engine.window_layout(p, (1, 1, 600, 40, 1, 600, 40, 0, 1, 2),
                                (1, 300, 16), 1)
    assert tall.boxes[1] == 2 and (tall.box[1] * tall.box[2] * 4) % 128 == 0
    x = torch.from_numpy(_x((2, 9, 601), 7))
    got = engine.emulate_window_kernel(x, torch.from_numpy(_x((5, 3), 8)),
                                       plan=p, block=(4, 590))
    _close(got, engine.run_window_plan_reference(
        x, torch.from_numpy(_x((5, 3), 8)), plan=p))


@pytest.mark.parametrize("name", ["2d9pt", "3d13pt"])
def test_bf16_at_an_odd_width(name):
    sd = stencils.BENCHMARKS[name]
    x = torch.from_numpy(_x((21, 45) if sd.ndim == 2 else (6, 7, 45),
                            9)).to(torch.bfloat16)
    p = _stencil_plan(name)
    got = engine.emulate_window_kernel(x, plan=p, time_steps=2)
    assert got.dtype == torch.bfloat16
    _close(got, engine.run_window_plan_reference(x, plan=p, time_steps=2),
           rtol=3e-2)


def test_three_d_five_by_five_and_a_one_tile_grid():
    p = ssam_stencil3d.plan_for(stencils.BENCHMARKS["3d125pt"])
    x = torch.from_numpy(_x((6, 8, 12), 10))
    for block in (None, (6, 8, 12)):
        got = engine.emulate_window_kernel(x, plan=p, block=block,
                                           time_steps=3)
        _close(got, engine.run_window_plan_reference(x, plan=p,
                                                     time_steps=3))


def test_tap_table_compacts_each_step():
    tab = engine.tap_table(_stencil_plan("2d21pt"), None)
    # 11 column steps: one tap on the centre row each, but the centre
    # column, which fills all 11 rows and runs the dense body
    assert len(tab.steps) == 11 and len(tab.slots) == 21
    for m, (shift, first, count, dense) in enumerate(tab.steps):
        assert shift == (m > 0) and dense == (m == 5)
        assert count == (11 if m == 5 else 1)
    assert tab.slots[5:16] == tuple(range(11))
    t3 = engine.tap_table(_stencil_plan("3d13pt"), None)
    # the centre column holds the (dz, row) cross of 9 taps in slot order
    shift, first, count, dense = t3.steps[2]
    assert count == 9 and not dense
    assert t3.slots[first:first + count] == (2, 7, 10, 11, 12, 13, 14, 17,
                                             22)
    assert all(d for *_, d in engine.tap_table(
        _stencil_plan("3d125pt"), None).steps)


def test_layouts_of_the_main_path_take_the_ring():
    """The 8192² and 512³ cases at t = 1 and 2 take the ring (2-D at t = 1
    two blocks an SM, each with two stages in flight), every box within
    TMA's limits, pitch 8192 needing no copy."""
    for name in NAMES:
        sd = stencils.BENCHMARKS[name]
        p = _stencil_plan(name)
        for t in (1, 2):
            x = torch.empty((8192, 8192) if sd.ndim == 2 else (512,) * 3,
                            device="meta")
            _, _, _, head, tile = engine._tile_launch(
                p, x, engine.default_block(p, t), t)
            lay = engine.window_layout(p, head, tile, t)
            assert lay.smem <= engine.SMEM_LIMIT
            if sd.ndim == 2 and t == 1:
                assert lay.blocks_per_sm == 2 and lay.stages >= 2
            assert lay.grid == lay.blocks_per_sm * engine.H100_SMS
            assert all(1 <= b <= engine.TMA_MAX_BOX for b in lay.box)
            assert engine.tma_pitch(head[3], 4) == head[3]


def test_geometry_matches_the_c_entry():
    text = CUH.read_text()
    n = int(re.search(r"kGeomInts = (\d+)", text).group(1))
    p = _stencil_plan("2d5pt")
    lay = engine.window_layout(p, (1, 1, 40, 80, 1, 40, 80, 0, 1, 1),
                               (1, 8, 16), 2)
    # the ints the C entry reads, then the 3 step records
    assert len(lay.geom) == n + 4 * 3
    assert lay.geom[n:] == tuple(v for st in engine.tap_table(p, None).steps
                                 for v in st)
    # P as the instantiation tables state it
    two = (CUH.parent / "ssam_window_2d.cu").read_text()
    three = (CUH.parent / "ssam_window_3d.cu").read_text()
    wide = (CUH.parent / "ssam_window_2d_wide.cu").read_text()
    strided = (CUH.parent / "ssam_window_2d_strided.cu").read_text()
    assert "window_kernel<n, 1, (n <= 13 ? 32 : 16), kThreads2d, false>" in two
    assert "window_kernel<n, 1, 16, kThreads2d, false>" in wide
    # the strided table: exact row counts up to engine's, then one bucket
    assert "window_kernel<n, 1, 16, kThreads2d, true>" in strided
    exact = [int(v) for v in re.findall(r"SSAM_2D_STRIDED\((\d+)\)", strided)]
    assert exact == list(range(1, engine.WINDOW_STRIDED_EXACT + 1))
    assert (f"window_kernel<{engine.WINDOW_STRIDED_BUCKET}, 1, 8, kThreads2d, "
            "true>") in strided
    assert "(d * (n + 15) <= 54 ? 16 : 8)" in three
    assert engine.window_p(p) == 32
    assert engine.window_p(ssam_conv2d.plan_for((20, 20), "same")) == 16
    assert engine.window_p(_stencil_plan("3d7pt")) == 16
    assert engine.window_p(_stencil_plan("3d125pt")) == 8
    # the strided instantiations: ceil(N / sh) rows up to 16, P = 16; one
    # of 32 rows above, P = 8
    for f, st, rows, want in (((5, 5), (2, 2), 3, 16),
                              ((5, 5), (1, 2), 5, 16),
                              ((3, 3), (3, 3), 1, 16),
                              ((20, 20), (1, 2), 32, 8),
                              ((32, 32), (2, 1), 16, 16),
                              ((17, 17), (1, 3), 32, 8)):
        sp = dataclasses.replace(ssam_conv2d.plan_for(f, "same"), stride=st)
        assert engine.window_rows(sp) == rows
        assert engine.window_p(sp) == want
    assert engine.window_rows(p) == p.N
    # the geometry's stride and dense output step (o_row, o_col, o_plane,
    # o_img) sit right before the band flag (not banded) and the step
    # records
    assert lay.geom[n - 7:n] == (1, 1, 80, 1, 40 * 80, 40 * 80, 0)


def test_too_large_a_block_raises():
    p = _stencil_plan("2d121pt")
    with pytest.raises(ValueError, match="shared memory"):
        engine.emulate_window_kernel(torch.zeros(600, 600), plan=p,
                                     block=(512, 512))


def test_shuffles_keep_the_lanes_below_the_delta():
    v = torch.arange(32.0)
    up = engine._shfl_up(v, 3)
    assert up[:3].tolist() == [0, 1, 2] and up[3:].equal(v[:-3])
    down = engine._shfl_down(v, 3)
    assert down[29:].tolist() == [29, 30, 31] and down[:29].equal(v[3:])


# Output strides and the epilogue at the store (the reference's
# data-stationary strided read: lane l reads column sw·l + cum, the cache
# one row phase at a time; the chain applied once to the fp32 sum)
STRIDED = [((2, 2), "same"), ((1, 2), "same"), ((2, 1), "valid"),
           ((3, 3), "valid")]


@pytest.mark.parametrize("block", [None, (8, 16)], ids=str)
@pytest.mark.parametrize("shape", [(37, 70), (2, 29, 83)], ids=str)
@pytest.mark.parametrize("stride,mode", STRIDED, ids=str)
def test_strided_schedule_matches_plain_version(stride, mode, shape, block):
    x = torch.from_numpy(_x(shape, 21))
    w = torch.from_numpy(_x((5, 5), 22))
    p = dataclasses.replace((ssam_conv2d.plan_for if len(shape) == 2
                             else ssam_conv2d.plan_for_batched)((5, 5), mode),
                            stride=stride)
    want = engine.run_window_plan_reference(x, w, plan=p)
    _close(engine.emulate_window_kernel(x, w, plan=p, block=block), want)
    _close(engine.emulate_window_kernel(x.to(torch.bfloat16), w, plan=p,
                                        block=block),
           engine.run_window_plan_reference(x.to(torch.bfloat16), w,
                                            plan=p), 3e-2)


def test_strided_tap_table_and_layout():
    """Row r of a stride-sh plan sits in row phase r mod sh at q = r // sh
    (slot rho << 8 | q, (rho, q) order in a step, no step dense); the
    tiles fit two blocks an SM at 8192², the stage holds sh·(bh−1) + N
    rows."""
    p = dataclasses.replace(ssam_conv2d.plan_for((5, 5), "same"),
                            stride=(2, 2))
    tab = engine.tap_table(p, (5, 5))
    assert tab.slots[:5] == (0, 1, 2, 256, 257)
    assert not any(d for *_, d in tab.steps)
    for stride in ((2, 2), (1, 2), (3, 3)):
        sp = dataclasses.replace(ssam_conv2d.plan_for((5, 5), "same"),
                                 stride=stride)
        block = engine.default_block(sp)
        assert engine.smem_bytes(sp, block, 1) <= engine.WINDOW_SMEM_TARGET
        out = sp.out_shape((8192, 8192))
        tile = (1,) + block
        head = (1, 1, 8192, 8192, 1) + out + (0, 2, 2)
        lay = engine.window_layout(sp, head, tile, 1)
        assert lay.staged[1] >= stride[0] * (block[0] - 1) + 5
        assert lay.boxes[2] * lay.box[2] >= stride[1] * (block[1] - 1) + 5
        assert lay.smem <= engine.SMEM_LIMIT


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("name", ["2d9pt", "3d7pt"])
def test_epilogue_at_the_store_matches_plain_version(name, t):
    sd = stencils.BENCHMARKS[name]
    shape = (19, 37) if sd.ndim == 2 else (7, 9, 37)
    x = torch.from_numpy(_x(shape, 23))
    r = torch.from_numpy(_x(shape, 24))
    p = dataclasses.replace(_stencil_plan(name), epilogue=plan.
                            normalize_epilogue(("bias", "gelu",
                                                "residual_add")))
    args = (torch.tensor([0.5]), r)
    block = (8, 16) if sd.ndim == 2 else (3, 4, 16)
    for variant in VARIANTS:
        _close(engine.emulate_window_kernel(
            x, plan=p, block=block, time_steps=t, variant=variant,
            epilogue_args=args),
            engine.run_window_plan_reference(x, plan=p, time_steps=t,
                                             variant=variant,
                                             epilogue_args=args))
