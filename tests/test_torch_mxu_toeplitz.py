"""K2's single-channel schedule (``csrc/ssam_mxu.cu``: Toeplitz coefficient
tiles on the tensor cores, TMA-fed persistent blocks) walked on the CPU.

``engine.emulate_mxu_kernel`` walks the kernel's layout, its persistent
tile order, the stages' TMA boxes, one block's zeroed shared memory, the
entries' Toeplitz B tiles built from the tap table, the shifted-row A read
in place with its 3xTF32 split, and the ping-pong iterates at t > 1. It is
held against the port's plain version (``run_window_plan_reference`` with
``apply_plan_mxu``) and against the reference's kernel body
``repro.core.engine._apply_plan_mxu`` applied t times to the whole
zero-padded input as one block (pad-once semantics). Tolerances: fp32
3e-5 relative to the largest value (DESIGN.md §6; the split drops the
small x small term, about 2^-20 of a product), bf16 3e-2.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.kernels import ssam_conv2d as jconv2d
from repro.kernels import ssam_stencil2d as js2
from repro.kernels import ssam_stencil3d as js3
from repro.kernels import stencils as jstencils
from repro_torch import convert
from repro_torch.core import engine, plan
from repro_torch.kernels import ssam_conv2d, ssam_stencil2d, ssam_stencil3d
from repro_torch.kernels import stencils

NAMES = sorted(stencils.BENCHMARKS)
SIZES = (2, 3, 5, 7, 9, 13, 17, 20)


def _close(got, want, rtol=3e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    if isinstance(want, torch.Tensor):
        want = want.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mxu(p):
    return dataclasses.replace(p, strategy="mxu")


def _reference(x, jp, w, t):
    """The reference's block body t times on the whole input, zero-padded
    once by t·lead ahead and t·trail behind per axis."""
    lead, trail = jp.lead_trail()
    xb = np.pad(x, [(t * lo, t * hi) for lo, hi in zip(lead, trail)])
    y = jnp.asarray(xb)
    for _ in range(t):
        y = jengine._apply_plan_mxu(y, jp, None if w is None
                                    else jnp.asarray(w), jnp.float32)
    return np.asarray(y)


def _stencil_plans(name):
    sd = stencils.BENCHMARKS[name]
    mod, jmod = (ssam_stencil2d, js2) if sd.ndim == 2 else (ssam_stencil3d,
                                                             js3)
    jp = dataclasses.replace(jmod.plan_for(jstencils.BENCHMARKS[name]),
                             strategy="mxu")
    return sd, _mxu(mod.plan_for(sd)), jp


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_stencil_schedule_matches_plain_and_reference(name, t):
    """Every Table-3 stencil on a small grid whose edges are not multiples
    of the tile, the default tile and a ragged one."""
    sd, p, jp = _stencil_plans(name)
    assert convert.plan_from_reference(dataclasses.asdict(jp)) == p
    x = _rand((40, 72) if sd.ndim == 2 else (12, 12, 12), 1)
    want = _reference(x, jp, None, t)
    for block in (None, (13, 21) if sd.ndim == 2 else (3, 5, 11)):
        got = engine.emulate_mxu_kernel(torch.from_numpy(x), plan=p,
                                        block=block, time_steps=t)
        _close(got, engine.run_window_plan_reference(
            torch.from_numpy(x), plan=p, block=block, time_steps=t))
        _close(got, want)


@pytest.mark.parametrize("mode", ["same", "valid"])
@pytest.mark.parametrize("k", SIZES)
def test_filter_sweep_schedule_matches_plain_and_reference(k, mode):
    """The Fig. 4 filter sweep: spans of 1 to 20 columns, one to four
    k-steps an entry."""
    jp = dataclasses.replace(jconv2d.plan_for((k, k), mode), strategy="mxu")
    p = _mxu(ssam_conv2d.plan_for((k, k), mode))
    x, w = _rand((50, 90), 2), _rand((k, k), 3)
    got = engine.emulate_mxu_kernel(torch.from_numpy(x), torch.from_numpy(w),
                                    plan=p)
    _close(got, engine.run_window_plan_reference(
        torch.from_numpy(x), torch.from_numpy(w), plan=p))
    _close(got, _reference(x, jp, w, 1))


@pytest.mark.parametrize("fshape", [(9, 1), (1, 31), (32, 32)], ids=str)
def test_one_column_wide_and_1024_tap_footprints(fshape):
    """A one-column filter (entries of one tap), a row wider than one
    entry (31 columns: two entries) and the 1024-tap limit."""
    p = _mxu(ssam_conv2d.plan_for(fshape, "same"))
    x, w = _rand((40, 70), 4), _rand(fshape, 5)
    got = engine.emulate_mxu_kernel(torch.from_numpy(x), torch.from_numpy(w),
                                    plan=p, block=(16, 32))
    _close(got, engine.run_window_plan_reference(
        torch.from_numpy(x), torch.from_numpy(w), plan=p, block=(16, 32)))
    ents = engine.mxu_entries(p, fshape)
    assert all(span <= engine.MXU_SPAN and kk <= engine.MXU_KSTEPS
               for _, _, _, span, kk, _, _ in ents.entries)
    assert len(ents.entries) == fshape[0] * -(-fshape[1] // engine.MXU_SPAN)


@pytest.mark.parametrize("t", [1, 2])
def test_batched_conv_and_bf16(t):
    """A batched 5×3 conv (batch axes walk as tiles), and bf16 inputs
    widened once per tile into the fp32 buffer at its own pitch."""
    p = _mxu(ssam_conv2d.plan_for_batched((5, 3), "same"))
    x, w = _rand((3, 33, 45), 6), _rand((5, 3), 7)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = engine.emulate_mxu_kernel(xt, wt, plan=p, block=(16, 24),
                                    time_steps=t)
    _close(got, engine.run_window_plan_reference(xt, wt, plan=p,
                                                 block=(16, 24),
                                                 time_steps=t))
    xb = xt.bfloat16()
    got = engine.emulate_mxu_kernel(xb, wt, plan=p, time_steps=t)
    assert got.dtype == torch.bfloat16
    _close(got, engine.run_window_plan_reference(xb, wt, plan=p,
                                                 time_steps=t), 3e-2)


def test_toeplitz_tiles_reproduce_the_tap_table():
    """A unit input at window column q of an entry, times its B tiles,
    gives output column n the coefficient of footprint column cmin + q − n
    (zero where no tap sits): the tiles are the tap table, shifted."""
    for p, w in ((_stencil_plans("2d13pt")[1], None),
                 (_stencil_plans("3d7pt")[1], None),
                 (_mxu(ssam_conv2d.plan_for((5, 29))), _rand((5, 29), 8))):
        wt = None if w is None else torch.from_numpy(w)
        ents = engine.mxu_entries(p, None if w is None else w.shape)
        cvals = (torch.tensor(p.coeffs) if w is None else wt.flatten())
        bt = engine.mxu_btiles(ents, cvals)
        taps = {}
        for cum, tap in engine.flat_taps(p):
            dz = tap.z_offset if p.ndim_spatial == 3 else 0
            taps[(dz, tap.row_offset, cum)] = float(np.float32(
                p.coeffs[tap.coeff_id[-1]] if w is None
                else w[tuple(tap.coeff_id)]))
        seen = set()
        for dz, r, cmin, span, kk, boff, _ in ents.entries:
            B = bt[boff:boff + 64 * kk].view(8 * kk, 8)
            for q in range(8 * kk):
                row = torch.zeros(8 * kk)
                row[q] = 1.0
                for n, v in enumerate((row @ B).tolist()):
                    col = cmin + q - n
                    inside = 0 <= col - cmin < span
                    assert v == (taps.get((dz, r, col), 0.0) if inside
                                 else 0.0)
                    if inside and (dz, r, col) in taps:
                        seen.add((dz, r, col))
        assert seen == set(taps)        # every tap sits in one entry


def test_layouts_of_the_paper_cases():
    """The default tile of every stencil and filter at t = 1 and 2 fits
    two blocks an SM, its box obeys TMA's rules (at most 256 elements an
    axis, rows of a multiple of 16 bytes, fp32 rows at a pitch 4 mod 8
    words) and the C entry's geometry has its 46 ints."""
    plans = [_stencil_plans(n)[1] for n in NAMES] + [
        _mxu(ssam_conv2d.plan_for((k, k), "same")) for k in SIZES]
    for p in plans:
        for t in (1, 2):
            block = engine.default_block(p, t)
            tile = (1,) * (3 - p.ndim_spatial) + block
            grid = (8192,) * 2 if p.ndim_spatial == 2 else (512,) * 3
            head = ((1,) + (1,) * (3 - p.ndim_spatial) + grid
                    + (1,) * (3 - p.ndim_spatial) + grid + (0,) * 3)
            w_shape = p.exts if p.coeff_mode == "dense" else None
            ents = engine.mxu_entries(p, w_shape)
            lay = engine.mxu_layout(p, head, tile, t, 4, grid[-1], ents)
            box_z, box_y, box_x = lay.box
            assert lay.smem <= engine.WINDOW_SMEM_TARGET, (p.kind, t)
            assert lay.grid == 2 * engine.H100_SMS
            assert box_x <= engine.TMA_MAX_BOX and box_x % 8 == 4
            assert lay.staged[1] >= block[-2] + t * (p.N - 1)
            assert len(lay.geom) == 46 and lay.geom[43:] == (
                0, 0, len(ents.table))     # B tiles resident
            assert lay.geom[35] == engine.mxu_slack(1) == engine.MXU_SLACK


def test_fragment_loads_hit_thirty_two_banks():
    """A fragment load: lane 4g + q reads row g (rows a pitch apart),
    column q; at a pitch of 4 mod 8 words the 32 lanes hit 32 banks."""
    for width in range(1, 300):
        pitch = engine.mxu_pitch(width)
        assert pitch >= width and pitch % 8 == 4
        banks = {(g * pitch + q) % 32 for g in range(8) for q in range(4)}
        assert len(banks) == 32


def test_too_wide_a_block_raises():
    p = _mxu(ssam_conv2d.plan_for((3, 3)))
    x = torch.zeros(20, 600)
    with pytest.raises(ValueError, match="TMA box"):
        engine.emulate_mxu_kernel(x, torch.zeros(3, 3), plan=p,
                                  block=(8, 300))


# Output strides (a steeper Toeplitz band, B[k][n] = c(k − sw·n), rows
# sh·m + r) and the epilogue at the store
@pytest.mark.parametrize("block", [None, (16, 40)], ids=str)
@pytest.mark.parametrize("shape", [(37, 70), (2, 29, 83)], ids=str)
@pytest.mark.parametrize("stride,mode", [((2, 2), "same"), ((1, 2), "same"),
                                         ((2, 1), "valid"),
                                         ((3, 3), "valid")], ids=str)
def test_strided_schedule_matches_plain_version(stride, mode, shape, block):
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 5)).astype(np.float32))
    p = _mxu(dataclasses.replace(
        (ssam_conv2d.plan_for if len(shape) == 2
         else ssam_conv2d.plan_for_batched)((5, 5), mode), stride=stride))
    _close(engine.emulate_mxu_kernel(x, w, plan=p, block=block),
           engine.run_window_plan_reference(x, w, plan=p))


def test_strided_toeplitz_band_and_layout():
    """Entries span at most 32 − 7·sw columns (sw ≤ 4), the band's k-steps
    ⌈(span + 7·sw)/8⌉; the tiles fit two blocks an SM and one TMA box."""
    for sw in (1, 2, 3, 4):
        assert engine.mxu_span(sw) == 32 - 7 * sw
        assert engine.mxu_slack(sw) >= engine.MXU_SLACK
    with pytest.raises(ValueError, match="column strides up to 4"):
        engine.mxu_span(5)
    p = _mxu(dataclasses.replace(ssam_conv2d.plan_for((5, 5), "same"),
                                 stride=(2, 2)))
    ents = engine.mxu_entries(p, (5, 5))
    assert [e[4] for e in ents.entries] == [3] * 5      # ⌈(5 + 14)/8⌉
    cvals = torch.arange(1.0, 26.0)
    bt = engine.mxu_btiles(ents, cvals, 2)
    _, _, cmin, span, kk, boff, toff = ents.entries[0]
    tiles = bt[boff:boff + 64 * kk].view(kk, 8, 8)
    for s in range(kk):
        for k in range(8):
            for n in range(8):
                q = 8 * s + k - 2 * n
                want = cvals[q] if 0 <= q < span else 0.0
                assert float(tiles[s, k, n]) == float(want)
    for stride in ((2, 2), (1, 2), (3, 3)):
        sp = _mxu(dataclasses.replace(ssam_conv2d.plan_for((5, 5), "same"),
                                      stride=stride))
        block = engine.default_block(sp)
        out = sp.out_shape((8192, 8192))
        head = (1, 1, 8192, 8192, 1) + out + (0, 2, 2)
        lay = engine.mxu_layout(sp, head, (1,) + block, 1, 4, 8192,
                                engine.mxu_entries(sp, (5, 5)))
        assert lay.box[2] <= engine.TMA_MAX_BOX and lay.smem <= \
            engine.WINDOW_SMEM_TARGET
        assert lay.geom[35] == engine.mxu_slack(stride[1])
        assert lay.geom[37:39] == stride


def test_epilogue_at_the_store_matches_plain_version():
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((2, 30, 50)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    p = dataclasses.replace(_mxu(ssam_conv2d.plan_for_batched((3, 4),
                                                              "same")),
                            epilogue=plan.normalize_epilogue(
                                ("bias", "silu", "residual_add")))
    args = (torch.tensor([-0.3]), torch.from_numpy(
        rng.standard_normal((2, 30, 50)).astype(np.float32)))
    _close(engine.emulate_mxu_kernel(x, w, plan=p, block=(16, 24),
                                     epilogue_args=args),
           engine.run_window_plan_reference(x, w, plan=p,
                                            epilogue_args=args))
