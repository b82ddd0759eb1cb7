"""Parity of the port's mxu strategy (the plain version of K2) with the
JAX package, on the CPU.

The port's im2row contraction (``engine.apply_plan_mxu``) is held against
the reference's kernel body ``engine._apply_plan_mxu`` on the same numpy
blocks; ``run_window_plan(strategy="mxu")`` and the ops against the lanes
schedule and the reference's oracles (``repro.kernels.ref``, the
``impl="xla"`` ops), mirroring ``tests/test_engine.py::TestMxuStrategy``;
the gradients against ``jax.grad`` of the ``impl="xla"`` oracle and by
fp64 gradcheck, mirroring ``tests/test_adjoint.py::TestMxuGradcheck``. The
JAX windowed engine itself is never called (it needs ``pl.Unblocked``,
ROADMAP R1). Tolerances: the block bodies and the oracles fp32 3e-5
(DESIGN.md §6; the contraction groups taps in eights, the reference sums
them in one dot); mxu against lanes 1e-4, the reference's own
lanes-versus-mxu tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssam_stencil2d as js2
from repro.kernels import ssam_stencil3d as js3
from repro.kernels import stencils as jstencils
from repro_torch import _build, convert
from repro_torch.core import adjoint, engine, plan
from repro_torch.kernels import ops, ssam_conv2d, ssam_stencil2d
from repro_torch.kernels import ssam_stencil3d, stencils

NAMES = sorted(stencils.BENCHMARKS)
VARIANTS = ("shift_psum", "shift_data")


def _close(got, want, rtol=3e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _plans(name):
    sd = stencils.BENCHMARKS[name]
    mod, jmod = (ssam_stencil2d, js2) if sd.ndim == 2 else (ssam_stencil3d,
                                                             js3)
    return sd, mod.plan_for(sd), jmod.plan_for(jstencils.BENCHMARKS[name])


# --- the block body against the reference's _apply_plan_mxu ---------------

@pytest.mark.parametrize("name", NAMES)
def test_block_body_matches_reference_stencils(name):
    sd, p, jp = _plans(name)
    assert convert.plan_from_reference(dataclasses.asdict(jp)) == p
    xb = _rand((20, 40) if sd.ndim == 2 else (6, 10, 40), 1)
    want = jengine._apply_plan_mxu(jnp.asarray(xb), jp, None, jnp.float32)
    got = engine.apply_plan_mxu(torch.from_numpy(xb), p, None)
    _close(got, want)
    # leading axes are independent blocks
    two = engine.apply_plan_mxu(torch.from_numpy(np.stack([xb, -xb])), p,
                                None)
    _close(two[1], -np.asarray(want))


@pytest.mark.parametrize("fshape", [(1, 1), (2, 4), (3, 3), (3, 5), (4, 4),
                                    (7, 7)], ids=str)
@pytest.mark.parametrize("mode", ["valid", "same"])
def test_block_body_matches_reference_dense(mode, fshape):
    """Dense filters whose tap counts are (8, 16) and are not (1, 9, 15,
    49) multiples of the contraction group."""
    N, M = fshape
    jp = (jplan.conv2d_same_plan if mode == "same" else jplan.conv2d_plan)(
        M, N)
    p = convert.plan_from_reference(dataclasses.asdict(jp))
    xb, w = _rand((12, 40), 2), _rand(fshape, 3)
    want = jengine._apply_plan_mxu(jnp.asarray(xb), jp, jnp.asarray(w),
                                   jnp.float32)
    got = engine.apply_plan_mxu(torch.from_numpy(xb), p, torch.from_numpy(w))
    _close(got, want)


@pytest.mark.parametrize("stride", [(1, 1), (1, 2), (2, 2)], ids=str)
def test_block_body_matches_reference_nchw(stride):
    """A strided NCHW plan with bias+GELU: the reference contracts one
    (C_out, C_in) slice per reduce iterate and applies the epilogue at the
    flush; the port contracts C_in·taps at once, then the same epilogue."""
    B, Ci, Co = 2, 3, 4
    xb, w, b = _rand((B, Ci, 9, 23), 4), _rand((Co, Ci, 3, 3), 5), _rand(
        (Co,), 6)
    jp = dataclasses.replace(
        jplan.conv2d_nchw_plan(B, Ci, Co, 3, 3, mode="valid"),
        stride=None if stride == (1, 1) else stride,
        epilogue=jplan.normalize_epilogue(("bias", "gelu")))
    p = convert.plan_from_reference(dataclasses.asdict(jp))
    want = np.zeros((B, Co) + p.out_shape((9, 23)), np.float32)
    for bi in range(B):
        for co in range(Co):
            s = sum(jengine._apply_plan_mxu(
                jnp.asarray(xb[bi, ci]), jp,
                jnp.asarray(w[co, ci])[None, None], jnp.float32)
                for ci in range(Ci))
            for st in jp.epilogue:
                s = jengine._apply_epilogue_val(
                    st, s, jnp.asarray(b[co:co + 1]), jp, jnp.float32, None)
            want[bi, co] = np.asarray(s)
    got = engine.apply_plan_mxu(torch.from_numpy(xb), p, torch.from_numpy(w))
    got = adjoint.apply_epilogue(p, got, (torch.from_numpy(b),))
    _close(got, want)


def test_flat_taps_match_reference():
    for name in ("2d5pt", "3d27pt"):
        _, p, jp = _plans(name)
        got = [(c, (t.z_offset, t.row_offset, t.coeff_id))
               for c, t in engine.flat_taps(p)]
        want = [(c, (t.z_offset, t.row_offset, t.coeff_id))
                for c, t in jengine._flat_taps(jp)]
        assert got == want
    assert engine.MXU_TAP_ALIGN == jengine.MXU_TAP_ALIGN


# --- run_window_plan(strategy="mxu") against lanes and the oracles ---------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_table_matrix(name, t, variant):
    sd, p, _ = _plans(name)
    if sd.ndim == 2:
        x, block = _rand((22, 48), 7), (8, 16)
    else:
        x, block = _rand((8, 10, 24), 7), (4, 4, 8)
    xt = torch.from_numpy(x)
    lanes = engine.run_window_plan(xt, plan=p, block=block, time_steps=t,
                                   variant=variant, strategy="lanes")
    mxu = engine.run_window_plan(xt, plan=p, block=block, time_steps=t,
                                 variant=variant, strategy="mxu")
    _close(mxu, lanes.numpy(), 1e-4)
    _close(mxu, jref.stencil_iterate(jnp.asarray(x),
                                     jstencils.BENCHMARKS[name], t))
    _close(ops.stencil(xt, name, time_steps=t, block=block, strategy="mxu"),
           mxu.numpy(), 0)


def test_run_window_plan_mxu_wrapper():
    x, w = _rand((20, 48), 8), _rand((3, 5), 9)
    p = ssam_conv2d.plan_for((3, 5))
    a = engine.run_window_plan_mxu(torch.from_numpy(x), torch.from_numpy(w),
                                   plan=p, block=(8, 16))
    b = engine.run_window_plan(torch.from_numpy(x), torch.from_numpy(w),
                               plan=p, block=(8, 16), strategy="mxu")
    _close(a, b.numpy(), 1e-6)
    _close(a, jref.conv2d_valid(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("bcc", [(1, 1, 1), (2, 3, 4), (3, 4, 2)], ids=str)
@pytest.mark.parametrize("fshape", [(3, 3), (1, 7), (5, 2)], ids=str)
def test_nchw_matrix(bcc, fshape):
    """NCHW plans contract C_in·taps: mxu agrees with lanes and the
    oracle across batch, channels and filters."""
    B, Ci, Co = bcc
    x, w = _rand((B, Ci, 12, 40), 10), _rand((Co, Ci) + fshape, 11)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    lanes = ops.conv2d(xt, wt, mode="same", strategy="lanes")
    mxu = ops.conv2d(xt, wt, mode="same", strategy="mxu")
    _close(mxu, lanes.detach().numpy(), 1e-4)
    _close(mxu, jref.conv2d_nchw(jnp.asarray(x), jnp.asarray(w), "same"))


def test_strided_conv_mxu():
    x, w = _rand((1, 3, 12, 40), 12), _rand((2, 3, 3, 3), 13)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), mode="same",
                       impl="xla", stride=(1, 2))
    for s in ("lanes", "mxu"):
        got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         mode="same", stride=(1, 2), strategy=s)
        _close(got, want)


def test_batched_conv_and_bf16_on_the_plain_path():
    x, w = _rand((3, 20, 40), 14), _rand((3, 5), 15)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), mode="same",
                     block=(8, 16), strategy="mxu")
    _close(got, jref.conv2d_batched(jnp.asarray(x), jnp.asarray(w), "same"))
    xb = torch.from_numpy(x[0]).bfloat16()
    got = ops.stencil(xb, "2d9pt", strategy="mxu")
    assert got.dtype == torch.bfloat16
    _close(got.float(), jref.stencil_iterate(
        jnp.asarray(xb.float().numpy()), jstencils.BENCHMARKS["2d9pt"], 1),
        3e-2)


def test_strategy_rides_the_plan_and_unknown_ones_raise():
    x = torch.zeros(20, 40)
    with pytest.raises(ValueError, match="strategy"):
        ops.stencil(x, "2d5pt", strategy="tensor")
    with pytest.raises(ValueError, match="strategy"):
        ops.conv2d(x, torch.ones(3, 3), strategy="wgmma")
    with pytest.raises(ValueError, match="strategy"):
        engine.run_window_plan(x, plan=_plans("2d5pt")[1], strategy="simt")
    # a per-lane plan under mxu runs the lane-batched mat-vec (item 5c
    # closed), equal to the lanes schedule
    xd = torch.from_numpy(_rand((20, 40), 30))
    wd = torch.from_numpy(_rand((3, 40), 31))
    dw = plan.depthwise_conv1d_plan(3)
    _close(engine.run_window_plan(xd, wd, plan=dw, strategy="mxu"),
           engine.run_window_plan(xd, wd, plan=dw, strategy="lanes").numpy())
    p = _plans("2d5pt")[1]
    for s in (None, "auto"):
        assert ops._strategy_plan(p, s, "stencil") is p
    assert ops._strategy_plan(p, "mxu", "stencil").strategy == "mxu"


def test_cpu_tensor_never_loads_k2():
    x = torch.randn(20, 40)
    ops.stencil(x, "2d5pt", strategy="mxu")
    ops.conv2d(torch.randn(1, 2, 1, 16), torch.randn(3, 2, 1, 3),
               strategy="mxu")
    assert not _build.LIBRARY.loaded
    assert engine.MXU_KERNEL.launches == engine.WINDOW_KERNEL.launches == 0


# --- gradients through the mxu plain path -----------------------------------

def test_adjoint_plan_inherits_strategy():
    """The transpose of an im2row contraction is an im2row contraction over
    the reflected taps: an mxu plan's adjoint stays mxu, and equals the
    reference's adjoint of the same pinned plan."""
    from repro.core import adjoint as jadjoint
    pairs = [(plan.conv2d_plan(5, 3), jplan.conv2d_plan(5, 3)),
             (plan.conv2d_same_plan(3, 3), jplan.conv2d_same_plan(3, 3)),
             (plan.conv2d_nchw_plan(2, 3, 4, 3, 3, mode="same"),
              jplan.conv2d_nchw_plan(2, 3, 4, 3, 3, mode="same")),
             (plan.depthwise_conv1d_plan(4), jplan.depthwise_conv1d_plan(4))]
    for p, jp in pairs:
        pinned = dataclasses.replace(p, strategy="mxu")
        got = adjoint.input_adjoint_plan(pinned)
        assert got.strategy == "mxu"
        assert adjoint.input_adjoint_plan(p).strategy is None
        want = jadjoint.input_adjoint_plan(
            dataclasses.replace(jp, strategy="mxu"))
        assert got == convert.plan_from_reference(dataclasses.asdict(want))


def _sq_grads_torch(fn, *arrays):
    """Gradient of ``sum(fn(*args)**2)`` through the port (the cotangent
    the reference's ``tests/test_adjoint.py::grads`` uses)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (fn(*ts) ** 2).sum().backward()
    return [t.grad for t in ts]


def _sq_grads_jax(fn, *arrays):
    n = len(arrays)
    return jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                            tuple(range(n))))(*map(jnp.asarray, arrays))


@pytest.mark.parametrize("mode", ["valid", "same"])
def test_conv2d_single_mxu_gradients(mode):
    x, w = _rand((14, 40), 16), _rand((3, 5), 17)
    adjoint.reset_lowering_counts()
    gx, gw = _sq_grads_torch(lambda a, b: ops.conv2d(
        a, b, mode=mode, strategy="mxu", block=(8, 16)), x, w)
    rx, rw = _sq_grads_jax(lambda a, b: jops.conv2d(a, b, mode=mode,
                                                    impl="xla"), x, w)
    _close(gx, rx)
    _close(gw, rw)
    assert adjoint.BACKWARD_LOWERINGS["adj_conv2d"] >= 1
    assert adjoint.BACKWARD_LOWERINGS["wgrad_conv2d"] >= 1


def test_conv2d_nchw_mxu_gradients():
    x, w, b = _rand((2, 3, 10, 24), 18), _rand((4, 3, 3, 3), 19), _rand(
        (4,), 20)
    adjoint.reset_lowering_counts()
    gx, gw, gb = _sq_grads_torch(lambda a, c, d: ops.conv2d(
        a, c, mode="same", stride=(1, 2), epilogue=("bias", "gelu"),
        epilogue_args=(d,), strategy="mxu"), x, w, b)
    rx, rw, rb = _sq_grads_jax(lambda a, c, d: jops.conv2d(
        a, c, mode="same", stride=(1, 2), epilogue=("bias", "gelu"),
        epilogue_args=(d,), impl="xla"), x, w, b)
    _close(gx, rx)
    _close(gw, rw)
    _close(gb, rb)
    assert adjoint.BACKWARD_LOWERINGS["adj_conv2d_nchw"] >= 1
    assert adjoint.BACKWARD_LOWERINGS["wgrad_conv2d_nchw"] >= 1


@pytest.mark.parametrize("name", ["2d25pt", "3d27pt"])
def test_stencil_mxu_gradients(name):
    sd = stencils.BENCHMARKS[name]
    x = _rand((20, 40) if sd.ndim == 2 else (8, 10, 24), 21)
    adjoint.reset_lowering_counts()
    g1 = _sq_grads_torch(lambda a: ops.stencil(a, name, strategy="mxu"),
                         x)[0]
    g2 = _sq_grads_jax(lambda a: jops.stencil(a, name, impl="xla"), x)[0]
    _close(g1, g2)
    kind = "adj_stencil2d" if sd.ndim == 2 else "adj_stencil3d"
    assert adjoint.BACKWARD_LOWERINGS[kind] >= 1


def test_mxu_backward_runs_mxu_plans(monkeypatch):
    """dx of an mxu forward runs the mxu adjoint (the engine sees it
    pinned): a strided plan's through the phases, dW the weight-gradient
    correlation."""
    seen, phased = [], []
    real, real_phases = engine.run_window_plan, engine.run_adjoint_phases

    def spy(*a, **kw):
        seen.append(kw["plan"].strategy)
        return real(*a, **kw)

    def spy_phases(*a, **kw):
        phased.append(kw["plan"].strategy)
        return real_phases(*a, **kw)

    monkeypatch.setattr(engine, "run_window_plan", spy)
    monkeypatch.setattr(engine, "run_adjoint_phases", spy_phases)
    x = torch.randn(2, 3, 1, 20, requires_grad=True)
    w = torch.randn(5, 3, 1, 3, requires_grad=True)
    ops.conv2d(x, w, stride=(1, 2), epilogue="gelu",
               strategy="mxu").sum().backward()
    # forward and recomputed pre-activation; dx by the phases
    assert seen == ["mxu", "mxu"]
    assert phased == ["mxu"]
    # a stride-free mxu plan's dx runs its adjoint plan, pinned too
    seen.clear()
    x.grad = None
    ops.conv2d(x, w, epilogue="gelu", strategy="mxu").sum().backward()
    assert seen == ["mxu", "mxu", "mxu"] and phased == ["mxu"]


def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64,
                       requires_grad=True)


@pytest.mark.parametrize("stride", [(1, 1), (1, 2), (2, 2), (1, 3)],
                         ids=str)
def test_gradcheck_nchw_mxu(stride):
    x, w, b = _f64(2, 3, 4, 9), _f64(2, 3, 2, 3, seed=1), _f64(2, seed=2)
    assert torch.autograd.gradcheck(
        lambda xx, ww, bb: ops.conv2d(xx, ww, stride=stride,
                                      epilogue=("bias", "gelu"),
                                      epilogue_args=(bb,), strategy="mxu"),
        (x, w, b))


def test_gradcheck_single_channel_and_stencils_mxu():
    assert torch.autograd.gradcheck(
        lambda xx, ww: ops.conv2d(xx, ww, mode="same", strategy="mxu"),
        (_f64(2, 7, 8), _f64(3, 3, seed=1)))
    for t in (1, 2):
        assert torch.autograd.gradcheck(
            lambda xx: ops.stencil(xx, "2d13pt", time_steps=t,
                                   strategy="mxu"), (_f64(9, 10, seed=3),))
    assert torch.autograd.gradcheck(
        lambda xx: ops.stencil(xx, "3d7pt", strategy="mxu"),
        (_f64(4, 5, 6, seed=4),))


# --- K2's launch geometry, computed on the CPU ------------------------------

def test_mxu_launch_geometry():
    """K2's channel path at the Whisper stem's shapes (its layout, see
    also tests/test_torch_mxu_tc.py), and the single-channel path's."""
    stem = dataclasses.replace(
        ssam_conv2d.plan_for_nchw((8, 512, 1, 3000), (512, 512, 1, 3),
                                  "same"), stride=(1, 2), strategy="mxu")
    lay = engine.mxu_tc_layout((engine.forward_phase(stem, (1, 3000)),),
                               batch=8, c_in=512, c_out=512, fsz=3,
                               read_stride=(1, 2))
    assert (engine.MXU_TC_POS, engine.MXU_TC_CO, lay.co_tiles) == (128, 128, 4)
    assert lay.grid == (12, 1, 8 * 4) and lay.slabs == 16
    assert len(lay.kcols) == 16 * 3 * 32 and lay.smem <= engine.SMEM_LIMIT
    # 127 positions at stride 2, 3 taps, up to 3 columns of alignment
    assert lay.row_len == 264 and lay.rows == 1 and not lay.x_per_kblock
    # taps in plan order: (dz, row, col, coefficient index)
    p = dataclasses.replace(_plans("2d5pt")[1], strategy="mxu")
    tab = engine.mxu_tap_table(p, None)
    assert len(tab) == 4 * 5 and tab[2::4] == (0, 1, 1, 1, 2)
    for name in NAMES:
        for t in (1, 2):
            pl = dataclasses.replace(_plans(name)[1], strategy="mxu")
            blk = engine.default_block(pl, t)
            assert engine.mxu_smem_bytes(pl, blk, t) <= engine.SMEM_LIMIT // 2
    # a filter of more than 1024 taps is held: K2 streams its B tiles
    big = dataclasses.replace(ssam_conv2d.plan_for((33, 33)), strategy="mxu")
    assert len(engine.mxu_tap_table(big, (33, 33))) == 4 * 33 * 33
    assert engine.mxu_streamed(big) and engine.mxu_chain_refusal(big) is None
    with pytest.raises(ValueError, match="no taps"):
        engine.mxu_tap_table(dataclasses.replace(big, steps=()), (33, 33))
