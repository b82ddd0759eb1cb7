"""The input adjoint of an output-strided convolution, phase by phase, and
the geometry of K1's channel-reduce kernel, on the CPU, against the JAX
package.

* ``dx`` of a strided NCHW convolution split into its ``sh·sw`` output
  phases (``adjoint.strided_input_adjoint_phases``), each run as a
  stride-1 plan through the plain version (of K1, or of K2 under
  ``strategy='mxu'``: both strategies), equals the scatter-then-adjoint
  formulation (the cotangent scattered onto the dense lattice, then the
  stride-free plan's input adjoint; kept here as the oracle) and
  ``jax.grad`` of ``repro.kernels.ops.conv2d(..., impl="xla")``, across
  strides, filters (a 1x2 filter at stride 3 leaves a phase no tap
  reaches), 'same' and 'valid' (trailing columns no output reads) and
  with or without an epilogue. The JAX windowed engine is never called
  (it needs ``pl.Unblocked``, ROADMAP R1).
* The kernel's tap table and layout (``engine.reduce_layout``): a CPU
  walk of its blocks that stages each input row from the 16-byte aligned
  element at or below its first read, as the cp.async copies do, reads
  the register windows at the table's offsets and stores the phases at
  the output stride, equals the plain version and writes every output
  once, at row pitches that are not multiples of 16 bytes too.

Tolerance: fp32 ``rtol = 3e-5, atol = 3e-5·max|ref|`` (DESIGN.md §6),
bf16 3e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import adjoint, engine
from repro_torch.kernels import ops, ssam_conv2d

STRIDES = [(1, 2), (2, 1), (2, 2), (1, 3), (3, 3)]
FILTERS = [(1, 3), (3, 3), (2, 5), (1, 2), (5, 5)]
EPILOGUES = [None, ("bias", "gelu")]
X_SHAPE = (2, 3, 7, 18)       # 'valid' leaves trailing columns unread
C_OUT = 4


def _close(got, want, rtol=3e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _plan(xs, ws, mode, stride, strategy=None):
    return dataclasses.replace(ssam_conv2d.plan_for_nchw(xs, ws, mode),
                               stride=None if stride == (1, 1) else stride,
                               strategy=strategy)


def _scattered_dx(g, wa, plan, in_spatial):
    """The oracle: the cotangent scattered onto the dense output lattice,
    then the stride-free plan's input adjoint through the plain version."""
    dense = dataclasses.replace(plan, stride=None)
    gd = g.new_zeros(g.shape[:-2] + dense.out_shape(tuple(in_spatial)))
    sh, sw = plan.stride_per_axis()
    gd[..., ::sh, ::sw] = g
    return engine.run_window_plan_reference(
        gd, wa, plan=adjoint.input_adjoint_plan(dense))


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("epi", EPILOGUES, ids=str)
@pytest.mark.parametrize("mode", ["same", "valid"])
@pytest.mark.parametrize("fil", FILTERS, ids=str)
@pytest.mark.parametrize("stride", STRIDES, ids=str)
def test_phased_dx_matches_scatter_and_jax_grad(stride, fil, mode, epi,
                                                strategy):
    """Under either strategy (the phase plans keep it: mxu phases run the
    plain version of K2, lanes phases K1's)."""
    ws = (C_OUT, X_SHAPE[1]) + fil
    rng = np.random.default_rng(40)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    b = rng.standard_normal(C_OUT).astype(np.float32)
    p = _plan(X_SHAPE, ws, mode, stride, strategy)
    gy = rng.standard_normal((X_SHAPE[0], C_OUT) + p.out_shape(
        X_SHAPE[2:])).astype(np.float32)
    has_b = epi is not None
    # the linear part: phases through the plain version against the oracle
    g, wa = torch.from_numpy(gy), adjoint.adjoint_coeff_array(
        p, torch.from_numpy(w))
    dx = engine.run_adjoint_phases(g, wa, plan=p, in_spatial=X_SHAPE[2:])
    _close(dx, _scattered_dx(g, wa, p, X_SHAPE[2:]))
    if strategy == "mxu":
        _close(dx, engine.run_adjoint_phases(
            g, wa, plan=dataclasses.replace(p, strategy="lanes"),
            in_spatial=X_SHAPE[2:]))
    # the op's gradient (its dx through the phases) against jax.grad
    xt = torch.from_numpy(x).requires_grad_()
    y = ops.conv2d(xt, torch.from_numpy(w), mode=mode, stride=stride,
                   epilogue=epi, strategy=strategy,
                   epilogue_args=(torch.from_numpy(b),) if has_b else ())
    y.backward(torch.from_numpy(gy))

    def jloss(xx):
        yy = jops.conv2d(xx, jnp.asarray(w), mode=mode, stride=stride,
                         epilogue=epi,
                         epilogue_args=(jnp.asarray(b),) if has_b else (),
                         impl="xla")
        return jnp.sum(yy * gy)

    _close(xt.grad, jax.grad(jloss)(jnp.asarray(x)))
    if not has_b:
        _close(dx, xt.grad)
    if mode == "valid" and stride[1] == 2 and fil[1] == 3:
        # W = 18, k = 3, stride 2: no output reads column 17
        assert not xt.grad[..., -1].any()


def test_phase_tables():
    # stride 3 against a filter of width 2: column phase 2 has no tap
    p = _plan((1, 2, 1, 12), (3, 2, 1, 2), "valid", (1, 3))
    phases = adjoint.strided_input_adjoint_phases(p)
    assert [ph.offset for ph in phases] == [(0, 0), (0, 1), (0, 2)]
    assert [len(ph.taps) for ph in phases] == [1, 1, 0]
    assert phases[2].plan is None
    g = torch.randn(1, 3, 1, 4)
    wa = adjoint.adjoint_coeff_array(p, torch.randn(3, 2, 1, 2))
    dx = engine.run_adjoint_phases_reference(g, wa, plan=p,
                                             in_spatial=(1, 12))
    assert not dx[..., 2::3].any() and dx[..., 0::3].abs().sum() > 0
    # stride on both axes: four phases of a 3x3 'same' filter take 1, 2, 2
    # and 4 taps; together every tap once
    p = _plan((1, 2, 7, 9), (3, 2, 3, 3), "same", (2, 2))
    phases = adjoint.strided_input_adjoint_phases(p)
    assert [len(ph.taps) for ph in phases] == [1, 2, 2, 4]
    assert sorted(t[2] for ph in phases for t in ph.taps) == [
        (n, m) for n in range(3) for m in range(3)]
    # phase (1, 1): taps (n, m) in plan (column-major) order, each at
    # cotangent offset ((1 + 1 - n) / 2, (1 + 1 - m) / 2)
    assert phases[3].taps == ((1, 1, (0, 0)), (0, 1, (2, 0)),
                              (1, 0, (0, 2)), (0, 0, (2, 2)))
    assert phases[3].plan.exts == (2, 2) and phases[3].extent((7, 9)) == (3, 4)
    # stride greater than the filter: phases hold one tap or none
    p = _plan((1, 2, 8, 8), (3, 2, 2, 2), "valid", (3, 3))
    assert [len(ph.taps) for ph in adjoint.strided_input_adjoint_phases(
        p)] == [1, 1, 0, 1, 1, 0, 0, 0, 0]
    # the mxu strategy takes the same phases (the plain version of K2 on
    # each phase plan): equal to the lanes phases
    g = torch.randn(1, 3, 3, 3)
    wa = adjoint.adjoint_coeff_array(p, torch.randn(3, 2, 2, 2))
    mxu = dataclasses.replace(p, strategy="mxu")
    got = engine.run_adjoint_phases(g, wa, plan=mxu, in_spatial=(8, 8))
    _close(got, engine.run_adjoint_phases(g, wa, plan=p, in_spatial=(8, 8)))
    assert {ph.plan.strategy for ph in adjoint.strided_input_adjoint_phases(
        mxu) if ph.plan} == {"mxu"}


def test_groups_of_a_wide_filter():
    # a 2x5 filter: per row two register windows (columns 0-2, 3-4)
    p = _plan((1, 2, 6, 30), (3, 2, 2, 5), "same", (1, 1))
    dcmin, rows, groups = engine.reduce_groups(engine.forward_phase(
        p, (6, 30)))
    assert dcmin == -2 and rows == (0, 1)
    assert groups == ((0, 0, 0, 2, 4), (1, 0, 1, 3, 5), (0, 3, 6, 8, -1),
                      (1, 3, 7, 9, -1))


# --- a CPU walk of K1's reduce kernel ----------------------------------------

def _walk(x4, w, phases, read_stride, out_stride, out_spatial, lay):
    """What csrc/ssam_window_reduce.cu computes, block by block, from the
    tap table and the layout: rows staged from their aligned start with
    the shift applied at the read, register windows at the group offsets,
    phases stored at the output stride. Returns the output and how often
    each position was written."""
    B, Cr, H, W = x4.shape
    Co, fsz = w.shape[0], w.shape[2] * w.shape[3]
    E = 16 // x4.element_size()
    flat = x4.float().reshape(-1)
    wf = w.float().reshape(Co, Cr, fsz)
    sh, sw = read_stride
    osh, osw = out_stride
    t = lay.table
    out = torch.zeros((B, Co) + tuple(out_spatial))
    hits = torch.zeros(out.shape[2:], dtype=torch.int64)
    for pi in range(len(phases)):
        py, px, hq, wq, ntaps, nrows, ngroups, dcmin, off, _ = \
            t[10 * pi:10 * pi + 10]
        tapk = t[off:off + ntaps]
        rowdr = t[off + ntaps:off + ntaps + nrows]
        gbase = off + ntaps + nrows
        groups = [t[gbase + 5 * i:gbase + 5 * i + 5] for i in range(ngroups)]
        for oy in range(lay.grid[1]):
            for bx in range(lay.grid[0]):
                ox0 = bx * lay.cols
                if oy >= hq or ox0 >= wq:
                    continue
                ix0 = ox0 * sw + dcmin
                acc = torch.zeros(B, Co, lay.cols)
                for c in range(Cr):
                    for r, wo, *taps in groups:
                        gy = oy * sh + rowdr[r]
                        for b in range(B):
                            rb = ((b * Cr + c) * H + gy) * W
                            a0, shift = engine.staged_row_start(rb + ix0,
                                                                 x4.element_size())
                            e = torch.arange(a0, a0 + lay.row_elems)
                            ok = (e >= rb) & (e < rb + W) & (0 <= gy < H)
                            row = torch.where(ok, flat[e.clamp(0, flat.numel()
                                                              - 1)], 0.0)
                            for m, tap in enumerate(taps):
                                if tap < 0:
                                    continue
                                idx = shift + wo + torch.arange(
                                    lay.cols) * sw + m
                                assert int(idx.max()) < lay.row_elems
                                acc[b] += wf[:, c, tapk[tap], None] \
                                    * row[idx][None]
                n = min(lay.cols, wq - ox0)
                cols = (ox0 + torch.arange(n)) * osw + px
                out[:, :, oy * osh + py, cols] = acc[..., :n]
                hits[oy * osh + py, cols] += 1
    return out.to(x4.dtype), hits


WALK_CASES = [
    # (x shape, w shape, mode, stride, dtype): pitches of 17 and 257 fp32
    # columns and 150 bf16 columns (300 bytes) are not multiples of 16
    ((2, 5, 3, 17), (6, 5, 3, 3), "same", (1, 2), torch.float32),
    ((1, 3, 1, 257), (130, 3, 1, 3), "same", (1, 1), torch.float32),
    ((2, 4, 5, 150), (5, 4, 2, 5), "valid", (2, 3), torch.bfloat16),
    ((1, 2, 4, 300), (3, 2, 3, 3), "same", (1, 1), torch.float32),
]


@pytest.mark.parametrize("xs,ws,mode,stride,dtype", WALK_CASES, ids=str)
def test_reduce_kernel_walk(xs, ws, mode, stride, dtype, monkeypatch):
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal(ws).astype(np.float32))
    p = _plan(xs, ws, mode, stride)
    # the forward: one phase
    ph = engine.forward_phase(p, xs[2:])
    for cols in engine.REDUCE_COLS:       # every tile the wave model picks
        monkeypatch.setattr(engine, "REDUCE_COLS", (cols,))
        lay = engine.reduce_layout((ph,), batch=xs[0], c_in=xs[1],
                                   c_out=ws[0], read_stride=p.stride_per_axis(),
                                   elem_bytes=x.element_size())
        assert lay.cols == cols
        got, hits = _walk(x, w, (ph,), p.stride_per_axis(), (1, 1),
                          ph.extent, lay)
        assert bool((hits == 1).all())
        _close(got, engine.run_window_plan_reference(x, w, plan=p),
               3e-2 if dtype == torch.bfloat16 else 3e-5)
    monkeypatch.undo()
    # the strided adjoint: every phase in one walk, written in place
    if stride != (1, 1):
        g = torch.from_numpy(rng.standard_normal(
            (xs[0], ws[0]) + p.out_shape(xs[2:])).astype(np.float32)).to(dtype)
        wa = adjoint.adjoint_coeff_array(p, w)
        phases = engine.adjoint_reduce_phases(p, xs[2:])
        lay = engine.reduce_layout(phases, batch=xs[0], c_in=ws[0],
                                   c_out=xs[1], elem_bytes=x.element_size())
        got, hits = _walk(g, wa, phases, (1, 1), p.stride_per_axis(),
                          xs[2:], lay)
        assert bool((hits == 1).all())
        _close(got, engine.run_adjoint_phases_reference(
            g, wa, plan=p, in_spatial=xs[2:]),
            3e-2 if dtype == torch.bfloat16 else 3e-5)
