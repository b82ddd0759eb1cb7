"""Output strides on the port's single-channel convolution, on the CPU,
against the JAX package.

Mirrors the reference's ``tests/test_fused.py::TestStridedAndStem``: the
stride × mode sweep on ``(H, W)`` and ``(B, H, W)`` inputs, both
strategies, including the valid-mode tilings that need fewer input rows
than given (the origin-pad clamp). The forward is held to
``repro.kernels.ops.conv2d(..., impl="xla")`` (the dense correlation
subsampled: the JAX windowed engine is never called, ROADMAP R1), the
gradients of x, w, a scalar bias and a residual to ``jax.grad`` of that
form. The port computes only the kept outputs: its plain version reads
input ``l·s + cum`` for output ``l``, its dx runs phase by phase on the
cotangent as it is (``engine.run_adjoint_phases``), its dW per phase of x
(``engine.wgrad_phases``). Tolerance: forward fp32 ``rtol = 3e-5, atol =
3e-5·max|ref|``, gradients 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import _build
from repro_torch.core import adjoint, engine
from repro_torch.kernels import ops, ssam_conv2d

STRIDES = [2, (1, 2), (2, 1), (3, 3)]


def _close(got, want, rtol=3e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("shape", [(24, 64), (2, 23, 37)], ids=str)
@pytest.mark.parametrize("stride", STRIDES, ids=str)
@pytest.mark.parametrize("mode", ["same", "valid"])
def test_strided_forward_matches_reference(mode, stride, shape, strategy):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((3, 3)).astype(np.float32)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), mode=mode,
                     stride=stride, strategy=strategy)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), mode=mode,
                       stride=stride, impl="xla")
    _close(got, want)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("stride", [(2, 2), (1, 3), (3, 2)], ids=str)
@pytest.mark.parametrize("mode", ["same", "valid"])
def test_strided_gradients_match_jax(mode, stride, strategy):
    """dx, dW, the scalar bias's and the residual's gradients of a
    strided 5x4 with a fused chain against jax.grad of the xla form."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 19, 30)).astype(np.float32)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    b = rng.standard_normal((1,)).astype(np.float32)
    p = dataclasses.replace(ssam_conv2d.plan_for_batched((5, 4), mode),
                            stride=stride)
    out = (2,) + p.out_shape(x.shape[1:])
    r = rng.standard_normal(out).astype(np.float32)
    g = rng.standard_normal(out).astype(np.float32)
    chain = ("bias", "gelu", "residual_add")

    def f_jax(xx, ww, bb, rr):
        return jnp.sum(g * jops.conv2d(xx, ww, mode=mode, stride=stride,
                                       impl="xla", epilogue=chain,
                                       epilogue_args=(bb, rr)))

    want = jax.grad(f_jax, (0, 1, 2, 3))(*map(jnp.asarray, (x, w, b, r)))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, w, b, r)]
    adjoint.reset_lowering_counts()
    y = ops.conv2d(ts[0], ts[1], mode=mode, stride=stride, epilogue=chain,
                   epilogue_args=tuple(ts[2:]), strategy=strategy)
    got = torch.autograd.grad(y, ts, torch.from_numpy(g))
    for a, e in zip(got, want):
        _close(a, e, 1e-4)
    # dx phase by phase, dW through the weight-gradient plan
    assert adjoint.BACKWARD_LOWERINGS["adj_conv2d"] == 1
    assert adjoint.BACKWARD_LOWERINGS["wgrad_conv2d"] == 1


@pytest.mark.parametrize("stride", [(2, 2), (1, 2), (3, 3)], ids=str)
@pytest.mark.parametrize("mode", ["same", "valid"])
def test_phased_dx_never_scatters(mode, stride):
    """The single-channel phased dx equals the stride-free adjoint of the
    cotangent scattered onto the dense lattice, and its phases cover dx
    once: every phase is a stride-1 plan on g."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((21, 34)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 5)).astype(np.float32))
    p = dataclasses.replace(ssam_conv2d.plan_for((5, 5), mode), stride=stride)
    g = torch.from_numpy(rng.standard_normal(p.out_shape((21, 34))).astype(
        np.float32))
    dx = engine.run_adjoint_phases(g, w, plan=p, in_spatial=(21, 34))
    dense = dataclasses.replace(p, stride=None)
    full = torch.zeros(dense.out_shape((21, 34)))
    full[::stride[0], ::stride[1]] = g
    want = engine.run_window_plan(full, w, plan=adjoint.input_adjoint_plan(
        dense))
    _close(dx, want.numpy())
    cover = torch.zeros(21, 34, dtype=torch.int64)
    for ph in adjoint.strided_input_adjoint_phases(p):
        assert ph.plan is None or ph.plan.stride is None
        cover[ph.offset[0]::stride[0], ph.offset[1]::stride[1]] += 1
    assert bool((cover == 1).all())


@pytest.mark.parametrize("stride", [(2, 2), (1, 2), (2, 1), (3, 3)], ids=str)
def test_strided_weight_gradient_phases(stride):
    """dW of a strided plan as the stride-1 gradients of x's phase images
    (engine.wgrad_phases), against the plain strided correlation."""
    rng = np.random.default_rng(4)
    for mode, f in (("same", (5, 5)), ("valid", (4, 7)), ("same", (1, 3))):
        p = dataclasses.replace(ssam_conv2d.plan_for_batched(f, mode),
                                stride=stride)
        x = torch.from_numpy(rng.standard_normal((2, 17, 29)).astype(
            np.float32))
        g = torch.from_numpy(rng.standard_normal(
            (2,) + p.out_shape((17, 29))).astype(np.float32))
        phases = engine.wgrad_phases(p)
        assert sum(ph.n * ph.m for ph in phases) == f[0] * f[1]
        xph = engine.wgrad_phase_images(x, stride)
        want = engine.run_weight_grad_plan_reference(x, g, plan=p)
        for ph in phases:
            _close(_correlate(xph[ph.xphase], g, ph),
                   want[ph.offset[0]::stride[0],
                        ph.offset[1]::stride[1]].numpy(), 1e-4)


def _correlate(xp, g, ph):
    """The stride-1 correlation of one phase: ``dW[q] = Σ_o g[o]·X[o + q −
    lead]``, zero outside X."""
    ly, lx = ph.lead
    Ho, Wo = g.shape[1:]
    pad = torch.nn.functional.pad(xp, (lx, Wo + ph.m, ly, Ho + ph.n))
    out = torch.zeros(ph.n, ph.m)
    for n in range(ph.n):
        for m in range(ph.m):
            out[n, m] = (g * pad[:, n:n + Ho, m:m + Wo]).sum()
    return out


def test_strided_3d_plans_and_temporal_blocking_raise():
    from repro_torch.kernels import ssam_stencil3d, stencils
    p3 = dataclasses.replace(
        ssam_stencil3d.plan_for(stencils.BENCHMARKS["3d7pt"]),
        stride=(1, 2, 2))
    with pytest.raises(ValueError, match="single 2-D"):
        engine.run_window_plan(torch.zeros(6, 8, 10), plan=p3)
    p = dataclasses.replace(ssam_conv2d.plan_for((3, 3), "same"),
                            stride=(2, 2))
    with pytest.raises(ValueError, match="single 2-D"):
        engine.run_window_plan(torch.zeros(8, 10), torch.ones(3, 3), plan=p,
                               time_steps=2)
    assert not _build.LIBRARY.loaded
