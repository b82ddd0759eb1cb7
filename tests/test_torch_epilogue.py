"""Fused epilogues on the port's single-channel and stencil plans, and
``residual_add`` on every windowed path, on the CPU, against the JAX
package.

Mirrors the reference's ``tests/test_fused.py::TestEpilogues``: every
operand-free op, a scalar bias and a residual on stencils at t ∈ {1, 2},
both variants, both strategies, the chain applied once after the last
application. The forward is held to ``repro.kernels.ops.stencil`` /
``conv2d`` / ``conv1d_causal`` at ``impl="xla"`` (the JAX windowed engine
is never called, ROADMAP R1), the gradients of x, w, the bias and the
residual to ``jax.grad`` of that form. Tolerance: forward fp32 ``rtol =
3e-5, atol = 3e-5·max|ref|``, gradients 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import _build
from repro_torch.core import engine, plan
from repro_torch.kernels import ops, ssam_conv1d, ssam_conv2d

CHAINS = ["gelu", "silu", "relu", ("scale", 2.5), ("bias",),
          ("bias", "relu"), ("gelu", "residual_add"),
          ("bias", "silu", "residual_add")]


def _close(got, want, rtol=3e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _args(chain, out_shape, seed):
    """The chain's runtime operands as numpy: a scalar bias of shape (1,),
    an output-shaped residual."""
    rng = np.random.default_rng(seed)
    out = []
    for st in plan.normalize_epilogue(chain):
        if st.op == "bias":
            out.append(rng.standard_normal((1,)).astype(np.float32))
        elif st.op == "residual_add":
            out.append(rng.standard_normal(out_shape).astype(np.float32))
    return tuple(out)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("variant", ["shift_psum", "shift_data"])
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("chain", CHAINS, ids=str)
def test_stencil_epilogue_matches_reference(chain, t, variant, strategy):
    x = np.random.default_rng(1).standard_normal((26, 60)).astype(np.float32)
    args = _args(chain, x.shape, 2)
    got = ops.stencil(torch.from_numpy(x), "2d9pt", time_steps=t,
                      variant=variant, epilogue=chain, strategy=strategy,
                      epilogue_args=tuple(map(torch.from_numpy, args)))
    want = jops.stencil(jnp.asarray(x), "2d9pt", time_steps=t, impl="xla",
                        epilogue=chain,
                        epilogue_args=tuple(map(jnp.asarray, args)))
    _close(got, want)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("t", [1, 2])
def test_3d_stencil_residual(t, strategy):
    x = np.random.default_rng(3).standard_normal((9, 12, 20)).astype(
        np.float32)
    chain = ("bias", "relu", "residual_add")
    args = _args(chain, x.shape, 4)
    got = ops.stencil(torch.from_numpy(x), "3d7pt", time_steps=t,
                      epilogue=chain, strategy=strategy,
                      epilogue_args=tuple(map(torch.from_numpy, args)))
    want = jops.stencil(jnp.asarray(x), "3d7pt", time_steps=t, impl="xla",
                        epilogue=chain,
                        epilogue_args=tuple(map(jnp.asarray, args)))
    _close(got, want)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("t", [1, 2])
def test_stencil_epilogue_gradients(t, strategy):
    """dx, the scalar bias's and the residual's gradients (in the
    operands' own shapes) against jax.grad of the xla form."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((20, 45)).astype(np.float32)
    b = rng.standard_normal((1,)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    chain = ("bias", "gelu", "residual_add")

    def f_jax(xx, bb, rr):
        y = jops.stencil(xx, "2d5pt", time_steps=t, impl="xla",
                         epilogue=chain, epilogue_args=(bb, rr))
        return jnp.sum(y * g)

    want = jax.grad(f_jax, (0, 1, 2))(*map(jnp.asarray, (x, b, r)))
    xt, bt, rt = (torch.from_numpy(v).requires_grad_(True)
                  for v in (x, b, r))
    y = ops.stencil(xt, "2d5pt", time_steps=t, epilogue=chain,
                    epilogue_args=(bt, rt), strategy=strategy)
    got = torch.autograd.grad(y, (xt, bt, rt), torch.from_numpy(g))
    for a, e, op in zip(got, want, (xt, bt, rt)):
        assert a.shape == op.shape and a.dtype == op.dtype
        _close(a, e, 1e-4)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("shape", [(18, 33), (2, 18, 33)], ids=str)
@pytest.mark.parametrize("mode", ["same", "valid"])
def test_single_channel_conv_epilogue(mode, shape, strategy):
    """Forward and the gradients of x, w, the scalar bias and the
    residual of a single-channel conv with a fused chain."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    chain = ("bias", "silu", ("scale", 0.5), "residual_add")
    p = (ssam_conv2d.plan_for if len(shape) == 2
         else ssam_conv2d.plan_for_batched)((3, 4), mode)
    out = shape[:-2] + p.out_shape(shape[-2:])
    b, r = _args(chain, out, 7)
    g = rng.standard_normal(out).astype(np.float32)

    def f_jax(xx, ww, bb, rr):
        y = jops.conv2d(xx, ww, mode=mode, impl="xla", epilogue=chain,
                        epilogue_args=(bb, rr))
        return jnp.sum(y * g), y

    (_, want_y), want = jax.value_and_grad(f_jax, (0, 1, 2, 3),
                                           has_aux=True)(
        *map(jnp.asarray, (x, w, b, r)))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, w, b, r)]
    y = ops.conv2d(ts[0], ts[1], mode=mode, epilogue=chain,
                   epilogue_args=tuple(ts[2:]), strategy=strategy)
    _close(y, want_y)
    got = torch.autograd.grad(y, ts, torch.from_numpy(g))
    for a, e in zip(got, want):
        _close(a, e, 1e-4)


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
def test_nchw_residual(strategy):
    """residual_add on the channel-reduce paths (K1's reduce kernel, K2's
    channel kernel): forward and the residual's gradient."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 9, 21)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    chain = ("bias", "gelu", "residual_add")
    for stride in (None, (2, 2)):
        p = dataclasses.replace(ssam_conv2d.plan_for_nchw(x.shape, w.shape,
                                                          "same"),
                                stride=stride)
        r = rng.standard_normal((2, 4) + p.out_shape(x.shape[2:])).astype(
            np.float32)
        g = rng.standard_normal(r.shape).astype(np.float32)
        jf = lambda rr: jnp.sum(g * jops.conv2d(
            jnp.asarray(x), jnp.asarray(w), impl="xla", stride=stride,
            epilogue=chain, epilogue_args=(jnp.asarray(b), rr)))
        rt = torch.from_numpy(r).requires_grad_(True)
        y = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                       stride=stride, epilogue=chain, strategy=strategy,
                       epilogue_args=(torch.from_numpy(b), rt))
        _close(y, jops.conv2d(jnp.asarray(x), jnp.asarray(w), impl="xla",
                              stride=stride, epilogue=chain,
                              epilogue_args=(jnp.asarray(b),
                                             jnp.asarray(r))))
        (gr,) = torch.autograd.grad(y, (rt,), torch.from_numpy(g))
        _close(gr, jax.grad(jf)(jnp.asarray(r)), 1e-4)


def test_perlane_residual():
    """residual_add on K1's per-lane path (its generic instance)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 31, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    chain = ("bias", "silu", "residual_add")
    p = dataclasses.replace(ssam_conv1d.plan_for(4),
                            epilogue=plan.normalize_epilogue(chain))
    assert engine.perlane_layout(p, 2, 31, 16, 4).chain == "generic"
    got = ops.conv1d_causal(torch.from_numpy(x), torch.from_numpy(w),
                            epilogue=chain, epilogue_args=(
                                torch.from_numpy(b), torch.from_numpy(r)))
    want = jops.conv1d_causal(jnp.asarray(x), jnp.asarray(w), impl="xla",
                              epilogue=chain, epilogue_args=(
                                  jnp.asarray(b), jnp.asarray(r)))
    _close(got, want)
    _close(engine.emulate_perlane_kernel(
        torch.from_numpy(x), torch.from_numpy(w), plan=p,
        epilogue_args=(torch.from_numpy(b), torch.from_numpy(r))), want)


@pytest.mark.parametrize("op", ["stencil", "conv2d"])
def test_wrong_operand_shapes_raise_as_the_reference(op):
    """The reference's named errors: a bias that is not a scalar, a
    residual that is not output-shaped (both packages raise ValueError
    naming the operand)."""
    x = np.zeros((12, 20), np.float32)
    w = np.zeros((3, 3), np.float32)
    cases = [(("bias",), (np.zeros((2,), np.float32),),
              "bias epilogue wants a scalar"),
             (("residual_add",), (np.zeros((12, 19), np.float32),),
              "residual_add epilogue wants an output-shaped")]
    for chain, args, msg in cases:
        if op == "stencil":
            jcall = lambda: jops.stencil(jnp.asarray(x), "2d5pt", impl="xla",
                                         epilogue=chain, epilogue_args=tuple(
                                             map(jnp.asarray, args)))
            tcall = lambda: ops.stencil(torch.from_numpy(x), "2d5pt",
                                        epilogue=chain, epilogue_args=tuple(
                                            map(torch.from_numpy, args)))
        else:
            jcall = lambda: jops.conv2d(jnp.asarray(x), jnp.asarray(w),
                                        impl="xla", epilogue=chain,
                                        epilogue_args=tuple(
                                            map(jnp.asarray, args)))
            tcall = lambda: ops.conv2d(torch.from_numpy(x),
                                       torch.from_numpy(w), epilogue=chain,
                                       epilogue_args=tuple(
                                           map(torch.from_numpy, args)))
        with pytest.raises(ValueError, match=msg):
            jcall()
        with pytest.raises(ValueError, match=msg):
            tcall()
    assert not _build.LIBRARY.loaded
