"""The port's NCHW convolution (reduce axes, output stride, epilogues) and
the gradients of the windowed ops, on the CPU, against the JAX package.

The forward is held to ``repro.kernels.ops.conv2d(..., impl="xla")``,
with ``torch.nn.functional.conv2d`` as a third witness; ``dx``, ``dW``
and the bias gradient to ``jax.grad`` of that oracle. The JAX windowed
engine itself is never called (it needs ``pl.Unblocked``, ROADMAP R1).
fp64 ``torch.autograd.gradcheck`` runs on tiny shapes. Tolerance: fp32
``rtol = 3e-5, atol = 3e-5·max|ref|`` (DESIGN.md §6), bf16 3e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import _build
from repro_torch.core import engine, plan
from repro_torch.kernels import ops, ref, ssam_conv2d

EPILOGUES = [None, ("bias",), ("gelu",), ("silu",), ("relu",),
             (("scale", 0.5),), ("bias", "gelu")]
STRIDES = [(1, 1), (1, 2), (2, 2)]


def _close(got, want, rtol=3e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _data(x_shape, w_shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal(w_shape).astype(np.float32)
    b = rng.standard_normal(w_shape[:1]).astype(np.float32)
    return x, w, b


def _epi_args(epi, b):
    return (b,) if epi and "bias" in epi else ()


def _library(x, w, b, mode, stride, epi):
    """The same function as torch's own convolution (CPU, fp32)."""
    N, M = w.shape[2:]
    if mode == "same":
        x = F.pad(x, ((M - 1) // 2, M - 1 - (M - 1) // 2,
                      (N - 1) // 2, N - 1 - (N - 1) // 2))
    y = F.conv2d(x, w, stride=stride)
    for st in epi or ():
        if st == "bias":
            y = y + b[:, None, None]
        elif st == "gelu":
            y = F.gelu(y, approximate="tanh")
        elif st == "silu":
            y = F.silu(y)
        elif st == "relu":
            y = F.relu(y)
        else:
            y = y * st[1]
    return y


@pytest.mark.parametrize("epi", EPILOGUES, ids=str)
@pytest.mark.parametrize("stride", STRIDES, ids=str)
@pytest.mark.parametrize("mode", ["same", "valid"])
def test_nchw_forward_matches_reference(mode, stride, epi):
    x, w, b = _data((2, 5, 9, 23), (4, 5, 3, 3))
    args = _epi_args(epi, b)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), mode=mode,
                     stride=stride, epilogue=epi,
                     epilogue_args=tuple(map(torch.from_numpy, args)))
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), mode=mode,
                       stride=stride, epilogue=epi,
                       epilogue_args=tuple(map(jnp.asarray, args)),
                       impl="xla")
    _close(got, want)
    _close(got, _library(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), mode, stride, epi))


@pytest.mark.parametrize("variant", engine.VARIANTS)
@pytest.mark.parametrize("block", [None, (1, 5), (3, 4)], ids=str)
def test_nchw_stem_shapes_and_blocks(block, variant):
    """The Whisper stem's (1, 3) filters on an H = 1 grid, any block walk,
    both variants: one function."""
    x, w, b = _data((2, 6, 1, 40), (7, 6, 1, 3), seed=1)
    for stride in ((1, 1), (1, 2)):
        got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         stride=stride, block=block, variant=variant,
                         epilogue=("bias", "gelu"),
                         epilogue_args=(torch.from_numpy(b),))
        want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                           epilogue=("bias", "gelu"),
                           epilogue_args=(jnp.asarray(b),), impl="xla")
        _close(got, want)


@pytest.mark.parametrize("mode", ["same", "valid"])
def test_ref_conv2d_nchw_matches_reference(mode):
    x, w, _ = _data((2, 3, 8, 11), (5, 3, 2, 4), seed=2)
    for stride in STRIDES:
        want = jref.conv2d_nchw(jnp.asarray(x), jnp.asarray(w), mode)
        want = np.asarray(want)[..., ::stride[0], ::stride[1]]
        _close(ref.conv2d_nchw(torch.from_numpy(x), torch.from_numpy(w),
                               mode, stride), want)
    _close(ssam_conv2d.conv2d_nchw(torch.from_numpy(x), torch.from_numpy(w),
                                   mode=mode),
           jref.conv2d_nchw(jnp.asarray(x), jnp.asarray(w), mode))


def test_nchw_bf16_io_on_the_plain_path():
    x, w, b = _data((2, 8, 1, 50), (6, 8, 1, 3), seed=3)
    xt = torch.from_numpy(x).bfloat16()
    got = ops.conv2d(xt, torch.from_numpy(w), stride=(1, 2),
                     epilogue=("bias", "gelu"),
                     epilogue_args=(torch.from_numpy(b),))
    assert got.dtype == torch.bfloat16
    want = jops.conv2d(jnp.asarray(xt.float().numpy()), jnp.asarray(w),
                       stride=(1, 2), epilogue=("bias", "gelu"),
                       epilogue_args=(jnp.asarray(b),), impl="xla")
    _close(got.float(), want, rtol=3e-2)


# --- gradients against jax.grad of the impl="xla" oracle --------------------

GRAD_CASES = [
    ("same", (1, 1), None, (1, 3)),
    ("same", (1, 2), ("bias", "gelu"), (1, 3)),
    ("valid", (1, 1), ("bias", "silu"), (3, 2)),
    ("same", (2, 2), ("relu",), (3, 3)),
    ("valid", (2, 1), (("scale", 0.5),), (2, 3)),
]


@pytest.mark.parametrize("mode,stride,epi,fil", GRAD_CASES, ids=str)
def test_nchw_gradients_match_jax_grad(mode, stride, epi, fil):
    x, w, b = _data((2, 3, 7, 17), (4, 3) + fil, seed=4)
    has_b = epi is not None and "bias" in epi
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = ops.conv2d(xt, wt, mode=mode, stride=stride, epilogue=epi,
                   epilogue_args=(bt,) if has_b else ())
    gy = np.random.default_rng(5).standard_normal(tuple(y.shape)).astype(
        np.float32)
    y.backward(torch.from_numpy(gy))

    def jloss(xx, ww, bb):
        yy = jops.conv2d(xx, ww, mode=mode, stride=stride, epilogue=epi,
                         epilogue_args=(bb,) if has_b else (), impl="xla")
        return jnp.sum(yy * gy)

    jdx, jdw, jdb = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(xt.grad, jdx)
    _close(wt.grad, jdw)
    if has_b:
        _close(bt.grad, jdb)
    else:
        assert bt.grad is None


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("mode", ["same", "valid"])
def test_single_channel_conv_gradients_match_jax_grad(mode, rank):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 12, 19)[3 - rank:]).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = ops.conv2d(xt, wt, mode=mode)
    gy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    y.backward(torch.from_numpy(gy))
    jdx, jdw = jax.jit(jax.grad(lambda xx, ww: jnp.sum(jops.conv2d(
        xx, ww, mode=mode, impl="xla") * gy), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    _close(xt.grad, jdx)
    _close(wt.grad, jdw)


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("name", ["2d9pt", "2d64pt", "3d27pt"])
def test_stencil_gradients_match_jax_grad(name, t):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((9, 14) if name.startswith("2d")
                            else (6, 7, 9)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = ops.stencil(xt, name, time_steps=t)
    gy = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    y.backward(torch.from_numpy(gy))
    jdx = jax.jit(jax.grad(lambda xx: jnp.sum(jops.stencil(
        xx, name, time_steps=t, impl="xla") * gy)))(jnp.asarray(x))
    _close(xt.grad, jdx)


def test_weight_grad_reference_layouts():
    """The plain weight gradient in both layouts, against jax.grad of
    the oracle with respect to the filter."""
    x, w, _ = _data((2, 3, 6, 13), (5, 3, 3, 2), seed=8)
    p = ssam_conv2d.plan_for_nchw(x.shape, w.shape, "same")
    g = np.random.default_rng(9).standard_normal((2, 5, 6, 13)).astype(
        np.float32)
    got = engine.run_weight_grad_plan(torch.from_numpy(x),
                                      torch.from_numpy(g), plan=p)
    want = jax.grad(lambda ww: jnp.sum(jref.conv2d_nchw(
        jnp.asarray(x), ww, "same") * g))(jnp.asarray(w))
    assert got.dtype == torch.float32
    _close(got, want)
    got2 = engine.run_weight_grad_plan(
        torch.from_numpy(x[0, 0]), torch.from_numpy(g[0, 0]),
        plan=ssam_conv2d.plan_for((3, 2), "same"))
    want2 = jax.grad(lambda ww: jnp.sum(jref.conv2d_same(
        jnp.asarray(x[0, 0]), ww) * g[0, 0]))(jnp.asarray(w[0, 0]))
    _close(got2, want2)
    with pytest.raises(ValueError, match="not the output"):
        engine.run_weight_grad_plan(torch.from_numpy(x),
                                    torch.from_numpy(g[..., :-1]), plan=p)
    with pytest.raises(ValueError, match="no weight gradient"):
        engine.run_weight_grad_plan(torch.from_numpy(x[0, 0]),
                                    torch.from_numpy(g[0, 0]),
                                    plan=plan.stencil2d_plan(((0, 0),),
                                                             coeffs=(1.0,)))
    # the per-lane layout (K4's plain version) runs since K4 is ported
    xl = np.random.default_rng(10).standard_normal((2, 8, 4)).astype(
        np.float32)
    wl = np.random.default_rng(11).standard_normal((3, 4)).astype(np.float32)
    got3 = engine.run_weight_grad_plan(torch.from_numpy(xl),
                                       torch.from_numpy(xl[::-1].copy()),
                                       plan=plan.depthwise_conv1d_plan(3))
    want3 = jax.grad(lambda ww: jnp.sum(jref.conv1d_causal(
        jnp.asarray(xl), ww) * xl[::-1]))(jnp.asarray(wl))
    _close(got3, want3)


# --- fp64 gradcheck on the plain path ------------------------------------

def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64,
                       requires_grad=True)


@pytest.mark.parametrize("stride", [(1, 1), (1, 2), (2, 2)], ids=str)
def test_gradcheck_nchw(stride):
    x, w, b = _f64(2, 3, 4, 9), _f64(2, 3, 2, 3, seed=1), _f64(2, seed=2)
    assert torch.autograd.gradcheck(
        lambda xx, ww, bb: ops.conv2d(xx, ww, stride=stride,
                                      epilogue=("bias", "gelu"),
                                      epilogue_args=(bb,)), (x, w, b))


def test_gradcheck_single_channel_and_stencils():
    assert torch.autograd.gradcheck(
        lambda xx, ww: ops.conv2d(xx, ww, mode="valid"),
        (_f64(2, 7, 8), _f64(3, 2, seed=1)))
    for t in (1, 2):
        assert torch.autograd.gradcheck(
            lambda xx: ops.stencil(xx, "2d13pt", time_steps=t),
            (_f64(9, 10, seed=3),))
    assert torch.autograd.gradcheck(lambda xx: ops.stencil(xx, "3d7pt"),
                                    (_f64(4, 5, 6, seed=4),))


# --- errors and the CPU path ---------------------------------------------

def test_conv2d_bad_calls_raise():
    x, w = torch.zeros(1, 2, 4, 9), torch.zeros(3, 2, 1, 3)
    with pytest.raises(ValueError, match="per-C_out"):
        ops.conv2d(x, w, epilogue="bias", epilogue_args=(torch.zeros(2),))
    with pytest.raises(ValueError, match="runtime operand"):
        ops.conv2d(x, w, epilogue="bias")
    with pytest.raises(ValueError, match="stride"):
        ops.conv2d(x, w, stride=(0, 1))
    with pytest.raises(ValueError, match="OIHW"):
        ops.conv2d(x, torch.zeros(1, 3))
    with pytest.raises(NotImplementedError, match="item 4"):
        ops.conv2d(x, w, groups=2)
    with pytest.raises(NotImplementedError, match="item 4"):
        ops.conv2d(torch.zeros(4, 9), torch.zeros(1, 3), stride=2)
    with pytest.raises(ValueError, match="temporal blocking"):
        p = ssam_conv2d.plan_for_nchw(x.shape, w.shape)
        engine.run_window_plan(x, w, plan=p, time_steps=2)
    xt = torch.zeros(3, 9, 9, requires_grad=True)
    y = ops.window_op(plan.conv2d_batched_plan(3, 3), xt,
                      torch.ones(3, 3, requires_grad=True), time_steps=2)
    with pytest.raises(ValueError, match="temporally-blocked"):
        y.sum().backward()


def test_cpu_training_never_loads_the_kernels():
    x = torch.randn(2, 3, 1, 12)
    w = torch.randn(4, 3, 1, 3, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    ops.conv2d(x, w, stride=(1, 2), epilogue=("bias", "gelu"),
               epilogue_args=(b,)).sum().backward()
    assert w.grad is not None and b.grad is not None
    assert not _build.LIBRARY.loaded
    assert engine.WINDOW_KERNEL.launches == engine.WGRAD_KERNEL.launches == 0


# --- K1's reduce path and K3: launch geometry, computed on the CPU ----------

def test_reduce_and_wgrad_launch_geometry():
    stem = dataclasses.replace(
        ssam_conv2d.plan_for_nchw((8, 512, 1, 3000), (512, 512, 1, 3),
                                  "same"), stride=(1, 2))
    assert engine.reduce_tap_table(stem) == (0, 0, 0, 0, 1, 1, 0, 2, 2)
    ci_t, smem = engine.reduce_smem_plan(stem, 3, 512)
    assert ci_t == 16 and smem == 4 * (12 + 16 * (3 * 32 + 257))
    # the input adjoint reads the reflected taps of the same filter
    from repro_torch.core import adjoint
    a = adjoint.input_adjoint_plan(dataclasses.replace(stem, stride=None))
    assert engine.reduce_tap_table(a) == (0, 0, 2, 0, 1, 1, 0, 2, 0)
    lay = engine.wgrad_layout(8, 512, 512, 1, 3000, 1, 3)
    assert (lay.cr, lay.cg, lay.rg, lay.ph) == (4, 8, 32, 1)
    assert lay.grid == (12, 16, 3) and lay.chunks == 8 * 47
    lay = engine.wgrad_layout(8, 80, 512, 1, 3000, 1, 3)
    assert lay.grid == (2, 16, 17)
    lay = engine.wgrad_layout(1, 1, 1, 8192, 8192, 5, 5)
    assert (lay.cr, lay.cg, lay.rg, lay.ph) == (1, 1, 8, 32)
    assert lay.grid == (1, 1, engine.WGRAD_TARGET_BLOCKS)
    assert lay.smem <= engine.SMEM_LIMIT
