"""Parity of the port's depthwise causal conv1d (K1's per-lane path and K4,
through their plain versions) with the JAX package.

The JAX windowed engine cannot run here (ROADMAP R1), so the port is
held against the reference's oracle ``repro.kernels.ref.conv1d_causal``
with ``repro.core.adjoint.apply_epilogue`` replaying the fused epilogue,
against ``jax.grad`` of that composition for ``dx``, ``dW`` and the
bias, and, for the sums themselves, against the reference's kernel body
``engine._apply_plan_once`` on one block. Every reference call runs under
the ``raise`` failure policy (``tests/conftest.py``). Tolerances: fp32
rtol 3e-5 with atol 3e-5·max|ref| (DESIGN.md §6), bf16 3e-2; fp64
``gradcheck`` at its defaults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adjoint as jadj
from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.kernels import ref as jref
from repro_torch import _build
from repro_torch.core import adjoint, engine, plan
from repro_torch.kernels import ops, ref, ssam_conv1d

F32 = 3e-5
# (B, T, D, K): D not a multiple of the 128-lane tile, T < K, T not a
# multiple of the time tile, B > 1
SHAPES = [(2, 24, 100, 4), (3, 37, 100, 4), (1, 2, 5, 4), (2, 130, 40, 3),
          (1, 9, 3, 1), (2, 17, 33, 7)]
IDS = [f"{b}x{t}x{d}-K{k}" for b, t, d, k in SHAPES]


def _close(got, want, rtol=F32):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _data(B, T, D, K, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((K, D)) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    return x, w, b, g


def _jax_conv(x, w, b, epilogue):
    jp = dataclasses.replace(jplan.depthwise_conv1d_plan(w.shape[0]),
                             epilogue=jplan.normalize_epilogue(epilogue))
    y = jref.conv1d_causal(x, w)
    return jadj.apply_epilogue(jp, y, (b,) if "bias" in epilogue else ())


def _t(a, **kw):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(
        kw.get("grad", False))


# --- plans ----------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 4, 7])
def test_plan_and_its_adjoint_match_reference(K):
    """The port's builder, its input adjoint and weight adjoint equal the
    reference's by astuple: the adjoint reuses w unchanged, with the
    reflection in the taps' coeff_ids, and swaps lead=(K−1, 0) for
    trail=(K−1, 0)."""
    p, jp = ssam_conv1d.plan_for(K), jplan.depthwise_conv1d_plan(K)
    assert dataclasses.astuple(p) == dataclasses.astuple(jp)
    a = adjoint.input_adjoint_plan(p)
    assert dataclasses.astuple(a) == dataclasses.astuple(
        jadj.input_adjoint_plan(jp))
    assert a.lead is None and a.trail == ((K - 1, 0) if K > 1 else None)
    assert [(t.row_offset, t.coeff_id) for t in a.steps[0].taps] == [
        (r, (K - 1 - r,)) for r in range(K)]
    w = torch.randn(K, 6)
    assert adjoint.adjoint_coeff_array(p, w) is w
    np.testing.assert_array_equal(
        np.asarray(jadj.adjoint_coeff_array(jp, jnp.asarray(w.numpy()))),
        w.numpy())
    assert engine.perlane_row_table(p)[:K] == tuple(range(K))
    assert engine.perlane_row_table(a)[:K] == tuple(reversed(range(K)))


def test_row_table_limits_and_wgrad_layout():
    with pytest.raises(ValueError, match="up to 8 taps"):
        engine.perlane_row_table(plan.depthwise_conv1d_plan(9))
    # Hymba's (2, 2048, 3200): 25 lane tiles x 2 sequences x 11 slices of
    # 188 rows fill 4 blocks per SM of an H100
    rows, slices = engine.perlane_wgrad_layout(2, 2048, 3200)
    assert (rows, slices) == (188, 11) and rows * slices >= 2048
    assert engine.perlane_wgrad_layout(1, 5, 100) == (8, 1)
    for B, Tg, D in [(3, 37, 100), (1, 4096, 64), (8, 1, 3)]:
        r, s = engine.perlane_wgrad_layout(B, Tg, D)
        assert r % 4 == 0 and r * s >= Tg and r * (s - 1) < Tg


# --- the forward: the plain K1 per-lane walk --------------------------------

@pytest.mark.parametrize("B,T,D,K", SHAPES, ids=IDS)
@pytest.mark.parametrize("epilogue", [(), ("bias", "silu"), ("relu",),
                                      ("bias", "gelu", ("scale", 0.5))])
def test_forward_matches_reference_oracle(B, T, D, K, epilogue):
    x, w, b, _ = _data(B, T, D, K)
    args = (_t(b),) if "bias" in epilogue else ()
    got = ops.conv1d_causal(_t(x), _t(w), epilogue=epilogue or None,
                            epilogue_args=args)
    _close(got, _jax_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          epilogue))
    _close(ref.conv1d_causal(_t(x), _t(w)), jref.conv1d_causal(x, w))


@pytest.mark.parametrize("block", [(4, 32), (128, 128), (5, 7)])
def test_block_walk_equals_reference_kernel_body(block):
    """The plain version's block walk (any tiling) against the reference's
    ``_apply_plan_once`` on the whole lead-padded sequence as one block,
    both variants: the same per-lane sums."""
    x, w, _, _ = _data(2, 29, 45, 4, seed=1)
    p, jp = ssam_conv1d.plan_for(4), jplan.depthwise_conv1d_plan(4)
    xb = np.pad(x, ((0, 0), (3, 0), (0, 0)))
    for variant in engine.VARIANTS:
        want = np.stack([np.asarray(jengine._apply_plan_once(
            jnp.asarray(xb[i]), jp, jnp.asarray(w), variant, jnp.float32))
            for i in range(2)])
        got = engine.run_window_plan_reference(_t(x), _t(w), plan=p,
                                               block=block, variant=variant)
        _close(got, want)
        _close(engine.apply_plan_once(_t(xb), p, _t(w), variant), want)


def test_bf16_forward():
    x, w, b, _ = _data(2, 33, 70, 4, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    got = ops.conv1d_causal(xb, _t(w), epilogue=("bias", "silu"),
                            epilogue_args=(_t(b),))
    assert got.dtype == torch.bfloat16
    want = _jax_conv(jnp.asarray(xb.float().numpy()), jnp.asarray(w),
                     jnp.asarray(b), ("bias", "silu"))
    _close(got, want, 3e-2)


# --- the backward: dx through the adjoint plan, dW through K4's plain version

@pytest.mark.parametrize("B,T,D,K", SHAPES, ids=IDS)
def test_gradients_match_jax_grad(B, T, D, K):
    """``dx`` (the input-adjoint plan), ``dW`` (the per-lane weight
    gradient) and the bias gradient (the epilogue's VJP at the recomputed
    pre-activation) against ``jax.grad`` of the oracle with bias+SiLU."""
    x, w, b, g = _data(B, T, D, K, seed=3)
    tx, tw, tb = _t(x, grad=True), _t(w, grad=True), _t(b, grad=True)
    adjoint.reset_lowering_counts()
    y = ops.conv1d_causal(tx, tw, epilogue=("bias", "silu"),
                          epilogue_args=(tb,))
    dx, dw, db = torch.autograd.grad(y, (tx, tw, tb), _t(g))
    assert dict(adjoint.BACKWARD_LOWERINGS) == {"adj_conv1d": 1,
                                                "wgrad_conv1d": 1}

    def jloss(xx, ww, bb):
        return jnp.sum(_jax_conv(xx, ww, bb, ("bias", "silu")) * g)

    jdx, jdw, jdb = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(dx, jdx)
    _close(dw, jdw)
    _close(db, jdb)
    assert dw.dtype == torch.float32


@pytest.mark.parametrize("B,T,D,K", SHAPES[:4], ids=IDS[:4])
def test_weight_grad_plain_version_matches_jax_grad(B, T, D, K):
    """``run_weight_grad_plan`` on a per-lane plan (K4's plain version on
    the CPU) against ``jax.grad`` of the linear oracle, fp32 out; the
    cotangent must be the plan's output shape."""
    x, w, _, g = _data(B, T, D, K, seed=4)
    p = ssam_conv1d.plan_for(K)
    got = engine.run_weight_grad_plan(_t(x), _t(g), plan=p)
    want = jax.grad(lambda ww: jnp.sum(jref.conv1d_causal(
        jnp.asarray(x), ww) * g))(jnp.asarray(w))
    assert got.shape == (K, D) and got.dtype == torch.float32
    _close(got, want)
    with pytest.raises(ValueError, match="not the output"):
        engine.run_weight_grad_plan(_t(x), _t(g[:, :-1]), plan=p)
    with pytest.raises(ValueError, match="forward plan"):
        engine.run_weight_grad_plan(_t(g), _t(x),
                                    plan=adjoint.input_adjoint_plan(p))


def test_gradcheck_fp64():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 11, 6, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(4, 6, generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(6, generator=g, dtype=torch.float64, requires_grad=True)

    def f(xx, ww, bb):
        return ops.conv1d_causal(xx, ww, epilogue=("bias", "silu"),
                                 epilogue_args=(bb,), block=(4, 4))

    assert torch.autograd.gradcheck(f, (x, w, b))
    assert torch.autograd.gradcheck(
        lambda xx, ww: ops.conv1d_causal(xx, ww), (x[:, :2], w))


# --- what raises ------------------------------------------------------------

def test_bad_calls_raise():
    x, w = torch.zeros(1, 8, 5), torch.zeros(4, 5)
    with pytest.raises(ValueError, match="filter lanes"):
        ops.conv1d_causal(x, torch.zeros(4, 6))
    with pytest.raises(ValueError, match="per-lane"):
        ops.conv1d_causal(x, w, epilogue="bias",
                          epilogue_args=(torch.zeros(4),))
    with pytest.raises(ValueError, match="runtime operand"):
        ops.conv1d_causal(x, w, epilogue="bias")
    with pytest.raises(NotImplementedError, match="5c"):
        ops.conv1d_causal(x, w, strategy="mxu")
    with pytest.raises(ValueError, match="residual_add"):
        ops.conv1d_causal(x, w, epilogue="residual_add",
                          epilogue_args=(torch.zeros(1, 7, 5),))
    with pytest.raises(ValueError, match="M = 1"):
        engine.run_window_plan(x, torch.zeros(3, 5), plan=dataclasses.replace(
            plan.conv2d_plan(2, 3), coeff_mode="perlane", batch_axes=1))
    assert not _build.LIBRARY.loaded
    assert engine.WINDOW_KERNEL.launches == 0
    assert engine.PERLANE_WGRAD_KERNEL.launches == 0
