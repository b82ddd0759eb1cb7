"""Gradients of the port's scan ops (``CumsumOp``, ``LinrecOp``,
``LinrecCarryOp`` and the streamed ``chunked_linear_recurrence``) against
``jax.grad`` of the JAX package's scan ops.

The JAX scan engine runs here through the Pallas interpreter (ROADMAP
R2), so ``jax.grad`` goes through the reference's own custom VJPs
(``_cumsum_op_bwd``, ``_linrec_op_bwd``, ``_linrec_carry_op_bwd``, the
``jax.checkpoint``-ed chunk stream) under the ``raise`` failure policy
(``tests/conftest.py``). The port's backward is its λ-recurrence through
the plain version of K5. Tolerance: fp32 rtol 1e-5 with atol
1e-5·max|ref| (the forward scan's tolerance: the same sums in another
tile order); fp64 ``gradcheck`` at its defaults.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import adjoint, engine
from repro_torch.kernels import ops

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return a, b, g


def _leaf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()


@functools.lru_cache(maxsize=None)
def _jax_grads(op, shape, seed, chunk=0):
    """``jax.grad`` of ``Σ g·op(...)`` through the reference's scan ops."""
    a, b, g = _data(shape, seed)
    if op == "cumsum":
        f = lambda bb: jnp.sum(jops.cumsum(bb, impl="interpret") * g)
        return jax.grad(f)(jnp.asarray(b))
    if op == "sat":
        f = lambda bb: jnp.sum(jops.sat(bb, impl="interpret") * g)
        return jax.grad(f)(jnp.asarray(b))
    if op == "linrec":
        f = lambda aa, bb: jnp.sum(
            jops.linear_recurrence(aa, bb, impl="interpret") * g)
    else:
        f = lambda aa, bb: jnp.sum(jops.chunked_linear_recurrence(
            aa, bb, chunk=chunk, impl=op) * g)
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))


@pytest.mark.parametrize("shape", [(5, 300), (3, 7), (16, 64)])
def test_cumsum_and_sat_gradients(shape):
    _, b, g = _data(shape, 0)
    x = _leaf(b)
    adjoint.reset_lowering_counts()
    (dx,) = torch.autograd.grad(ops.cumsum(x), x, torch.from_numpy(g))
    _close(dx, _jax_grads("cumsum", shape, 0))
    assert adjoint.BACKWARD_LOWERINGS["adj_scan"] == 1
    (ds,) = torch.autograd.grad(ops.sat(x), x, torch.from_numpy(g))
    _close(ds, _jax_grads("sat", shape, 0))


@pytest.mark.parametrize("shape", [(5, 300), (3, 7), (16, 64)])
def test_linear_recurrence_gradients(shape):
    a, b, g = _data(shape, 1)
    ta, tb = _leaf(a), _leaf(b)
    adjoint.reset_lowering_counts()
    da, db = torch.autograd.grad(ops.linear_recurrence(ta, tb), (ta, tb),
                                 torch.from_numpy(g))
    ja, jb = _jax_grads("linrec", shape, 1)
    _close(da, ja)
    _close(db, jb)
    assert dict(adjoint.BACKWARD_LOWERINGS) == {"adj_recurrence": 1}


@pytest.mark.parametrize("shape", [(6, 64), (4, 37)])
def test_linear_recurrence_carry_gradients(shape):
    """Both outputs carry a cotangent (``g`` on ``h``, ``gc`` on the
    carry-out), and the carry-in gets one: ``dh0 = a₀·λ₀``."""
    a, b, g = _data(shape, 2)
    rng = np.random.default_rng(3)
    h0 = rng.standard_normal((shape[0], 1)).astype(np.float32)
    gc = rng.standard_normal((shape[0], 1)).astype(np.float32)
    ta, tb, th = _leaf(a), _leaf(b), _leaf(h0)
    h, hT = ops.linear_recurrence_carry(ta, tb, th)
    got = torch.autograd.grad((h, hT), (ta, tb, th),
                              (torch.from_numpy(g), torch.from_numpy(gc)))

    def f(aa, bb, hh):
        jh, jhT = jops.linear_recurrence_carry(aa, bb, hh, impl="interpret")
        return jnp.sum(jh * g) + jnp.sum(jhT * gc)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (a, b, h0)))
    for x, y in zip(got, want):
        _close(x, y)


@pytest.mark.parametrize("impl,shape,chunk", [
    ("engine", (6, 300), 128), ("engine", (4, 96), 32),
    ("engine", (3, 40), 8), ("engine_unchunked", (6, 300), 128)])
def test_chunked_linear_recurrence_gradients(impl, shape, chunk):
    """The streamed schedule (each chunk checkpointed, the carry cotangent
    flowing chunk to chunk) and the monolithic one against the
    reference's, T not always a whole number of chunks."""
    a, b, g = _data(shape, 4)
    ta, tb = _leaf(a), _leaf(b)
    out = ops.chunked_linear_recurrence(ta, tb, chunk=chunk, impl=impl)
    da, db = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    ja, jb = _jax_grads(impl, shape, 4, chunk)
    _close(da, ja)
    _close(db, jb)


def test_streamed_backward_reruns_each_chunk_then_its_lambda(monkeypatch):
    """Per chunk the streamed backward runs the scan engine twice more: the
    checkpoint's recomputed forward and the reversed λ-recurrence (three
    calls a chunk in all, as K5 launches on the card)."""
    calls = []
    plain = engine.run_scan_plan_reference

    def count(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(engine, "run_scan_plan_reference", count)
    a, b, g = _data((4, 100), 5)
    ta, tb = _leaf(a), _leaf(b)
    out = ops.chunked_linear_recurrence(ta, tb, chunk=32)
    assert len(calls) == 4
    torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    assert len(calls) == 12 and all(s == (4, 32) for s in calls)


def test_gradcheck_fp64():
    gen = torch.Generator().manual_seed(6)
    a = (0.5 + 0.5 * torch.rand(3, 20, generator=gen, dtype=torch.float64)
         ).requires_grad_()
    b = torch.randn(3, 20, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    h0 = torch.randn(3, 1, generator=gen, dtype=torch.float64,
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda aa, bb: ops.chunked_linear_recurrence(aa, bb, chunk=8),
        (a, b))
    assert torch.autograd.gradcheck(
        lambda aa, bb, hh: ops.linear_recurrence_carry(aa, bb, hh),
        (a, b, h0))
    assert torch.autograd.gradcheck(lambda bb: ops.sat(bb), (b,))
