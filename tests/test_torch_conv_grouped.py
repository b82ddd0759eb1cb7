"""Grouped NCHW convolution (``ops.conv2d(groups=)``), on the CPU, against
the JAX package.

The port runs the reference's ``_conv2d_grouped``: one ordinary NCHW call
per group on its ``(C_in/groups, C_out/groups)`` slice of the operands, a
bias row and a residual sliced per group along C_out, the outputs
concatenated on C_out; ``groups == C_in`` is depthwise 2-D. The forward is
held to ``repro.kernels.ops.conv2d(..., groups=, impl="xla")`` and to
``torch.nn.functional.conv2d(groups=)``, the gradients of x, w, the bias
and the residual to ``jax.grad`` of the xla form. Tolerance: forward fp32
``rtol = 3e-5, atol = 3e-5·max|ref|``, gradients 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro_torch import _build
from repro_torch.kernels import ops


def _close(got, want, rtol=3e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _data(C_in, C_out, groups, seed, stride, mode):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, C_in, 9, 17)).astype(np.float32)
    w = rng.standard_normal((C_out, C_in // groups, 3, 3)).astype(np.float32)
    b = rng.standard_normal((C_out,)).astype(np.float32)
    Ho, Wo = ((9, 17) if mode == "same" else (7, 15))
    sh, sw = stride or (1, 1)
    out = (2, C_out, -(-Ho // sh), -(-Wo // sw))
    r = rng.standard_normal(out).astype(np.float32)
    g = rng.standard_normal(out).astype(np.float32)
    return x, w, b, r, g


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("stride", [None, (2, 2)], ids=str)
@pytest.mark.parametrize("mode", ["same", "valid"])
@pytest.mark.parametrize("groups,C_in,C_out", [(2, 4, 6), (4, 4, 8)],
                         ids=["groups2", "depthwise"])
def test_grouped_forward_matches_reference(groups, C_in, C_out, mode, stride,
                                           strategy):
    x, w, b, r, _ = _data(C_in, C_out, groups, 1, stride, mode)
    chain = ("bias", "relu", "residual_add")
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), mode=mode,
                     groups=groups, stride=stride, epilogue=chain,
                     epilogue_args=(torch.from_numpy(b), torch.from_numpy(r)),
                     strategy=strategy)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), mode=mode,
                       groups=groups, stride=stride, impl="xla",
                       epilogue=chain,
                       epilogue_args=(jnp.asarray(b), jnp.asarray(r)))
    _close(got, want)
    # torch's own grouped convolution as a third witness
    pad = 1 if mode == "same" else 0
    lib = F.relu(F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), stride=stride or 1,
                          padding=pad, groups=groups)) + torch.from_numpy(r)
    _close(got, lib.numpy())


@pytest.mark.parametrize("strategy", ["lanes", "mxu"])
@pytest.mark.parametrize("groups,C_in,C_out", [(2, 4, 6), (4, 4, 4)],
                         ids=["groups2", "depthwise"])
def test_grouped_gradients_match_jax(groups, C_in, C_out, strategy):
    """dx, dW, the bias row's and the residual's gradients, sliced per
    group and concatenated, against jax.grad of the xla form."""
    x, w, b, r, g = _data(C_in, C_out, groups, 2, (1, 2), "same")
    chain = ("bias", "gelu", "residual_add")

    def f_jax(xx, ww, bb, rr):
        return jnp.sum(g * jops.conv2d(xx, ww, groups=groups, stride=(1, 2),
                                       impl="xla", epilogue=chain,
                                       epilogue_args=(bb, rr)))

    want = jax.grad(f_jax, (0, 1, 2, 3))(*map(jnp.asarray, (x, w, b, r)))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, w, b, r)]
    y = ops.conv2d(ts[0], ts[1], groups=groups, stride=(1, 2),
                   epilogue=chain, epilogue_args=tuple(ts[2:]),
                   strategy=strategy)
    got = torch.autograd.grad(y, ts, torch.from_numpy(g))
    for a, e, t in zip(got, want, ts):
        assert a.shape == t.shape
        _close(a, e, 1e-4)


def test_grouped_named_errors_match_the_reference():
    """A non-4-D input, a non-OIHW filter and channel counts that groups
    do not divide raise the reference's named ValueErrors."""
    x4, w4 = np.zeros((1, 4, 6, 8), np.float32), np.zeros((6, 2, 3, 3),
                                                           np.float32)
    cases = [
        (np.zeros((6, 8), np.float32), np.zeros((3, 3), np.float32), 2,
         "4-D NCHW input"),
        (x4, np.zeros((3, 3), np.float32), 2, "OIHW"),
        (x4, np.zeros((6, 3, 3, 3), np.float32), 2, "filter expects C_in"),
        (x4, np.zeros((5, 2, 3, 3), np.float32), 2, "must divide both"),
    ]
    for x, w, groups, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jops.conv2d(jnp.asarray(x), jnp.asarray(w), groups=groups,
                        impl="xla")
        with pytest.raises(ValueError, match=msg):
            ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                       groups=groups)
    with pytest.raises(ValueError, match="groups must be an int"):
        ops.conv2d(torch.from_numpy(x4), torch.from_numpy(w4), groups=0)
    assert not _build.LIBRARY.loaded
