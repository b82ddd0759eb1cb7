"""Non-finite inputs on K2's tensor-core paths, walked on the CPU.

K2's Toeplitz tiles (single-channel, ``csrc/ssam_mxu.cu``) and bands
(per-lane, ``csrc/ssam_mxu_perlane.cu``) multiply every staged input of a
fragment, zero coefficient or not, and inf · 0 is nan. Both kernels vote
on a warp's fp32 sums and take a tile that holds a non-finite sum again
tap by tap. Their CPU walks (``engine.emulate_mxu_kernel``,
``engine.emulate_mxu_perlane_kernel``) walk the same branch; here they
give a non-finite output exactly where the plain version does, and the
other outputs equal it (fp32 ``rtol = 3e-5, atol = 3e-5·max|plain|``,
bf16 3e-2). The plain version's non-finite set and finite values are in
turn held to the JAX package's ``impl="xla"`` form of the same op on the
same inputs (``jax.vjp`` of it for the adjoint).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import adjoint, engine
from repro_torch.kernels import ssam_conv1d, ssam_conv2d, ssam_stencil2d
from repro_torch.kernels import stencils


def _close_with_set(got, want, rtol):
    """``got`` non-finite exactly where ``want`` is, equal elsewhere."""
    got, want = got.float(), want.float()
    bad = ~torch.isfinite(want)
    assert bad.any()
    assert torch.equal(~torch.isfinite(got), bad)
    ok = ~bad
    scale = want[ok].abs().max().item()
    torch.testing.assert_close(got[ok], want[ok], rtol=rtol,
                               atol=rtol * scale)


def _check(got, want, rtol, ref):
    """The walk against the plain version, the plain version against the
    JAX package's form ``ref`` (an array)."""
    _close_with_set(got, want, rtol)
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))
    _close_with_set(want, ref, rtol)


def _jax(t):
    """A torch tensor as a JAX array of the same dtype."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("adj", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perlane_walk_nonfinite_set_is_the_plain_versions(adj, dtype):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 150, 40)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 40)).astype(np.float32))
    x[0, 100, 5] = float("inf")
    x[1, 17, 33] = float("nan")
    x = x.to(getattr(torch, dtype))
    p = dataclasses.replace(ssam_conv1d.plan_for(4), strategy="mxu")
    pl = adjoint.input_adjoint_plan(p) if adj else p
    conv = lambda u: jops.conv1d_causal(u, _jax(w), impl="xla")
    ref = (jax.vjp(conv, jnp.zeros_like(_jax(x)))[1](_jax(x))[0] if adj
           else conv(_jax(x)))
    _check(engine.emulate_mxu_perlane_kernel(x, w, plan=pl),
           engine.run_window_plan_reference(x, w, plan=pl),
           3e-5 if dtype == "float32" else 3e-2, ref)


def _single_cases():
    sd = stencils.BENCHMARKS
    conv = ssam_conv2d.plan_for
    return [("2d5pt", ssam_stencil2d.plan_for(sd["2d5pt"]), None, 1, None,
             "2d5pt"),
            ("2d9pt t=2", ssam_stencil2d.plan_for(sd["2d9pt"]), None, 2,
             None, "2d9pt"),
            ("conv 5x3", conv((5, 3), "same"), (5, 3), 1, None, None),
            ("conv 5x5 stride 2", conv((5, 5), "same"), (5, 5), 1, (2, 2),
             None)]


@pytest.mark.parametrize("case", _single_cases(), ids=lambda c: c[0])
def test_single_channel_walk_nonfinite_set_is_the_plain_versions(case):
    _, p, fshape, t, stride, stencil = case
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((40, 70)).astype(np.float32))
    x[11, 20] = float("inf")
    x[30, 61] = float("nan")
    w = None if fshape is None else torch.from_numpy(
        rng.standard_normal(fshape).astype(np.float32))
    pl = dataclasses.replace(p, strategy="mxu", stride=stride)
    ref = (jops.stencil(_jax(x), stencil, time_steps=t, impl="xla")
           if stencil else jops.conv2d(_jax(x), _jax(w), mode="same",
                                       stride=stride, impl="xla"))
    _check(engine.emulate_mxu_kernel(x, w, plan=pl, time_steps=t),
           engine.run_window_plan_reference(x, w, plan=pl, time_steps=t),
           3e-5, ref)
