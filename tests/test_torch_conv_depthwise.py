"""Depthwise conv2d (``ops.conv2d(groups=C)`` with ``C_in == C_out == C``)
as one windowed op, on the CPU, against the JAX package.

The port runs a depthwise conv as one single-channel plan over the ``B·C``
images of ``x`` viewed as ``(B·C, H, W)``, image ``i`` against filter
``i mod C`` (``PerImageFilterPlan``): one K1 launch forward on the card,
one for dx, K3's launches for dW. Here its plain versions (the route's
CPU path) are held to ``repro.kernels.ops.conv2d(groups=C, impl="xla")``
and ``jax.grad`` of it (never the JAX windowed engine, which does not run
here; jitted, so that each shape compiles once), with
``torch.nn.functional.conv2d(groups=)`` as a third witness;
the CPU walks of K1's and K3's schedules (``engine.emulate_window_kernel``,
``engine.emulate_wgrad_kernel``) to the plain versions; and the route to
its rule. Tolerance: forward fp32 ``rtol = 3e-5, atol = 3e-5·max|ref|``,
gradients 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro_torch import _build
from repro_torch.core import engine
from repro_torch.core.plan import PerImageFilterPlan, normalize_epilogue
from repro_torch.kernels import ops, ssam_conv2d

CHAIN = ("bias", "gelu", "residual_add")
STRIDES = [None, 2, (1, 2)]
FILTERS = [3, 5, 7]


def _close(got, want, rtol=3e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _data(C, k, mode, stride, seed):
    rng = np.random.default_rng(seed)
    H, W = 13, 17
    x = rng.standard_normal((2, C, H, W)).astype(np.float32)
    w = (rng.standard_normal((C, 1, k, k)) / k).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    sh, sw = (stride, stride) if isinstance(stride, int) else stride or (1, 1)
    Ho, Wo = (H, W) if mode == "same" else (H - k + 1, W - k + 1)
    out = (2, C, -(-Ho // sh), -(-Wo // sw))
    r = rng.standard_normal(out).astype(np.float32)
    g = rng.standard_normal(out).astype(np.float32)
    return x, w, b, r, g


@pytest.mark.parametrize("stride", STRIDES, ids=str)
@pytest.mark.parametrize("mode", ["same", "valid"])
@pytest.mark.parametrize("k", FILTERS)
@pytest.mark.parametrize("C", [3, 8])
def test_depthwise_forward_matches_reference(C, k, mode, stride):
    x, w, b, r, _ = _data(C, k, mode, stride, 1)
    got = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w), mode=mode,
                     groups=C, stride=stride, epilogue=CHAIN,
                     epilogue_args=(torch.from_numpy(b),
                                    torch.from_numpy(r)))
    want = jax.jit(functools.partial(
        jops.conv2d, mode=mode, groups=C, stride=stride, impl="xla",
        epilogue=CHAIN))(x, w, epilogue_args=(b, r))
    _close(got, want)
    lib = F.gelu(F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), stride=stride or 1,
                          padding=k // 2 if mode == "same" else 0,
                          groups=C), approximate="tanh") + torch.from_numpy(r)
    _close(got, lib.numpy())


@pytest.mark.parametrize("C,k,mode,stride", [
    (3, 3, "same", None), (8, 5, "valid", None), (3, 7, "same", 2),
    (8, 3, "valid", 2), (3, 5, "same", (1, 2)), (8, 7, "valid", (1, 2))],
    ids=str)
def test_depthwise_gradients_match_jax(C, k, mode, stride):
    """dx, dW, the bias row's and the residual's gradients against
    jax.grad of the xla form."""
    x, w, b, r, g = _data(C, k, mode, stride, 2)

    def f_jax(xx, ww, bb, rr):
        return jnp.sum(g * jops.conv2d(xx, ww, mode=mode, groups=C,
                                       stride=stride, impl="xla",
                                       epilogue=CHAIN,
                                       epilogue_args=(bb, rr)))

    want = jax.jit(jax.grad(f_jax, (0, 1, 2, 3)))(x, w, b, r)
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, w, b, r)]
    y = ops.conv2d(ts[0], ts[1], mode=mode, groups=C, stride=stride,
                   epilogue=CHAIN, epilogue_args=tuple(ts[2:]))
    got = torch.autograd.grad(y, ts, torch.from_numpy(g))
    for a, e, t in zip(got, want, ts):
        assert a.shape == t.shape
        _close(a, e, 1e-4)


def _plan(C, k, mode, stride, chain=CHAIN):
    p = ssam_conv2d.plan_for_depthwise((k, k), mode, C)
    st = (stride, stride) if isinstance(stride, int) else stride
    return dataclasses.replace(p, stride=st,
                               epilogue=normalize_epilogue(chain))


@pytest.mark.parametrize("C,k,mode,stride,block", [
    (3, 3, "same", None, None), (8, 5, "valid", None, (8, 16)),
    (3, 7, "same", 2, (8, 16)), (8, 3, "same", (1, 2), (4, 32))], ids=str)
def test_window_kernel_walk_matches_plain_version(C, k, mode, stride, block):
    """K1's single-channel schedule with a filter per image (a tile's
    coefficients and bias its image's) against the plain version."""
    x, w, b, r, _ = _data(C, k, mode, stride, 3)
    p = _plan(C, k, mode, stride)
    xx = torch.from_numpy(x).reshape(-1, 13, 17)
    ww = torch.from_numpy(w).reshape(C, k, k)
    rr = torch.from_numpy(r).reshape((-1,) + tuple(r.shape[2:]))
    args = (torch.from_numpy(b), rr)
    got = engine.emulate_window_kernel(xx, ww, plan=p, block=block,
                                       epilogue_args=args)
    want = engine.run_window_plan_reference(xx, ww, plan=p,
                                            epilogue_args=args)
    _close(got, want.numpy())


@pytest.mark.parametrize("C,k,mode,stride,max_grid", [
    (3, 3, "same", None, None), (8, 5, "valid", None, 3),
    (3, 7, "same", 2, 4), (8, 3, "same", (1, 2), 5)], ids=str)
def test_wgrad_kernel_walk_matches_plain_version(C, k, mode, stride,
                                                 max_grid):
    """K3's single-channel walk with a gradient per channel (units
    channel-major, a block's sums flushed when the channel changes, the
    partials added per channel in block order) against the plain version
    and jax.grad."""
    x, w, b, r, g = _data(C, k, mode, stride, 4)
    p = _plan(C, k, mode, stride, ())
    xx = torch.from_numpy(x).reshape(-1, 13, 17)
    gg = torch.from_numpy(g).reshape((-1,) + tuple(g.shape[2:]))
    got = engine.emulate_wgrad_kernel(xx, gg, plan=p, max_grid=max_grid)
    want = engine.run_weight_grad_plan_reference(xx, gg, plan=p)
    assert tuple(got.shape) == (C, k, k)
    _close(got, want.numpy(), 1e-4)
    # the same bits from the same walk
    assert torch.equal(got, engine.emulate_wgrad_kernel(
        xx, gg, plan=p, max_grid=max_grid))

    def f_jax(ww):
        return jnp.sum(g * jops.conv2d(jnp.asarray(x), ww, mode=mode,
                                       groups=C, stride=stride, impl="xla"))

    _close(got, np.asarray(jax.jit(jax.grad(f_jax))(w))[:, 0], 1e-4)


def test_wgrad_layout_runs_and_partials():
    """With a filter per image each block walks a run of units, a
    channel's units are consecutive and meet a run of blocks, and the
    partials number grid + C − 1."""
    lay = engine.wgrad_layout(8 * 64, 256, 256, 256, 256, 3, 3,
                              lead=(1, 1), filters=64)
    assert lay.filters == 64 and lay.units == 8 * 64 * 8
    assert lay.slices == lay.grid + 63 and lay.red > 0
    runs = [lay.run(k) for k in range(lay.grid)]
    assert [u for run in runs for u in run] == list(range(lay.units))
    per = lay.units // 64
    for c in range(64):
        imgs = {lay.unit(u)[0] for u in range(c * per, (c + 1) * per)}
        assert imgs == set(range(c, 8 * 64, 64))
        assert all(lay.channel(u) == c for u in range(c * per, (c + 1) * per))
    slots = [k + c for k, run in enumerate(runs)
             for c in sorted({lay.channel(u) for u in run})]
    assert slots == sorted(set(slots)) and max(slots) < lay.slices
    # one filter: the walk of stride grid, one partial a block
    one = engine.wgrad_layout(3, 70, 300, 70, 300, 5, 5, lead=(2, 2))
    assert one.filters == 1 and one.slices == one.grid and one.red == 0
    assert one.run(1) == range(1, one.units, one.grid)


def test_route_takes_one_launch_exactly_where_it_may():
    """A depthwise conv with one filter a channel on the lanes strategy
    whose footprint K1 holds is one plan; the ResNeXt-like shape, a
    channel multiplier of 2, strategy='mxu' and a footprint K1 refuses
    (129 x 129: 40 bands) keep the per-group route; a footprint K1 walks
    in bands (33 rows) is one plan."""
    x = (2, 8, 20, 30)
    for strategy in (None, "auto", "lanes"):
        p = ops.depthwise_plan(x, (8, 1, 3, 3), groups=8, mode="same",
                               stride=(2, 2), epilogue=("bias",),
                               strategy=strategy)
        assert isinstance(p, PerImageFilterPlan) and p.filters == 8
        assert p.stride == (2, 2) and p.batch_axes == 1
    assert ops.depthwise_plan(x, (16, 2, 3, 3), groups=4,
                              mode="same") is None          # C_in/groups 2
    assert ops.depthwise_plan(x, (16, 1, 3, 3), groups=8,
                              mode="same") is None          # multiplier 2
    assert ops.depthwise_plan(x, (8, 1, 3, 3), groups=8, mode="same",
                              strategy="mxu") is None
    assert ops.depthwise_plan(x, (8, 1, 129, 129), groups=8,
                              mode="same") is None          # 40 bands
    assert ops.depthwise_plan(x, (8, 1, 33, 3), groups=8,
                              mode="same").filters == 8     # 33 rows
    # the plain route's plans: one windowed op, or one a group
    calls = []
    real = ops.window_op

    def spy(plan, *a, **k):
        calls.append(plan)
        return real(plan, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "window_op", spy)
    try:
        xt = torch.zeros(x)
        ops.conv2d(xt, torch.zeros(8, 1, 3, 3), groups=8)
        assert len(calls) == 1 and calls[0].filters == 8
        calls.clear()
        ops.conv2d(xt, torch.zeros(16, 1, 3, 3), groups=8)
        assert len(calls) == 8 and all(c.filters == 1 for c in calls)
        calls.clear()
        ops.conv2d(xt, torch.zeros(8, 1, 3, 3), groups=8, strategy="mxu")
        assert len(calls) == 8
    finally:
        mp.undo()
    assert not _build.LIBRARY.loaded


def test_depthwise_operand_errors():
    """A bias that is not one a channel and a residual that is not
    output-shaped raise the reference's messages."""
    x, w = torch.zeros(2, 4, 9, 9), torch.zeros(4, 1, 3, 3)
    with pytest.raises(ValueError, match="per-C_out"):
        ops.conv2d(x, w, groups=4, epilogue=("bias",),
                   epilogue_args=(torch.zeros(3),))
    with pytest.raises(ValueError, match="output-shaped"):
        ops.conv2d(x, w, groups=4, epilogue=("residual_add",),
                   epilogue_args=(torch.zeros(2, 4, 9, 8),))
    with pytest.raises(ValueError, match="runtime operand"):
        ops.conv2d(x, w, groups=4, epilogue=("bias",))
