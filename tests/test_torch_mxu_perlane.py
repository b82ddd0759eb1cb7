"""K2's per-lane path, the lane-batched mat-vec of
``conv1d_causal(strategy="mxu")``, on the CPU.

The plain version (``engine.apply_plan_mxu`` on per-lane plans: the tap
views stacked into ``A (taps, …, rows, lanes)``, the rows
``w[coeff_id, :]`` into ``Wm (taps, lanes)``, taps padded to 8, the tap
axis contracted under the lane batch in fp32) is held against the
reference's kernel body ``repro.core.engine._apply_plan_mxu`` on the same
numpy blocks (plain JAX, no Pallas); ``ops.conv1d_causal(strategy="mxu")``
against ``repro.kernels.ref.conv1d_causal`` with the reference's epilogue
and against the lanes strategy, its gradients against the lanes
strategy's; and the CPU walk of ``csrc/ssam_mxu_perlane.cu``
(``engine.emulate_mxu_perlane_kernel``: its grid, staged tiles, fragment
rows, Toeplitz band and 3xTF32 products) against the plain version.
Tolerances: the block bodies fp32 3e-5 (DESIGN.md §6), bf16 3e-2; the
ops against the oracle and against lanes 1e-4, the reference's own
lanes-versus-mxu tolerance.
"""
import dataclasses

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
from repro_torch.core.plan import normalize_epilogue
from repro_torch.kernels import ops, ssam_conv1d

KS = [1, 2, 3, 4, 8]
# (B, T, D, K): D not a multiple of a tile's 32 or 64 lanes, T not a
# multiple of the 128-row tile, T < K, K = 1 and the 8-row limit
SHAPES = [(2, 130, 99, 4), (1, 300, 129, 8), (3, 37, 100, 3), (2, 17, 33, 7),
          (1, 3, 8, 4), (1, 9, 3, 1)]
IDS = [f"{b}x{t}x{d}-K{k}" for b, t, d, k in SHAPES]
CHAINS = [(), ("bias", "silu"), ("relu",), ("bias", "gelu", ("scale", 0.5)),
          ("silu", "residual_add")]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


def _close(got, want, rtol=3e-5):
    got, want = _np(got), _np(want)
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


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _mxu(p):
    return dataclasses.replace(p, strategy="mxu")


def _args(chain, b, r):
    """The runtime operands of ``chain``: the bias, then the residual."""
    return tuple(b if op == "bias" else r for op in
                 (st.op for st in normalize_epilogue(chain))
                 if op in ("bias", "residual_add"))


# --- the block body against the reference's _apply_plan_mxu ---------------

@pytest.mark.parametrize("adj", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("K", KS)
def test_block_body_matches_reference(K, adj):
    """One block ``(rows_in, lanes)``: the forward plan (lead K − 1) and
    its input adjoint (the reflected rows), fp32."""
    jp = jplan.depthwise_conv1d_plan(K)
    if adj:
        jp = jadj.input_adjoint_plan(jp)
    p = ssam_conv1d.plan_for(K)
    p = adjoint.input_adjoint_plan(p) if adj else p
    assert dataclasses.astuple(p) == dataclasses.astuple(jp)
    x, w, _, _ = _data(1, 40 + K - 1, 70, K, seed=K)
    xb = x[0]
    want = jengine._apply_plan_mxu(jnp.asarray(xb), _mxu(jp), jnp.asarray(w),
                                   jnp.float32)
    got = engine.apply_plan_mxu(_t(xb), _mxu(p), _t(w))
    _close(got, want)
    # leading axes are independent blocks, each with its lanes of w
    two = engine.apply_plan_mxu(_t(np.stack([xb, -xb])), _mxu(p), _t(w))
    _close(two[1], -np.asarray(want))


@pytest.mark.parametrize("K", KS)
def test_block_body_bf16_matches_reference(K):
    """A bf16 block, widened to fp32 as the plain version's padding does,
    against the reference's body on the bf16 block, at 3e-2."""
    jp, p = jplan.depthwise_conv1d_plan(K), ssam_conv1d.plan_for(K)
    x, w, _, _ = _data(1, 33 + K - 1, 90, K, seed=10 + K)
    xb = torch.from_numpy(x[0]).bfloat16()
    want = jengine._apply_plan_mxu(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), _mxu(jp),
        jnp.asarray(w), jnp.float32)
    _close(engine.apply_plan_mxu(xb.float(), _mxu(p), _t(w)),
           np.asarray(want, np.float32), 3e-2)


def test_more_than_eight_taps_contract_in_groups():
    """The CPU path holds any filter length: taps beyond 8 contract in
    further groups of 8 into the same sum (the reference pads to 16)."""
    jp, p = jplan.depthwise_conv1d_plan(11), ssam_conv1d.plan_for(11)
    x, w, _, _ = _data(1, 50, 20, 11, seed=20)
    want = jengine._apply_plan_mxu(jnp.asarray(x[0]), _mxu(jp),
                                   jnp.asarray(w), jnp.float32)
    _close(engine.apply_plan_mxu(_t(x[0]), _mxu(p), _t(w)), want)


# --- the op: forward, residual, gradients -----------------------------------

@pytest.mark.parametrize("chain", CHAINS, ids=str)
@pytest.mark.parametrize("B,T,D,K", SHAPES[:4], ids=IDS[:4])
def test_conv1d_mxu_matches_oracle_and_lanes(B, T, D, K, chain):
    x, w, b, g = _data(B, T, D, K, seed=30)
    args = _args(chain, _t(b), _t(g))
    got = ops.conv1d_causal(_t(x), _t(w), epilogue=chain or None,
                            epilogue_args=args, strategy="mxu")
    jp = dataclasses.replace(jplan.depthwise_conv1d_plan(K),
                             epilogue=jplan.normalize_epilogue(chain))
    want = jadj.apply_epilogue(
        jp, jref.conv1d_causal(jnp.asarray(x), jnp.asarray(w)),
        tuple(jnp.asarray(a.numpy()) for a in args))
    _close(got, want, 1e-4)
    _close(got, ops.conv1d_causal(_t(x), _t(w), epilogue=chain or None,
                                  epilogue_args=args, strategy="lanes"), 1e-4)


def test_conv1d_mxu_bf16():
    x, w, b, _ = _data(2, 33, 70, 4, seed=31)
    xb = torch.from_numpy(x).bfloat16()
    got = ops.conv1d_causal(xb, _t(w), epilogue=("bias", "silu"),
                            epilogue_args=(_t(b),), strategy="mxu")
    assert got.dtype == torch.bfloat16
    _close(got, ops.conv1d_causal(xb, _t(w), epilogue=("bias", "silu"),
                                  epilogue_args=(_t(b),)), 3e-2)


@pytest.mark.parametrize("B,T,D,K", SHAPES, ids=IDS)
def test_conv1d_mxu_gradients_match_lanes(B, T, D, K):
    """dx (the input-adjoint plan, which keeps ``strategy="mxu"``), dW
    (K4's plain version) and the bias and residual gradients under bias +
    SiLU + residual, against the lanes strategy's."""
    x, w, b, g = _data(B, T, D, K, seed=32)
    r = np.random.default_rng(33).standard_normal(x.shape).astype(np.float32)
    chain = ("bias", "silu", "residual_add")
    grads = {}
    for strategy in ("mxu", "lanes"):
        tx, tw, tb, tr = (_t(a, grad=True) for a in (x, w, b, r))
        adjoint.reset_lowering_counts()
        y = ops.conv1d_causal(tx, tw, epilogue=chain, epilogue_args=(tb, tr),
                              strategy=strategy)
        grads[strategy] = torch.autograd.grad(y, (tx, tw, tb, tr), _t(g))
        assert dict(adjoint.BACKWARD_LOWERINGS) == {"adj_conv1d": 1,
                                                    "wgrad_conv1d": 1}
    for got, want in zip(grads["mxu"], grads["lanes"]):
        _close(got, want, 1e-4)


def test_adjoint_plan_keeps_the_strategy():
    p = _mxu(ssam_conv1d.plan_for(4))
    a = adjoint.input_adjoint_plan(p)
    assert a.strategy == "mxu" and a.kind == "adj_conv1d"
    assert adjoint.input_adjoint_plan(a) == p


def test_cpu_tensor_never_loads_k2():
    x, w, _, _ = _data(1, 20, 16, 4)
    before = engine.MXU_KERNEL.launches
    ops.conv1d_causal(_t(x), _t(w), strategy="mxu")
    assert not _build.LIBRARY.loaded
    assert engine.MXU_KERNEL.launches == before


# --- K2's per-lane kernel walked on the CPU ---------------------------------

@pytest.mark.parametrize("chain", CHAINS[:2] + CHAINS[4:], ids=str)
@pytest.mark.parametrize("B,T,D,K", SHAPES, ids=IDS)
def test_kernel_walk_matches_plain_version(B, T, D, K, chain):
    """The emulated schedule, forward (with each chain) and the input
    adjoint, fp32 at 3e-5 and bf16 at 3e-2, against the plain version."""
    x, w, b, g = _data(B, T, D, K, seed=40)
    p = _mxu(ssam_conv1d.plan_for(K))
    pe = dataclasses.replace(p, epilogue=normalize_epilogue(chain) if chain
                             else ())
    a = adjoint.input_adjoint_plan(p)
    for dt, rtol in ((torch.float32, 3e-5), (torch.bfloat16, 3e-2)):
        xx, gg = _t(x).to(dt), _t(g).to(dt)
        args = _args(chain, _t(b), gg)
        for pl, inp, ea in ((pe, xx, args), (a, gg, ())):
            got = engine.emulate_mxu_perlane_kernel(inp, _t(w), plan=pl,
                                                    epilogue_args=ea)
            assert got.dtype == dt and got.shape == inp.shape
            _close(got, engine.run_window_plan_reference(
                inp, _t(w), plan=pl, epilogue_args=ea), rtol)


def test_kernel_layout_and_swizzles():
    """The units (lane tiles of 32 fp32 or 64 bf16 lanes, 128-row tiles,
    sequences) and the persistent blocks (4 an SM, never more than the
    units), and the chunk permutations: bijections on every row, and conflict-free for
    each 8-thread phase of the warp's 16-byte fragment loads (input rows
    ``8g + c`` with the k-step and fragment offsets) and staging stores
    (output rows ``8g + 2c`` and their neighbours)."""
    p = ssam_conv1d.plan_for(4)
    lay = engine.mxu_perlane_layout(p, 2, 2048, 3200, 4)
    assert (lay.vec, lay.lanes, lay.grid, lay.blocks) == (
        4, 32, (100, 16, 2), 4 * 132)
    lay = engine.mxu_perlane_layout(p, 2, 2048, 3200, 2)
    assert (lay.vec, lay.lanes, lay.grid) == (8, 64, (50, 16, 2))
    lay = engine.mxu_perlane_layout(p, 1, 37, 99, 4)
    assert lay.grid == (4, 1, 1) and lay.blocks == 4
    assert engine.mxu_perlane_layout(p, 3, 129, 99, 2).grid == (2, 2, 3)
    for out, rows in ((False, engine.MXU_PL_IN), (True, engine.MXU_PL_OUT)):
        for r in range(rows):
            assert sorted(k ^ engine.mxu_perlane_swizzle(r, out)
                          for k in range(8)) == list(range(8))
    for phase in range(4):
        threads = [(g, c) for g in (2 * phase, 2 * phase + 1)
                   for c in range(4)]
        for ks in range(2):
            for f in range(4):
                rows = [8 * g + c + 8 * ks + 64 * (f & 1) + 4 * (f >> 1)
                        for g, c in threads]
                assert len({engine.mxu_perlane_swizzle(r) for r in rows}) \
                    == 8
        for i in range(4):
            rows = [8 * g + 2 * c + (i & 1) + 32 * (i & 2)
                    for g, c in threads]
            assert len({engine.mxu_perlane_swizzle(r, True)
                        for r in rows}) == 8
    with pytest.raises(ValueError, match="up to 8 taps"):
        engine.emulate_mxu_perlane_kernel(
            torch.zeros(1, 12, 8), torch.zeros(9, 8),
            plan=_mxu(plan.depthwise_conv1d_plan(9)))
