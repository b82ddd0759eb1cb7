"""K1's per-lane schedule (``csrc/ssam_window_perlane.cu``: 16 bytes of
channels a thread, a cp.async ring of time rows, the epilogue chain fixed
per launch) walked on the CPU.

``engine.emulate_perlane_kernel`` walks the kernel's grid, each thread's
channels masked at D, its stream of input rows through the ring (the rows
of zero-weight window slots never loaded, zeros outside [0, T)), the
window's sum in row order and the epilogue, and asserts that every (b, t,
d) is written once. It is held against the plain version and, as
``tests/test_torch_conv1d.py`` does, against the reference's oracle
``repro.kernels.ref.conv1d_causal`` with ``repro.core.adjoint
.apply_epilogue`` replaying the epilogue, and for the input adjoint (lead
0) against ``jax.vjp`` of that oracle. Tolerances: fp32 rtol 3e-5 with
atol 3e-5·max|ref| (DESIGN.md §6), bf16 3e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adjoint as jadj
from repro.core import plan as jplan
from repro.kernels import ref as jref
from repro_torch.core import adjoint, engine
from repro_torch.core.plan import normalize_epilogue
from repro_torch.kernels import ssam_conv1d

# (B, T, D, K): D not a multiple of 4 or 8, T not a multiple of the 32-row
# tile, T < K, K up to the 8-row window and K = 1
SHAPES = [(2, 130, 99, 4), (1, 65, 129, 8), (3, 37, 100, 3), (2, 17, 33, 7),
          (1, 3, 8, 4), (1, 9, 3, 1)]
IDS = [f"{b}x{t}x{d}-K{k}" for b, t, d, k in SHAPES]
# every instance of the kernel: the fixed chains, and silu alone (generic)
CHAINS = [(), ("bias", "silu"), ("relu",), ("bias", "gelu", ("scale", 0.5)),
          ("silu",)]


def _close(got, want, rtol=3e-5):
    got = got.detach().float().numpy()
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


@pytest.mark.parametrize("chain", CHAINS, ids=str)
@pytest.mark.parametrize("B,T,D,K", SHAPES, ids=IDS)
def test_forward_rows_cover_each_output_once(B, T, D, K, chain):
    """The forward (lead K − 1) under every epilogue instance."""
    x, w, b, _ = _data(B, T, D, K)
    p = dataclasses.replace(ssam_conv1d.plan_for(K),
                            epilogue=normalize_epilogue(chain) if chain
                            else ())
    args = (torch.from_numpy(b),) if "bias" in chain else ()
    got = engine.emulate_perlane_kernel(torch.from_numpy(x),
                                        torch.from_numpy(w), plan=p,
                                        epilogue_args=args)
    _close(got, engine.run_window_plan_reference(
        torch.from_numpy(x), torch.from_numpy(w), plan=p,
        epilogue_args=args).numpy())
    jp = dataclasses.replace(jplan.depthwise_conv1d_plan(K),
                             epilogue=jplan.normalize_epilogue(chain))
    want = jadj.apply_epilogue(jp, jref.conv1d_causal(jnp.asarray(x),
                                                      jnp.asarray(w)),
                               (jnp.asarray(b),) if "bias" in chain else ())
    _close(got, want)


@pytest.mark.parametrize("B,T,D,K", SHAPES, ids=IDS)
def test_adjoint_rows_cover_each_output_once(B, T, D, K):
    """The input adjoint (lead 0, the reflected coefficient rows)."""
    x, w, _, g = _data(B, T, D, K, seed=1)
    a = adjoint.input_adjoint_plan(ssam_conv1d.plan_for(K))
    got = engine.emulate_perlane_kernel(torch.from_numpy(g),
                                        torch.from_numpy(w), plan=a)
    _close(got, engine.run_window_plan_reference(
        torch.from_numpy(g), torch.from_numpy(w), plan=a).numpy())
    _, vjp = jax.vjp(lambda v: jref.conv1d_causal(v, jnp.asarray(w)),
                     jnp.asarray(x))
    _close(got, vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("chain", [(), ("bias", "silu")], ids=str)
def test_bf16_rows_of_eight_channels(chain):
    x, w, b, _ = _data(2, 77, 300, 4, seed=2)
    p = dataclasses.replace(ssam_conv1d.plan_for(4),
                            epilogue=normalize_epilogue(chain) if chain
                            else ())
    args = (torch.from_numpy(b),) if "bias" in chain else ()
    xb = torch.from_numpy(x).bfloat16()
    got = engine.emulate_perlane_kernel(xb, torch.from_numpy(w), plan=p,
                                        epilogue_args=args)
    assert got.dtype == torch.bfloat16
    _close(got, engine.run_window_plan_reference(
        xb, torch.from_numpy(w), plan=p, epilogue_args=args).float().numpy(),
        3e-2)


def test_layout_at_hymbas_shape_and_odd_widths():
    """Hymba's (2, 2048, 3200): 4 fp32 or 8 bf16 channels a thread, 16-byte
    rows, a 4-row window, the bias+SiLU instance, 7 (4) lane tiles × 64
    row tiles × 2 sequences; D = 99 takes the masked element-wise copies;
    an 8-tap filter an 8-row window; an unlisted chain the generic one."""
    pe = dataclasses.replace(ssam_conv1d.plan_for(4),
                             epilogue=normalize_epilogue(("bias", "silu")))
    lay = engine.perlane_layout(pe, 2, 2048, 3200, 4)
    assert (lay.vec, lay.window, lay.aligned, lay.chain) == (4, 4, True,
                                                             "bias+silu")
    assert lay.grid == (7, 64, 2)
    lay = engine.perlane_layout(pe, 2, 2048, 3200, 2)
    assert (lay.vec, lay.grid) == (8, (4, 64, 2))
    odd = engine.perlane_layout(ssam_conv1d.plan_for(8), 1, 65, 99, 4)
    assert (odd.aligned, odd.window, odd.chain) == (False, 8, "none")
    assert not engine.perlane_layout(pe, 1, 64, 3200, 4,
                                     ptrs_aligned=False).aligned
    gen = dataclasses.replace(pe, epilogue=normalize_epilogue(("silu",)))
    assert engine.perlane_layout(gen, 1, 64, 64, 4).chain == "generic"
    adj = adjoint.input_adjoint_plan(ssam_conv1d.plan_for(4))
    assert engine.perlane_layout(adj, 2, 2048, 3200, 4).grid == (7, 64, 2)
