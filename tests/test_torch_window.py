"""Parity of the port's windowed engine and ops with the JAX package.

The JAX windowed kernel cannot run here through ``pallas_call`` (see
ROADMAP R1), so the port is held against the reference's kernel *body*
(``engine._apply_plan_once``), its oracles (``repro.kernels.ref``) and
its executor, on the same numpy inputs. Tolerance: fp32 3e-5
(DESIGN.md §6). Blocks are small so every grid has several ragged ones.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import executor as jexecutor
from repro.core import plan as jplan
from repro.kernels import ref as jref
from repro.kernels import ssam_stencil2d as js2
from repro.kernels import ssam_stencil3d as js3
from repro.kernels import stencils as jstencils
from repro_torch import _build, convert
from repro_torch.core import engine, executor, plan
from repro_torch.kernels import ops, ref, ssam_conv2d, ssam_stencil2d
from repro_torch.kernels import ssam_stencil3d, stencils

TOL = dict(rtol=3e-5, atol=3e-5)
NAMES = sorted(stencils.BENCHMARKS)
VARIANTS = ("shift_psum", "shift_data")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _grid(ndim, seed):
    shape = (20, 40) if ndim == 2 else (6, 10, 40)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _block(ndim):
    return (8, 16) if ndim == 2 else (2, 4, 16)


def _plans(name):
    sd = stencils.BENCHMARKS[name]
    mod = ssam_stencil2d if sd.ndim == 2 else ssam_stencil3d
    return sd, mod.plan_for(sd)


# --- (b) the plain block walk against the reference kernel body ------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", NAMES)
def test_block_walk_matches_reference_body(name, variant):
    sd, p = _plans(name)
    jmod = js2 if sd.ndim == 2 else js3
    jp = jmod.plan_for(jstencils.BENCHMARKS[name])
    assert convert.plan_from_reference(dataclasses.asdict(jp)) == p
    xb = _grid(sd.ndim, 1)
    want = jengine._apply_plan_once(jnp.asarray(xb), jp, None, variant,
                                    jnp.float32)
    got = engine.apply_plan_once(torch.from_numpy(xb), p, None, variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", ["valid", "same"])
def test_conv_block_walk_matches_reference_body(mode, variant):
    rng = np.random.default_rng(2)
    xb = rng.standard_normal((12, 40)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    jp = (jplan.conv2d_same_plan if mode == "same" else jplan.conv2d_plan)(5, 3)
    p = convert.plan_from_reference(dataclasses.asdict(jp))
    want = jengine._apply_plan_once(jnp.asarray(xb), jp, jnp.asarray(w),
                                    variant, jnp.float32)
    got = engine.apply_plan_once(torch.from_numpy(xb), p,
                                 torch.from_numpy(w), variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- (c) the ops on the CPU against the reference's oracles ----------------

@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", NAMES)
def test_stencil_matches_reference_oracle(name, variant, t):
    sd = stencils.BENCHMARKS[name]
    x = _grid(sd.ndim, 3)
    got = ops.stencil(convert.from_numpy(x), name, time_steps=t,
                      variant=variant, block=_block(sd.ndim))
    want = jref.stencil_iterate(jnp.asarray(x), jstencils.BENCHMARKS[name], t)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fshape", [(3, 5), (1, 1), (4, 2), (7, 7)])
@pytest.mark.parametrize("mode", ["valid", "same"])
def test_conv2d_matches_reference_oracle(mode, fshape, variant):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20, 40)).astype(np.float32)
    w = rng.standard_normal(fshape).astype(np.float32)
    got = ops.conv2d(convert.from_numpy(x), convert.from_numpy(w), mode=mode,
                     variant=variant, block=(8, 16))
    fn = jref.conv2d_same if mode == "same" else jref.conv2d_valid
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if mode == "valid":
        jp = jplan.conv2d_plan(fshape[1], fshape[0])
        ex = jexecutor.execute_conv_global(jp, jnp.asarray(x), jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(ex), **TOL)


@pytest.mark.parametrize("mode", ["valid", "same"])
def test_conv2d_batched_matches_reference_oracle(mode):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 20, 40)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    got = ops.conv2d(convert.from_numpy(x), convert.from_numpy(w), mode=mode,
                     block=(8, 16))
    want = np.asarray(jref.conv2d_batched(jnp.asarray(x), jnp.asarray(w),
                                          mode))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_time_steps_keep_pad_once_semantics():
    """t > 1 is not Dirichlet iteration: near the edge they differ."""
    x = convert.from_numpy(_grid(2, 6))
    sd = stencils.BENCHMARKS["2d9pt"]
    got = ops.stencil(x, sd, time_steps=3, block=(8, 16))
    torch.testing.assert_close(got, ref.stencil_iterate(x, sd, 3), **TOL)
    assert (got - ref.stencil_iterate_dirichlet(x, sd, 3)).abs().max() > 1e-3


# --- the port's oracles and executor against the reference's --------------

@pytest.mark.parametrize("name", ["2d5pt", "2d64pt", "3d27pt", "poisson"])
def test_stencil_oracles_match_reference(name):
    sd, jsd = stencils.BENCHMARKS[name], jstencils.BENCHMARKS[name]
    x = _grid(sd.ndim, 7)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(ref.stencil_apply(tx, sd).numpy(),
                               np.asarray(jref.stencil_apply(jx, jsd)), **TOL)
    np.testing.assert_allclose(
        ref.stencil_iterate_dirichlet(tx, sd, 2).numpy(),
        np.asarray(jref.stencil_iterate_dirichlet(jx, jsd, 2)), **TOL)
    np.testing.assert_allclose(ref.stencil_iterate(tx, sd, 2).numpy(),
                               np.asarray(jref.stencil_iterate(jx, jsd, 2)),
                               **TOL)


def test_conv_oracles_match_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, 30)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    tx, tw, jx, jw = (torch.from_numpy(x), torch.from_numpy(w),
                      jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(ref.conv2d_valid(tx[0], tw).numpy(),
                               np.asarray(jref.conv2d_valid(jx[0], jw)), **TOL)
    np.testing.assert_allclose(ref.conv2d_same(tx[0], tw).numpy(),
                               np.asarray(jref.conv2d_same(jx[0], jw)), **TOL)
    for mode in ("valid", "same"):
        np.testing.assert_allclose(
            ref.conv2d_batched(tx, tw, mode).numpy(),
            np.asarray(jref.conv2d_batched(jx, jw, mode)), **TOL)


def test_executor_matches_reference():
    rng = np.random.default_rng(9)
    jp = jplan.conv2d_plan(3, 2, S=16, P=3)
    p = convert.plan_from_reference(dataclasses.asdict(jp))
    w = rng.standard_normal((2, 3)).astype(np.float32)
    blk = rng.standard_normal((p.C, p.S)).astype(np.float32)
    np.testing.assert_allclose(
        executor.execute_conv_block(p, torch.from_numpy(blk),
                                    torch.from_numpy(w)).numpy(),
        np.asarray(jexecutor.execute_conv_block(jp, jnp.asarray(blk),
                                                jnp.asarray(w))), **TOL)
    x = rng.standard_normal((9, 21)).astype(np.float32)
    np.testing.assert_allclose(
        executor.execute_conv_global(p, torch.from_numpy(x),
                                     torch.from_numpy(w)).numpy(),
        np.asarray(jexecutor.execute_conv_global(jp, jnp.asarray(x),
                                                 jnp.asarray(w))), **TOL)


# --- (d) the port imports neither JAX nor the reference --------------------

def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k == 'repro'\n"
        "             or k.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 14


# --- (e) the device decides; the kernel is built for sm_90a ---------------

def test_cpu_tensor_never_loads_the_kernel():
    x = convert.from_numpy(_grid(2, 10))
    ops.stencil(x, "2d5pt")
    ops.conv2d(x, torch.ones(3, 3))
    assert not _build.LIBRARY.loaded
    assert engine.WINDOW_KERNEL.launches == 0


def test_nvcc_command_targets_sm_90a():
    src = _build.sources()
    assert [p.name for p in src] == ["ssam_mxu.cu", "ssam_mxu_chain.cu",
                                     "ssam_mxu_perlane.cu",
                                     "ssam_mxu_stream.cu",
                                     "ssam_mxu_tc.cu",
                                     "ssam_scan.cu",
                                     "ssam_wgrad.cu", "ssam_wgrad_bf16.cu",
                                     "ssam_wgrad_f32.cu",
                                     "ssam_wgrad_perlane.cu",
                                     "ssam_wgrad_tc.cu",
                                     "ssam_window.cu", "ssam_window_2d.cu",
                                     "ssam_window_2d_strided.cu",
                                     "ssam_window_2d_wide.cu",
                                     "ssam_window_3d.cu",
                                     "ssam_window_band.cu",
                                     "ssam_window_chain_2d.cu",
                                     "ssam_window_chain_3d.cu",
                                     "ssam_window_perlane.cu",
                                     "ssam_window_reduce.cu"]
    cmd = _build.compile_command(src[0], _build.BUILD_DIR / "k.o")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" not in cmd
    assert "arch=compute_90a,code=sm_90a" in _build.link_command(
        [_build.BUILD_DIR / "k.o"], _build.BUILD_DIR / "k.so")


def _c_entries():
    """Every plain C entry of the CUDA sources: (name, parameter count)."""
    out = []
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out.append((m.group(1), len(m.group(2).split(","))))
    return out


@pytest.mark.parametrize("entry,nparams", _c_entries(), ids=str)
def test_ctypes_binding_matches_c_entry(entry, nparams, monkeypatch):
    """The argument types the loader binds for each C entry are as many as
    its parameters: a mismatch is a TypeError at the first launch, which
    only the card would show."""
    bound = {}

    class Library:
        def __getattr__(self, name):
            return bound.setdefault(name, type("Fn", (), {})())

    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Library())
    _build.Library._load(_build.BUILD_DIR / "k.so")
    assert len(bound[entry].argtypes) == nparams


def test_other_devices_raise():
    x = torch.zeros((20, 40), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.stencil(x, "2d5pt")
    with pytest.raises(ValueError, match="CUDA tensor"):
        engine.WINDOW_KERNEL(torch.zeros(20, 40), None,
                             plan=_plans("2d5pt")[1], block=(8, 16),
                             time_steps=1, variant="shift_psum")


@pytest.mark.parametrize("case", ["nchw", "groups", "stride", "epilogue",
                                  "mesh", "perlane", "mxu", "reduce"])
def test_out_of_slice_raises_not_implemented(case):
    x = torch.zeros((20, 40))
    w = torch.ones((3, 3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        # NCHW, groups, strides and epilogues run (residual_add included);
        # sharding them does not, nor an epilogue on a scan plan
        if case == "nchw":
            ops.conv2d(torch.zeros((1, 2, 20, 40)), torch.ones((3, 2, 3, 3)),
                       epilogue="residual_add",
                       epilogue_args=(torch.zeros((1, 3, 20, 40)),),
                       mesh=object())
        elif case == "groups":
            ops.conv2d(torch.zeros((1, 4, 20, 40)), torch.ones((4, 2, 3, 3)),
                       groups=2, mesh=object())
        elif case == "stride":
            ops.conv2d(x, w, stride=2, mesh=object())
        elif case == "epilogue":
            engine.run_scan_plan(x, plan=dataclasses.replace(
                plan.scan_plan(8), epilogue=plan.normalize_epilogue("relu")))
        elif case == "mesh":
            ops.conv2d(x, w, mesh=object())
        elif case == "perlane":  # per-lane runs; its temporal blocking not
            engine.run_window_plan(x[None], torch.ones((3, 40)),
                                   plan=plan.depthwise_conv1d_plan(3),
                                   time_steps=2)
        elif case == "mxu":     # mxu runs, its per-lane mat-vec too (item
            # 5c), and fused stages; K2 refuses a chain whose stage no
            # launch holds (1089 taps of 1024) before it looks at the device
            p = dataclasses.replace(plan.conv2d_plan(33, 33), strategy="mxu")
            engine.MXU_KERNEL(x, (torch.ones((33, 33)),),
                              plan=dataclasses.replace(p, stages=(p,)),
                              block=(8, 16), time_steps=1)
        else:                   # one reduce axis runs; two do not
            engine.run_window_plan(
                torch.zeros((1, 2, 2, 20, 40)), torch.ones((3, 2, 2, 3, 3)),
                plan=dataclasses.replace(ssam_conv2d.plan_for_nchw(
                    (1, 2, 20, 40), (3, 2, 3, 3)), reduce_axes=2))


def test_tap_table_and_shared_memory_layout():
    _, p = _plans("2d5pt")
    tab = engine.tap_table(p, None)
    # steps {West}, {North, Current, South}, {East}: (shift, first tap,
    # taps, dense); the taps' slots (rows) and coefficient indices
    assert tab.steps == ((0, 0, 1, 0), (1, 1, 3, 1), (1, 4, 1, 0))
    assert tab.slots == (1, 0, 1, 2, 1) and tab.cidx == (3, 1, 0, 2, 4)
    dense = engine.tap_table(plan.conv2d_plan(2, 3), (3, 2))
    assert dense.cidx == (0, 2, 4, 1, 3, 5)
    assert all(d for *_, d in dense.steps)
    # one stage of 66 x 128 fp32, the 64 x 120 output tile, the 5 taps'
    # records and one more, the barriers, and the slack (P = 32 rows of
    # 128), from a 128-byte aligned start, rounded up to 16 bytes
    need = 128 + 4 * 66 * 128 + 4 * 64 * 120 + (8 * 6 + 8 * 3) \
        + 4 * 32 * 128
    assert engine.smem_bytes(p, (64, 120), 1) == -(-need // 16) * 16
    for name in NAMES:
        for t in (1, 2):
            pl = _plans(name)[1]
            assert engine.smem_bytes(pl, engine.default_block(pl, t), t) \
                <= engine.SMEM_LIMIT
    with pytest.raises(ValueError, match="warp"):
        engine.tap_table(plan.conv2d_plan(33, 1), (1, 33))
