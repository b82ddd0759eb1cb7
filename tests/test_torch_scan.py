"""Parity of the port's scan family (K5's plain version and the ops over
it) with the JAX package.

The JAX scan engine runs here through the Pallas interpreter (ROADMAP
R2), so the port's plain version is held directly against
``repro.core.engine.run_scan_plan(..., interpret=True)`` and the JAX
scan ops, on the same numpy inputs. Tolerance: fp32 rtol 1e-5 with atol
1e-5·max|ref|. Each distinct JAX call runs once and is cached: the
reference's output does not depend on ``block_r`` (rows are independent)
nor on whether the carry-out is returned.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import ssm as jssm
from repro_torch import _build, convert
from repro_torch.core import engine, plan
from repro_torch.kernels import ops, ref, ssam_scan
from repro_torch.nn import ssm

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHAPES = [(5, 300), (16, 64), (3, 7)]
COMBINES = ("add", "linrec")


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _pairs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


def _operands(combine, shape, seed=0):
    a, b = _pairs(shape, seed)
    return (a, b) if combine == "linrec" else (b,)


def _plans(combine, S):
    build = jplan.linear_recurrence_plan if combine == "linrec" \
        else jplan.scan_plan
    jp = build(S)
    p = convert.plan_from_reference(dataclasses.asdict(jp))
    assert p == (plan.linear_recurrence_plan if combine == "linrec"
                 else plan.scan_plan)(S)
    return jp, p


@functools.lru_cache(maxsize=None)
def _jax_scan(combine, S, shape, has_carry):
    jp, _ = _plans(combine, S)
    xs = _operands(combine, shape)
    carry = _pairs((shape[0],), 1)[1] if has_carry else None
    out, co = jengine.run_scan_plan(
        *map(jnp.asarray, xs), plan=jp, block_r=8, interpret=True,
        carry=None if carry is None else jnp.asarray(carry),
        return_carry=True, backend="tpu")
    return np.asarray(out), np.asarray(co), carry


# --- (a) the plain version against the JAX scan engine ---------------------

@pytest.mark.parametrize("return_carry", [False, True])
@pytest.mark.parametrize("has_carry", [False, True])
@pytest.mark.parametrize("block_r", [1, 8])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("S", [1, 8, 32, 128])
@pytest.mark.parametrize("combine", COMBINES)
def test_plain_version_matches_reference_engine(combine, S, shape, block_r,
                                                has_carry, return_carry):
    want, want_co, carry = _jax_scan(combine, S, shape, has_carry)
    _, p = _plans(combine, S)
    xs = [torch.from_numpy(x) for x in _operands(combine, shape)]
    res = engine.run_scan_plan_reference(
        *xs, plan=p, block_r=block_r,
        carry=None if carry is None else torch.from_numpy(carry),
        return_carry=return_carry)
    if return_carry:
        out, co = res
        assert co.shape == (shape[0], 1)
        _close(co, want_co)
    else:
        out = res
    _close(out, want)
    assert out.dtype == torch.float32


def test_reference_engine_ignores_block_r():
    """The premise of the cache above: block_r does not change a value."""
    jp, _ = _plans("linrec", 8)
    a, b = map(jnp.asarray, _operands("linrec", (5, 300)))
    one = jengine.run_scan_plan(a, b, plan=jp, block_r=1, interpret=True,
                                backend="tpu")
    np.testing.assert_array_equal(np.asarray(one),
                                  _jax_scan("linrec", 8, (5, 300), False)[0])


def test_plain_version_dispatch_and_bf16():
    _, p = _plans("linrec", 32)
    a, b = (torch.from_numpy(x) for x in _operands("linrec", (5, 300)))
    torch.testing.assert_close(engine.run_scan_plan(a, b, plan=p),
                               engine.run_scan_plan_reference(a, b, plan=p))
    out = engine.run_scan_plan(a.bfloat16(), b.bfloat16(), plan=p)
    assert out.dtype == torch.bfloat16
    want = ref.linear_recurrence(a.bfloat16().float(), b.bfloat16().float())
    torch.testing.assert_close(out.float(), want, rtol=3e-2,
                               atol=3e-2 * want.abs().max().item())


def test_scan_plan_checks():
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="combine='fma'"):
        engine.run_scan_plan(x, plan=plan.conv2d_plan(3, 3))
    with pytest.raises(ValueError, match="2 operand"):
        engine.run_scan_plan(x, plan=plan.linear_recurrence_plan(8))
    with pytest.raises(ValueError, match="one non-empty"):
        engine.run_scan_plan(x, torch.zeros((4, 8)),
                             plan=plan.linear_recurrence_plan(8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.run_scan_plan(x, plan=dataclasses.replace(
            plan.scan_plan(8), epilogue=(plan.EpilogueStage("relu"),)))
    with pytest.raises(ValueError, match="run_scan_plan"):
        engine.run_window_plan(x, plan=plan.scan_plan(8))
    with pytest.raises(ValueError, match="device"):
        engine.run_scan_plan(x.to("meta"), plan=plan.scan_plan(8))
    with pytest.raises(ValueError, match="CUDA"):
        engine.SCAN_KERNEL(x, plan=plan.scan_plan(8))


# --- (b) the ops against the JAX ops and the oracles -----------------------

@pytest.mark.parametrize("shape", [(5, 300), (3, 7)])
def test_cumsum_and_sat_match_reference(shape):
    _, x = _pairs(shape, 2)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    want = np.asarray(jops.cumsum(jx, impl="interpret"))
    _close(ops.cumsum(tx), want)
    _close(ops.cumsum(tx), np.asarray(jref.cumsum(jx)))
    _close(ref.cumsum(tx), np.asarray(jref.cumsum(jx)))
    want = np.asarray(jops.sat(jx, impl="interpret"))
    _close(ops.sat(tx), want)
    _close(ops.sat(tx), np.asarray(jref.sat(jx)))
    _close(ref.sat(tx), np.asarray(jref.sat(jx)))


@pytest.mark.parametrize("block_t", [8, 128])
def test_linear_recurrence_matches_reference(block_t):
    a, b = _pairs((5, 300), 3)
    ta, tb, ja, jb = (torch.from_numpy(a), torch.from_numpy(b),
                      jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(jops.linear_recurrence(ja, jb, impl="interpret",
                                             block_t=block_t))
    _close(ops.linear_recurrence(ta, tb, block_t=block_t), want)
    _close(ops.linear_recurrence(ta, tb, block_t=block_t),
           np.asarray(jref.linear_recurrence(ja, jb)))
    _close(ref.linear_recurrence(ta, tb),
           np.asarray(jref.linear_recurrence(ja, jb)))


@pytest.mark.parametrize("h0_shape", [(5,), (5, 1)])
def test_linear_recurrence_carry_matches_reference(h0_shape):
    a, b = _pairs((5, 300), 4)
    h0 = _pairs(h0_shape, 5)[1]
    h, hT = ops.linear_recurrence_carry(*map(torch.from_numpy, (a, b, h0)))
    jh, jhT = jops.linear_recurrence_carry(*map(jnp.asarray, (a, b, h0)),
                                           impl="interpret")
    assert hT.shape == (5, 1)
    _close(h, np.asarray(jh))
    _close(hT, np.asarray(jhT))
    b2 = b.copy()
    b2[:, 0] += a[:, 0] * h0.reshape(5)
    _close(h, np.asarray(jref.linear_recurrence(jnp.asarray(a),
                                                jnp.asarray(b2))))


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("impl", ["engine", "engine_unchunked"])
def test_chunked_linear_recurrence_matches_reference(impl, chunk):
    a, b = _pairs((2, 3, 300), 6)         # leading axes flatten; T ragged
    got = ops.chunked_linear_recurrence(torch.from_numpy(a),
                                        torch.from_numpy(b), chunk=chunk,
                                        impl=impl)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = np.asarray(jops.chunked_linear_recurrence(ja, jb, chunk=chunk,
                                                     impl=impl))
    assert got.shape == a.shape
    _close(got, want)
    _close(got, np.asarray(jref.linear_recurrence(ja, jb)))


@pytest.mark.parametrize("combine", COMBINES)
def test_chunked_engine_threads_the_carry(combine):
    _, p = _plans(combine, 32)
    xs = [torch.from_numpy(x) for x in _operands(combine, (5, 300))]
    h0 = torch.from_numpy(_pairs((5,), 7)[1])
    out, co = engine.run_scan_plan_chunked(*xs, plan=p, chunk=64, carry=h0,
                                           return_carry=True)
    whole, wco = engine.run_scan_plan_reference(*xs, plan=p, carry=h0,
                                                return_carry=True)
    _close(out, whole.numpy())
    _close(co, wco.numpy())


CHUNK_CASES = [(32, 32), (32, 64), (32, 16), (32, 48), (64, 96), (8, 8),
               (128, 64), (16, 100)]


@pytest.mark.parametrize("S,chunk", CHUNK_CASES)
def test_chunk_geometry_raises_as_reference(S, chunk):
    jp, p = _plans("linrec", S)
    for jpl, pl in ((jp, p), (dataclasses.replace(
            jp, epilogue=(jplan.EpilogueStage("relu"),)),
            dataclasses.replace(p, epilogue=(plan.EpilogueStage("relu"),)))):
        try:
            jengine.check_chunk_geometry(jpl, chunk)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                engine.check_chunk_geometry(pl, chunk)
            assert str(got.value) == str(e)
        else:
            engine.check_chunk_geometry(pl, chunk)


def test_chunked_op_rejects_what_the_reference_rejects():
    a, b = (torch.from_numpy(x) for x in _pairs((4, 200), 8))
    with pytest.raises(ValueError, match="not a multiple"):
        ops.chunked_linear_recurrence(a, b, chunk=96)
    with pytest.raises(ValueError, match="not a multiple"):
        jops.chunked_linear_recurrence(jnp.asarray(a.numpy()),
                                       jnp.asarray(b.numpy()), chunk=96,
                                       impl="engine")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.chunked_linear_recurrence(a, b, impl="chunked")
    with pytest.raises(ValueError, match="impl"):
        ops.chunked_linear_recurrence(a, b, impl="pallas")


@pytest.mark.parametrize("kw,err", [
    ({"mesh": None}, ValueError), ({"epilogue": "relu"}, ValueError),
    ({"stride": 2}, ValueError), ({"impl": "interpret"}, TypeError)])
@pytest.mark.parametrize("op", ["cumsum", "sat", "linear_recurrence",
                                "linear_recurrence_carry"])
def test_scan_ops_reject_kwargs(op, kw, err):
    x = torch.ones((4, 16))
    args = {"cumsum": (x,), "sat": (x,), "linear_recurrence": (x, x),
            "linear_recurrence_carry": (x, x, torch.zeros(4))}[op]
    with pytest.raises(err):
        getattr(ops, op)(*args, **kw)


# --- (c) the WKV6 schedules against the reference's -----------------------

def _wkv_inputs(seed=9, B=2, T=40, H=4, K=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, T, H, K)).astype(np.float32))
    u = (0.5 * rng.standard_normal((H, K))).astype(np.float32)
    return r, k, v, logw, u


@functools.lru_cache(maxsize=None)
def _jax_wkv():
    xs = tuple(map(jnp.asarray, _wkv_inputs()))
    eng = jssm.wkv6_chunked(*xs, chunk=16, impl="engine")
    seq = jssm.wkv6_sequential(*xs)
    return tuple(np.asarray(t) for t in eng + seq)


@pytest.mark.parametrize("impl", ["engine", "engine_unchunked"])
def test_wkv6_matches_reference(impl):
    y_eng, S_eng, y_seq, S_seq = _jax_wkv()
    y, S = ssm.wkv6_chunked(*map(torch.from_numpy, _wkv_inputs()), chunk=16,
                            impl=impl)
    assert S.shape == (2, 4, 16, 16) and S.dtype == torch.float32
    _close(y, y_eng)
    _close(S, S_eng)
    _close(y, y_seq)
    _close(S, S_seq)


def test_wkv6_sequential_matches_reference():
    _, _, y_seq, S_seq = _jax_wkv()
    y, S = ssm.wkv6_sequential(*map(torch.from_numpy, _wkv_inputs()))
    _close(y, y_seq)
    _close(S, S_seq)


def test_wkv6_stream_launches_one_scan_per_chunk(monkeypatch):
    calls = []
    real = ops.linear_recurrence_carry

    def spy(a, b, h0, **kw):
        calls.append(tuple(a.shape))
        return real(a, b, h0, **kw)

    monkeypatch.setattr(ops, "linear_recurrence_carry", spy)
    ssm.wkv6_chunked(*map(torch.from_numpy, _wkv_inputs()), chunk=16)
    assert calls == [(2 * 4 * 16 * 16, 16)] * 3          # ⌈40/16⌉ chunks
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssm.wkv6_chunked(*map(torch.from_numpy, _wkv_inputs()),
                         impl="chunked")


# --- (f) no JAX in the port; a CPU tensor never loads K5 ------------------

SCAN_MODULES = ["repro_torch.kernels.ssam_scan", "repro_torch.nn.spec",
                "repro_torch.nn.layers", "repro_torch.nn.ssm",
                "repro_torch.models.base", "repro_torch.models.rwkv6",
                "repro_torch.configs.rwkv6_1g6b", "repro_torch.config",
                "repro_torch.launch.serve", "repro_torch.convert"]


def test_new_modules_import_no_jax():
    code = (
        "import sys, importlib, pkgutil, repro_torch\n"
        f"mods = {SCAN_MODULES!r}\n"
        "walked = {m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')}\n"
        "assert set(mods) <= walked, set(mods) - walked\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k == 'repro'\n"
        "             or k.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cpu_tensor_never_loads_the_scan_kernel():
    a, b = (torch.from_numpy(x) for x in _pairs((4, 200), 10))
    ops.cumsum(b)
    ops.sat(b)
    ops.linear_recurrence(a, b)
    ops.linear_recurrence_carry(a, b, torch.zeros(4))
    ops.chunked_linear_recurrence(a, b, chunk=64)
    ssam_scan.cumsum(b, return_carry=True)
    assert not _build.LIBRARY.loaded
    assert engine.SCAN_KERNEL.launches == 0
