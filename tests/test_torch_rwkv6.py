"""Parity of the port's RWKV6 model and decode server with the JAX package.

The SMOKE config runs in both packages on the reference's parameters
(``init_params(PRNGKey(0))``, carried over as numpy by
``convert.params_from_reference``), with the reference on its
chunk-streamed engine schedule (``scan_impl="engine"``, the Pallas scan
engine in interpret mode). Tolerance: fp32 rtol 1e-5 with atol
1e-5·max|ref|; greedy tokens must be equal.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import build_model as jbuild_model
from repro.nn import spec as jspec
from repro_torch import config, convert
from repro_torch.launch import serve
from repro_torch.models import build_model, rwkv6
from repro_torch.nn import spec

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FULL_PARAMS = 1_465_503_744


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(jget_config("rwkv6_1g6b", smoke=True),
                               scan_impl="engine")
    jmodel = jbuild_model(jcfg)
    jparams = jspec.init_params(jmodel.specs(), jax.random.PRNGKey(0))
    model = build_model(config.get_config("rwkv6-1.6b", smoke=True),
                        _port_params(jparams))
    return jmodel, jparams, model


def _port_params(jparams):
    return convert.params_from_reference(jax.tree.map(np.asarray, jparams))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape, dtype=np.int32)


def _np_state(st):
    return {k: np.asarray(v) for k, v in st.items()}


# --- configs and parameters -------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    got = config.get_config("rwkv6-1.6b", smoke=smoke)
    want = jget_config("rwkv6-1.6b", smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_dtype == torch.float32 and got.scan_schedule == "engine"
    assert config.get_config("rwkv6_1g6b", smoke=smoke) == got


def test_other_archs_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        config.get_config("gemma3-1b")
    cfg = dataclasses.replace(config.get_config("rwkv6-1.6b", smoke=True),
                              family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        build_model(cfg, device="cpu")


def test_full_param_count_without_allocation():
    cfg = config.get_config("rwkv6-1.6b")
    specs = rwkv6.specs(cfg)
    assert spec.param_count(specs) == FULL_PARAMS
    jmodel = jbuild_model(jget_config("rwkv6-1.6b"))
    assert jspec.param_count(jmodel.specs()) == FULL_PARAMS
    jleaves = jax.tree_util.tree_leaves_with_path(
        jmodel.specs(), is_leaf=jspec.is_spec)
    got = {path: (s.shape, s.init, s.scale) for path, s in spec.leaves(specs)}
    want = {tuple(k.key for k in path): (s.shape, s.init, s.scale)
            for path, s in jleaves}
    assert got == want


def test_init_params_draws_the_reference_stds():
    """Leaf by leaf, the port's draws have the reference's spread (and
    its constants where the init is 'ones' or 'zeros')."""
    cfg = config.get_config("rwkv6-1.6b", smoke=True)
    g = torch.Generator().manual_seed(0)
    p = spec.init_params(rwkv6.specs(cfg), g, "cpu")
    _, jparams, _ = _models()
    jp = dict(spec.leaves(jax.tree.map(np.asarray, jparams)))
    for path, t in spec.leaves(p):
        want = jp[path]
        assert tuple(t.shape) == want.shape, path
        if want.std() == 0 or want.size < 2000:
            if want.std() == 0:
                np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
            continue
        assert abs(t.std().item() / want.std() - 1) < 0.1, path
    # 'normal' leaves of stacked specs: fan-in is the leading (layer) axis
    wk = p["layers"]["cm"]["wk"]
    assert abs(wk.std().item() * np.sqrt(cfg.n_layers) - 1) < 0.05
    model = rwkv6.RWKV6(cfg, device="cpu", seed=0)
    again = rwkv6.RWKV6(cfg, device="cpu", seed=0)
    assert torch.equal(model.params["layers"][1]["cm"]["wk"], wk[1])
    assert torch.equal(again.params["embed"]["table"], p["embed"]["table"])
    # the model trains (launch.train's ssm family): its parameters are
    # leaves that take gradients; serving runs without autograd
    assert all(t.requires_grad for t in model.parameters())


# --- (d) the SMOKE model against the reference -----------------------------

def test_forward_matches_reference():
    jmodel, jparams, model = _models()
    toks = _tokens((2, 40), 0)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    _close(model(torch.from_numpy(toks).long()), want)
    _close(model.prefill_logits(torch.from_numpy(toks).long()),
           jmodel.prefill_logits(jparams, {"tokens": jnp.asarray(toks)}))


def test_prefill_and_serve_steps_match_reference():
    jmodel, jparams, model = _models()
    toks = _tokens((2, 37), 1)
    jlog, jst = jmodel.prefill(jparams, jnp.asarray(toks))
    log, st = model.prefill(torch.from_numpy(toks).long())
    _close(log, jlog)
    assert st.keys() == jst.keys()
    for k in st:
        _close(st[k], jst[k])
    nxt = _tokens((4, 2, 1), 2)
    for i in range(4):
        jlog, jst = jmodel.serve_step(jparams, jst, jnp.asarray(nxt[i]),
                                      jnp.full((2,), 37 + i, jnp.int32))
        log, st = model.serve_step(st, torch.from_numpy(nxt[i]).long())
        _close(log, jlog)
        for k in st:
            _close(st[k], jst[k])


def test_state_from_reference_continues_the_reference():
    jmodel, jparams, model = _models()
    toks = _tokens((2, 20), 3)
    _, jst = jmodel.prefill(jparams, jnp.asarray(toks))
    st = convert.state_from_reference(_np_state(jst))
    nxt = _tokens((2, 1), 4)
    jlog, _ = jmodel.serve_step(jparams, jst, jnp.asarray(nxt),
                                jnp.zeros((2,), jnp.int32))
    log, _ = model.serve_step(st, torch.from_numpy(nxt).long())
    _close(log, jlog)


@pytest.mark.parametrize("impl", ["engine", "engine_unchunked"])
def test_prefill_equals_token_by_token(impl):
    _, jparams, model = _models()
    m = rwkv6.RWKV6(dataclasses.replace(model.cfg, scan_impl=impl),
                    _port_params(jparams))
    toks = torch.from_numpy(_tokens((1, 33), 5)).long()
    log, st = m.prefill(toks)
    state = spec.init_params(m.decode_state_specs(1, 64), device="cpu")
    for i in range(33):
        seq_log, state = m.serve_step(state, toks[:, i:i + 1])
    _close(log, seq_log.numpy())
    for k in st:
        _close(st[k], state[k].numpy())


# --- (e) the decode server against the reference's -------------------------

def _requests(mod, n=5, length=9, max_new=6):
    return [mod.Request(i, _tokens((length,), 10 + i), max_new)
            for i in range(n)]


def test_decode_server_matches_reference():
    jmodel, jparams, model = _models()
    jdone = jserve.DecodeServer(jmodel, jparams, slots=2,
                                cache_len=32).run(_requests(jserve))
    server = serve.DecodeServer(model, slots=2, cache_len=32)
    done = server.run(_requests(serve))
    want = {r.rid: r.out for r in jdone}
    assert {r.rid: r.out for r in done} == want
    assert all(len(o) == 6 for o in want.values())
    assert all(r.error is None for r in done)
    assert len(server.step_seconds) == server.steps


def test_slot_reuse_no_state_leak():
    """A request decoded in a reused slot matches one in a fresh server."""
    _, _, model = _models()
    p1 = np.array([1, 2, 3], np.int32)
    p2 = np.array([9, 8, 7], np.int32)
    fresh = serve.DecodeServer(model, slots=1, cache_len=32)
    [r_fresh] = fresh.run([serve.Request(0, p2, 4)])
    reused = serve.DecodeServer(model, slots=1, cache_len=32)
    done = reused.run([serve.Request(0, p1, 4), serve.Request(1, p2, 4)])
    r_reused = [r for r in done if r.rid == 1][0]
    assert r_reused.out == r_fresh.out


def test_cache_len_and_one_token_prompts():
    _, _, model = _models()
    server = serve.DecodeServer(model, slots=2, cache_len=8)
    done = server.run([serve.Request(0, np.array([5], np.int32), 20),
                       serve.Request(1, _tokens((4,), 6), 20)])
    outs = {r.rid: r.out for r in done}
    # a request stops at index cache_len - 1
    assert len(outs[0]) == 7 and len(outs[1]) == 4


def test_temperature_sampling_is_seeded():
    _, _, model = _models()

    def run(seed):
        s = serve.DecodeServer(model, slots=2, cache_len=32,
                               temperature=1.0, seed=seed)
        return [r.out for r in s.run(_requests(serve, n=3))]

    a, b = run(0), run(0)
    assert a == b and all(0 <= t < 512 for o in a for t in o)
    assert run(1) != a


def test_deadline_and_step_errors():
    _, _, model = _models()
    server = serve.DecodeServer(model, slots=1, cache_len=32)
    req = serve.Request(0, _tokens((5,), 7), 50, deadline_s=0.0)
    [done] = server.run([req])
    assert done.done and done.error == "deadline" and len(done.out) < 50

    class Broken:
        device = model.device
        decode_state_specs = model.decode_state_specs
        prefill = model.prefill

        def serve_step(self, *a):
            raise RuntimeError("step failed")

    with pytest.raises(RuntimeError, match="step failed"):
        serve.DecodeServer(Broken(), slots=1, cache_len=32).run(
            _requests(serve, n=1))


# --- (g) the serve CLI ------------------------------------------------------

def test_serve_cli_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "rwkv6-1.6b", "--smoke", "--device", "cpu"], env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "8 requests, 128 tokens" in res.stdout
