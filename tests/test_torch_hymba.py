"""Parity of the port's Hymba training path with the JAX package.

``SMOKE`` runs in both packages on the reference's parameters
(``init_params(PRNGKey(0))``, carried over by
``convert.params_from_reference`` and back by
``convert.params_to_reference``). The JAX side composes the loss from
the reference's own layers with the conv at ``conv_impl="xla"`` and the
selective scan at ``scan_impl="engine"`` (the chunk-streamed JAX scan
engine, which runs here, ROADMAP R2): ``Hymba.loss`` would run the conv
on the JAX windowed engine, which needs ``pl.Unblocked`` (R1). Every
reference call runs under the ``raise`` failure policy
(``tests/conftest.py``). Tolerances: layers and ops fp32 rtol 1e-5 with
atol 1e-5·max|ref| (gradients of a layer 3e-5); the loss 1e-5 relative;
each gradient leaf of the model 1e-4·max|leaf|.
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
from repro.configs import hymba_1g5b as jcfgs
from repro.models import base as jbase
from repro.models.hymba import Hymba as JHymba
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import spec as jspec
from repro.nn import ssm as jssm
from repro_torch import _build, config, convert
from repro_torch.configs import hymba_1g5b as cfgs
from repro_torch.core import adjoint, engine
from repro_torch.launch import train
from repro_torch.models import base, build_model, hymba
from repro_torch.nn import attention, layers, spec, ssm

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FULL_PARAMS = 1_611_062_400
B, S = 2, 24


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _jleaf(tree, path):
    """The reference leaf of a port path: a list index selects a layer of
    the stacked leaf."""
    idx = [k for k in path if isinstance(k, int)]
    for k in path:
        if not isinstance(k, int):
            tree = tree[k]
    return np.asarray(tree)[idx[0]] if idx else np.asarray(tree)


def _tree(paths, values):
    """A nested dict (lists for integer keys) from ``(path, value)``
    pairs: the port's tree shape of :func:`spec.module_leaves` paths."""
    root = {}
    for path, v in zip(paths, values):
        node = root
        for k, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= k:
                    node.append({})
                node = node[k]
            else:
                node = node.setdefault(k, [] if isinstance(nxt, int) else {})
        node[path[-1]] = v
    return root


def _jax_loss_fn(c, jm):
    """The reference's Hymba loss composed from its own layers, the conv
    at ``impl="xla"`` and the scan on the JAX scan engine."""
    def jloss(p, tokens, labels):
        x = jlayers.embedding_apply(p["embed"], tokens).astype(jnp.float32)
        positions = jnp.arange(x.shape[1])
        glob = c.is_global_layers()
        for i in range(c.n_layers):
            pi = jax.tree.map(lambda a: a[i], p["layers"])
            h = jlayers.rmsnorm_apply(pi["norm_mix"], x)
            a, _ = jattn.gqa_apply(pi["attn"], h, jm.attn_cfg,
                                   positions=positions, is_global=glob[i])
            m, _ = jssm.mamba_apply(pi["mamba"], h, ssm_state=c.ssm_state,
                                    conv_k=c.conv_k, conv_impl="xla",
                                    scan_impl="engine")
            x = x + 0.5 * (a * pi["beta_attn"] + m * pi["beta_mamba"])
            h = jlayers.rmsnorm_apply(pi["norm_mlp"], x)
            x = x + jlayers.gated_mlp_apply(pi["ffn"], h, act="silu")
        x = jlayers.rmsnorm_apply(p["norm_f"], x)
        return jbase.chunked_cross_entropy(x, p["embed"]["table"], labels,
                                           chunk=c.loss_chunk)
    return jloss


@functools.lru_cache(maxsize=None)
def _run():
    """Loss and gradients of SMOKE in both packages."""
    c = jcfgs.SMOKE
    jm = JHymba(c)
    jp = jspec.init_params(jm.specs(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, c.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, c.vocab, (B, S)).astype(np.int32)
    labels[1, -3:] = -1
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss_fn(c, jm)))(
        jp, jnp.asarray(tokens), jnp.asarray(labels))
    model = build_model(cfgs.SMOKE, convert.params_from_reference(
        jax.tree.map(np.asarray, jp)))
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    adjoint.reset_lowering_counts()
    loss = model.loss(batch)
    leaves = list(spec.module_leaves(model.params))
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return (jp, float(jl), jg, model, loss.item(), leaves, grads,
            dict(adjoint.BACKWARD_LOWERINGS))


# --- configs and parameters -------------------------------------------------

@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_config_matches_reference(name):
    got, want = getattr(cfgs, name), getattr(jcfgs, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_global_layers() == tuple(
        bool(v) for v in np.asarray(want.is_global_layers()))
    assert config.get_config("hymba-1.5b") is cfgs.CONFIG
    assert config.get_config("hymba_1g5b", smoke=True) is cfgs.SMOKE
    assert dataclasses.asdict(jget_config("hymba-1.5b")) == \
        dataclasses.asdict(cfgs.CONFIG)


@pytest.mark.parametrize("kw", [{"window": 0}, {"global_every": 3},
                                {"global_every": 4, "global_layers": (1,)}])
def test_is_global_layers_match_reference(kw):
    got = dataclasses.replace(cfgs.CONFIG, **kw).is_global_layers()
    want = dataclasses.replace(jcfgs.CONFIG, **kw).is_global_layers()
    assert got == tuple(bool(v) for v in np.asarray(want))


def test_full_param_count_without_allocation():
    specs = hymba.specs(cfgs.CONFIG)
    assert spec.param_count(specs) == FULL_PARAMS
    jspecs = JHymba(jcfgs.CONFIG).specs()
    assert jspec.param_count(jspecs) == FULL_PARAMS
    got = {path: (s.shape, s.init, s.scale) for path, s in spec.leaves(specs)}
    want = {tuple(k.key for k in path): (s.shape, s.init, s.scale)
            for path, s in jax.tree_util.tree_leaves_with_path(
                jspecs, is_leaf=jspec.is_spec)}
    assert got == want
    # the published width: 32 layers, 3 of them global at a 1024 window
    assert cfgs.CONFIG.is_global_layers().count(True) == 3


def test_converter_goes_both_ways():
    jp, _, _, model, _, leaves, _, _ = _run()
    assert len(model.params["layers"]) == cfgs.SMOKE.n_layers
    for path, p in leaves:
        np.testing.assert_array_equal(p.detach().numpy(), _jleaf(jp, path),
                                      err_msg=str(path))
        assert p.requires_grad
    back = convert.params_to_reference(model.params)
    flat = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, want in flat:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, want, err_msg=str(path))


# --- layers -----------------------------------------------------------------

def test_rope_and_gated_mlp_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(3, 12)
    for rot in (16, 8, 0):
        cos, sin = layers.rope_table(_t(pos), rot, 1e4) if rot else (None,
                                                                      None)
        if rot:
            jc, js = jlayers.rope_table(jnp.asarray(pos), rot, 1e4)
            _close(cos, jc)
            _close(sin, js)
            _close(layers.apply_rope(_t(x), cos, sin, rot),
                   jlayers.apply_rope(jnp.asarray(x), jc, js, rot))
    h = rng.standard_normal((2, 7, 12)).astype(np.float32)
    mp = {k: rng.standard_normal(s).astype(np.float32) for k, s in
          (("w_gate", (12, 20)), ("w_up", (12, 20)), ("w_down", (20, 12)))}
    for act in ("silu", "gelu"):
        _close(layers.gated_mlp_apply({k: _t(v) for k, v in mp.items()},
                                      _t(h), act=act),
               jlayers.gated_mlp_apply(mp, jnp.asarray(h), act=act))
    with pytest.raises(ValueError, match="activation"):
        layers.gated_mlp_apply({k: _t(v) for k, v in mp.items()}, _t(h),
                               act="relu")


@pytest.mark.parametrize("is_global", [False, True])
@pytest.mark.parametrize("S_", [20, 37])
def test_windowed_gqa_matches_reference(is_global, S_):
    """``gqa_apply`` with an 8-token window (RoPE, GQA grouping, the
    window mask) against the reference's, and its gradients."""
    rng = np.random.default_rng(2)
    d, H, KV, hd = 24, 4, 2, 8
    cfg = attention.AttnConfig(d_model=d, n_heads=H, kv_heads=KV,
                               head_dim=hd, window=8)
    jcfg = jattn.AttnConfig(d_model=d, n_heads=H, kv_heads=KV, head_dim=hd,
                            window=8)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (d, H, hd)), ("wk", (d, KV, hd)),
                      ("wv", (d, KV, hd)), ("wo", (H, hd, d)))}
    x = rng.standard_normal((2, S_, d)).astype(np.float32)
    g = rng.standard_normal((2, S_, d)).astype(np.float32)
    tp = {k: _t(v, grad=True) for k, v in p.items()}
    tx = _t(x, grad=True)
    y, cache = attention.gqa_apply(tp, tx, cfg, positions=torch.arange(S_),
                                   is_global=is_global)
    assert cache is None

    def jf(pp, xx):
        return jattn.gqa_apply(pp, xx, jcfg, positions=jnp.arange(S_),
                               is_global=is_global)[0]

    _close(y, jf(p, jnp.asarray(x)))
    got = torch.autograd.grad(y, [tx] + list(tp.values()), _t(g))
    jgx, jgp = jax.grad(lambda pp, xx: jnp.sum(jf(pp, xx) * g),
                        argnums=(1, 0))(p, jnp.asarray(x))
    _close(got[0], jgx, 3e-5)
    for gg, k in zip(got[1:], tp):
        _close(gg, jgp[k], 3e-5)
    with pytest.raises(NotImplementedError, match="item 9"):
        attention.gqa_apply(tp, tx, cfg, positions=torch.arange(S_),
                            cache={"k": None, "v": None})


def test_windowed_chunked_attention_matches_reference_and_direct():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 37, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 37, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 37, 2, 8)).astype(np.float32)
    pos = np.arange(37)
    for glob in (False, True):
        want = jattn.mha_chunked(*map(jnp.asarray, (q, k, v, pos, pos)),
                                 window=8, is_global=glob, block_q=16,
                                 block_kv=16)
        t = [_t(a) for a in (q, k, v, pos, pos)]
        _close(attention.mha_chunked(*t, window=8, is_global=glob,
                                     block_q=16, block_kv=16), want)
        _close(attention.mha_direct(*t, window=8, is_global=glob), want)
    gen = torch.Generator().manual_seed(4)
    qq, kk, vv = (torch.randn(1, 30, 2, 4, generator=gen, dtype=torch.float64,
                              requires_grad=True) for _ in range(3))
    p = torch.arange(30)
    a = attention.mha_chunked(qq, kk, vv, p, p, window=5, is_global=False,
                              block_q=8, block_kv=8)
    b = attention.mha_direct(qq, kk, vv, p, p, window=5, is_global=False)
    torch.testing.assert_close(a, b)
    for x, y in zip(torch.autograd.grad(a.sum(), (qq, kk, vv)),
                    torch.autograd.grad(b.sum(), (qq, kk, vv))):
        torch.testing.assert_close(x, y)


# --- the Mamba branch -------------------------------------------------------

def _mamba_params(d, Di, N, K, seed):
    rng = np.random.default_rng(seed)
    r = max(d // 16, 1)

    def n(*s, scale=None):
        return (rng.standard_normal(s) * (scale or s[0] ** -0.5)).astype(
            np.float32)

    return {"in_proj": n(d, 2 * Di), "conv_w": n(K, Di, scale=0.5),
            "conv_b": n(Di, scale=0.1), "x_proj": n(Di, r + 2 * N),
            "dt_w": n(r, Di), "dt_b": n(Di, scale=0.1),
            "A_log": n(Di, N, scale=0.5), "D": n(Di, scale=1.0),
            "out_proj": n(Di, d)}


@functools.lru_cache(maxsize=None)
def _jax_mamba(seed):
    p = _mamba_params(32, 48, 8, 4, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    g = rng.standard_normal((2, 24, 32)).astype(np.float32)

    def f(pp, xx):
        return jssm.mamba_apply(pp, xx, ssm_state=8, conv_k=4, chunk=8,
                                conv_impl="xla", scan_impl="engine")[0]

    y = f(p, jnp.asarray(x))
    gp, gx = jax.grad(lambda pp, xx: jnp.sum(f(pp, xx) * g),
                      argnums=(0, 1))(p, jnp.asarray(x))
    return p, x, g, y, gp, gx


@pytest.mark.parametrize("impl", ["engine", "engine_unchunked"])
def test_mamba_apply_matches_reference(impl):
    """``mamba_apply`` with chunk 8 over T = 24 (three streamed chunks)
    against the reference's ``mamba_apply(conv_impl="xla",
    scan_impl="engine")``: output, input and every parameter gradient."""
    p, x, g, y, gp, gx = _jax_mamba(5)
    tp = {k: _t(v, grad=True) for k, v in p.items()}
    tx = _t(x, grad=True)
    adjoint.reset_lowering_counts()
    out, st = ssm.mamba_apply(tp, tx, ssm_state=8, conv_k=4, chunk=8,
                              scan_impl=impl)
    _close(out, y)
    assert st["h"].shape == (2, 48, 8) and st["conv"].shape == (2, 3, 48)
    got = torch.autograd.grad(out, [tx] + list(tp.values()), _t(g))
    _close(got[0], gx, 3e-5)
    for gg, k in zip(got[1:], tp):
        _close(gg, gp[k], 3e-5)
    low = dict(adjoint.BACKWARD_LOWERINGS)
    assert low["adj_conv1d"] == 1 and low["wgrad_conv1d"] == 1
    assert low.get("adj_recurrence_chunk" if impl == "engine"
                   else "adj_recurrence") == (3 if impl == "engine" else 1)


def test_selective_scan_schedules_and_what_raises():
    rng = np.random.default_rng(6)
    dt = _t(np.abs(rng.standard_normal((2, 19, 6))).astype(np.float32))
    A_log = _t(rng.standard_normal((6, 4)).astype(np.float32) * 0.3)
    Bm, Cm = (_t(rng.standard_normal((2, 19, 4)).astype(np.float32))
              for _ in range(2))
    x = _t(rng.standard_normal((2, 19, 6)).astype(np.float32))
    y1, h1 = ssm.selective_scan(dt, A_log, Bm, Cm, x, chunk=8)
    y2, h2 = ssm.selective_scan(dt, A_log, Bm, Cm, x,
                                impl="engine_unchunked")
    jy, jh = jssm.selective_scan(*(jnp.asarray(t.numpy()) for t in
                                   (dt, A_log, Bm, Cm, x)), chunk=8,
                                 impl="engine")
    for y, h in ((y1, h1), (y2, h2)):
        _close(y, jy)
        _close(h, jh)
    with pytest.raises(NotImplementedError, match="5b"):
        ssm.selective_scan(dt, A_log, Bm, Cm, x, impl="chunked")
    with pytest.raises(ValueError, match="impl"):
        ssm.selective_scan(dt, A_log, Bm, Cm, x, impl="xla")
    p = {k: _t(v) for k, v in _mamba_params(8, 6, 4, 4, 0).items()}
    with pytest.raises(NotImplementedError, match="item 9"):
        ssm.mamba_apply(p, torch.zeros(1, 1, 8), ssm_state=4,
                        state={"h": None, "conv": None})


# --- the model: loss, gradients, launches -------------------------------------

def test_smoke_loss_matches_reference():
    _, jl, _, _, loss, _, _, lowerings = _run()
    assert abs(loss - jl) <= 1e-5 * abs(jl)
    # per layer: the conv's dx and dW, the scan's chunk adjoint (one chunk)
    assert lowerings == {"adj_conv1d": 2, "wgrad_conv1d": 2,
                         "adj_recurrence_chunk": 2}


def test_every_gradient_leaf_matches_jax_grad():
    _, _, jg, _, _, leaves, grads, _ = _run()
    for (path, _), g in zip(leaves, grads):
        want = _jleaf(jg, path)
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, atol=1e-4 * float(np.abs(want).max()),
            err_msg=str(path))
    # the port's gradients, laid out as the reference's tree
    back = convert.params_to_reference(_tree([p for p, _ in leaves], grads))
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("remat,impl", [(True, "engine"), (False, "engine"),
                                        (True, "engine_unchunked")])
def test_train_launches_match_the_code(remat, impl, monkeypatch):
    """``hymba.train_launches`` (what the card's counters must read per
    step) against the calls the plain versions get on the CPU for one
    loss and its gradients, at 300 tokens (three scan chunks), each call
    counted as the launches the kernel makes for it."""
    calls = {"k1": 0, "k4": 0, "k5": 0}
    per_call = {"k1": lambda *a, **k: 1,
                "k4": engine.PERLANE_WGRAD_KERNEL.launches_for,
                "k5": lambda *a, **k: 1}
    for name, key in (("run_window_plan_reference", "k1"),
                      ("run_weight_grad_plan_reference", "k4"),
                      ("run_scan_plan_reference", "k5")):
        def count(*a, _f=getattr(engine, name), _k=key, **k):
            calls[_k] += per_call[_k](*a, **k)
            return _f(*a, **k)
        monkeypatch.setattr(engine, name, count)
    cfg = dataclasses.replace(cfgs.SMOKE, remat=remat, scan_impl=impl)
    model = build_model(cfg, device="cpu")
    tok = torch.randint(0, cfg.vocab, (1, 300),
                        generator=torch.Generator().manual_seed(0))
    loss = model.loss({"tokens": tok, "labels": tok})
    torch.autograd.grad(loss, [p for _, p in spec.module_leaves(
        model.params)])
    assert calls == hymba.train_launches(cfg, 300, 1)
    full = hymba.train_launches(cfgs.CONFIG, 2048, 2)
    assert full == {"k1": 128, "k4": 64, "k5": 2048}


def test_remat_changes_no_value():
    jp = _run()[0]
    tok = torch.arange(2 * S).reshape(2, S) % cfgs.SMOKE.vocab
    out = {}
    for remat in (True, False):
        m = build_model(dataclasses.replace(cfgs.SMOKE, remat=remat),
                        convert.params_from_reference(
                            jax.tree.map(np.asarray, jp)))
        loss = m.loss({"tokens": tok, "labels": tok})
        out[remat] = (loss.item(), torch.autograd.grad(
            loss, [p for _, p in spec.module_leaves(m.params)]))
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert base.remat(len, False) is len


# --- the CLI ----------------------------------------------------------------

def test_train_cli_smoke_on_cpu(capsys):
    res = train.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "24"])
    out = capsys.readouterr().out
    assert "[train] done: loss" in out
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert res.trainer.state["step"] == 2
    assert res.peak_mem_gb == []
    assert not _build.LIBRARY.loaded
    assert engine.WINDOW_KERNEL.launches == 0
    assert engine.PERLANE_WGRAD_KERNEL.launches == 0
    assert engine.SCAN_KERNEL.launches == 0
    res = train.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                      "--steps", "1", "--batch", "1", "--seq", "9",
                      "--scan-impl", "engine_unchunked"])
    assert res.trainer.model.cfg.scan_impl == "engine_unchunked"
    assert np.isfinite(res.losses[0])


def test_train_cli_rejects_what_is_not_ported():
    argv = ["--arch", "hymba-1.5b", "--smoke", "--device", "cpu", "--steps",
            "1", "--seq", "8", "--batch", "1"]
    with pytest.raises(NotImplementedError, match="5b"):
        train.main(argv + ["--scan-impl", "chunked"])
    with pytest.raises(SystemExit):
        train.main(argv + ["--conv-frontend"])


def test_hymba_cli_runs_as_a_module_without_jax():
    """``python -m repro_torch.launch.train --arch hymba-1.5b`` on the CPU
    in a fresh interpreter that never loads JAX."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['train', '--arch', 'hymba-1.5b', '--smoke',\n"
        "            '--device', 'cpu', '--steps', '2', '--seq', '16',\n"
        "            '--batch', '2']\n"
        "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k == 'repro'\n"
        "             or k.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[train] done" in res.stdout
