"""Parity of the port's RWKV6 training path with the JAX package.

``SMOKE`` runs in both packages on the reference's parameters
(``init_params(PRNGKey(0))``, carried over by
``convert.params_from_reference``). The JAX side is the reference's own
``RWKV6.loss`` with ``scan_impl="engine"`` (the chunk-streamed JAX scan
engine, which runs here, ROADMAP R2; the reference's CPU default is
``"chunked"``) under ``jax.value_and_grad``, every reference call under
the ``raise`` failure policy (``tests/conftest.py``). 40 tokens make
three WKV chunks of 16, the last padded. Tolerances: the loss 1e-5
relative; each gradient leaf 3e-5·max|leaf|, the fp32 tolerance of
DESIGN.md §6: the same products summed in another order (the port's
per-chunk contractions and per-layer loop, the reference's einsums under
``lax.scan``) put layer 1's time-mix leaves (``shift_w2``, ``wr``,
``wk``, ``mu``) 1.2–1.4e-5·max|leaf| from ``jax.grad``, every other
leaf below 1e-5.
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

from repro.models.rwkv6 import RWKV6 as JRWKV6
from repro.configs import rwkv6_1g6b as jcfgs
from repro.nn import spec as jspec
from repro_torch import _build, convert
from repro_torch.configs import rwkv6_1g6b as cfgs
from repro_torch.core import adjoint, engine
from repro_torch.launch import train
from repro_torch.models import base, build_model, rwkv6
from repro_torch.nn import spec, ssm

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B, S = 2, 40
GRAD_RTOL = 3e-5


def _jleaf(tree, path):
    """The reference leaf of a port path: a list index selects a layer of
    the stacked leaf."""
    idx = [k for k in path if isinstance(k, int)]
    for k in path:
        if not isinstance(k, int):
            tree = tree[k]
    return np.asarray(tree)[idx[0]] if idx else np.asarray(tree)


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfgs.SMOKE.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfgs.SMOKE.vocab, (B, S)).astype(np.int32)
    labels[1, -5:] = -1
    return tokens, labels


@functools.lru_cache(maxsize=None)
def _run():
    """Loss and gradients of SMOKE in both packages."""
    jcfg = dataclasses.replace(jcfgs.SMOKE, scan_impl="engine")
    jm = JRWKV6(jcfg)
    jp = jspec.init_params(jm.specs(), jax.random.PRNGKey(0))
    tokens, labels = _batch()
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params = convert.params_from_reference(jax.tree.map(np.asarray, jp))
    model = build_model(cfgs.SMOKE, params)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()}
    adjoint.reset_lowering_counts()
    loss = model.loss(batch)
    leaves = list(spec.module_leaves(model.params))
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return (params, float(jl), jg, loss.item(), leaves, grads,
            dict(adjoint.BACKWARD_LOWERINGS))


def test_smoke_loss_matches_reference():
    _, jl, _, loss, _, _, lowerings = _run()
    assert abs(loss - jl) <= 1e-5 * abs(jl)
    # per layer, the WKV's three chunks each transpose to a reversed scan
    assert lowerings == {"adj_recurrence_chunk": 3 * cfgs.SMOKE.n_layers}


def test_every_gradient_leaf_matches_jax_grad():
    _, _, jg, _, leaves, grads, _ = _run()
    # every reference leaf is held: the top ones once, the stacked ones
    # once a layer
    top = sum(not any(isinstance(k, int) for k in path) for path, _ in leaves)
    assert len(leaves) - top == cfgs.SMOKE.n_layers * (
        len(jax.tree_util.tree_leaves(jg)) - top)
    for (path, p), g in zip(leaves, grads):
        want = _jleaf(jg, path)
        assert g.shape == p.shape
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=GRAD_RTOL * float(np.abs(want).max()), err_msg=str(path))


def test_remat_changes_no_value():
    params = _run()[0]
    tokens, labels = _batch()
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.from_numpy(labels).long()}
    out = {}
    for remat in (True, False):
        m = build_model(dataclasses.replace(cfgs.SMOKE, remat=remat), params)
        loss = m.loss(batch)
        out[remat] = (loss.item(), torch.autograd.grad(
            loss, [p for _, p in spec.module_leaves(m.params)]))
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("remat,impl", [(True, "engine"), (False, "engine"),
                                        (True, "engine_unchunked"),
                                        (False, "engine_unchunked")])
def test_train_launches_match_the_code(remat, impl, monkeypatch):
    """``rwkv6.train_launches`` (what the card's counters must read per
    step) against the calls the plain versions get on the CPU for one
    loss and its gradients at 40 tokens (three chunks, the last padded):
    with remat, K5 four times a chunk (forward, the layer's recompute,
    the chunk checkpoint's recompute, the λ-recurrence), which only the
    per-chunk checkpoint makes; no windowed kernel."""
    calls = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0}
    for name, key in (("run_window_plan_reference", "k1"),
                      ("run_weight_grad_plan_reference", "k3"),
                      ("run_scan_plan_reference", "k5")):
        def count(*a, _f=getattr(engine, name), _k=key, **k):
            calls[_k] += 1
            return _f(*a, **k)
        monkeypatch.setattr(engine, name, count)
    cfg = dataclasses.replace(cfgs.SMOKE, remat=remat, scan_impl=impl)
    model = build_model(cfg, device="cpu")
    tok = torch.randint(0, cfg.vocab, (1, S),
                        generator=torch.Generator().manual_seed(0))
    loss = model.loss({"tokens": tok, "labels": tok})
    torch.autograd.grad(loss, [p for _, p in spec.module_leaves(
        model.params)])
    assert calls == rwkv6.train_launches(cfg, S, 1)
    if impl == "engine":
        assert calls["k5"] == cfg.n_layers * 3 * (4 if remat else 3)
    full = rwkv6.train_launches(cfgs.CONFIG, 2048, 2)
    assert full == {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 3072}


def test_wkv_stream_checkpoints_each_chunk(monkeypatch):
    """Under autograd the streamed WKV keeps no ``(B, L, H, K, V)`` slab of
    a chunk for its backward (the chunk is checkpointed: only its inputs
    and the carried state stay), while the same stream without the
    checkpoint keeps several; values and gradients are the same."""
    rng = np.random.default_rng(3)
    Bn, T, H, K = 2, 40, 3, 8
    r, k, v = (torch.from_numpy(rng.standard_normal((Bn, T, H, K)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    logw = torch.from_numpy(-np.abs(rng.standard_normal((Bn, T, H, K)))
                            .astype(np.float32)).requires_grad_()
    u = torch.from_numpy(rng.standard_normal((H, K)).astype(np.float32))
    slab = Bn * 16 * H * K * K

    def run():
        saved = []

        def pack(t):
            saved.append(t.numel())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, S_last = ssm.wkv6_chunked(r, k, v, logw, u, chunk=16)
        grads = torch.autograd.grad((y * y).sum() + S_last.sum(),
                                    (r, k, v, logw))
        return max(saved), y.detach(), grads

    kept, y, grads = run()
    assert kept < slab
    monkeypatch.setattr(ssm, "checkpoint",
                        lambda fn, *a, use_reentrant: fn(*a))
    kept_plain, y_plain, grads_plain = run()
    assert kept_plain >= slab
    torch.testing.assert_close(y, y_plain, rtol=0, atol=0)
    for a, b in zip(grads, grads_plain):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_serving_runs_without_autograd():
    model = build_model(cfgs.SMOKE, _run()[0])
    tok = torch.from_numpy(_batch()[0][:, :9]).long()
    logits, state = model.prefill(tok)
    assert not logits.requires_grad
    assert not any(t.requires_grad for t in state.values())
    logits, _ = model.serve_step(state, tok[:, :1])
    assert not logits.requires_grad
    assert all(p.requires_grad for p in model.parameters())


# --- the CLI ----------------------------------------------------------------

def test_train_cli_smoke_on_cpu(capsys):
    res = train.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "24"])
    assert "[train] done: loss" in capsys.readouterr().out
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert res.trainer.state["step"] == 2
    assert not _build.LIBRARY.loaded
    assert engine.SCAN_KERNEL.launches == 0
    res = train.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                      "--steps", "1", "--batch", "1", "--seq", "9",
                      "--scan-impl", "engine_unchunked"])
    assert res.trainer.model.cfg.scan_impl == "engine_unchunked"
    assert np.isfinite(res.losses[0])
    with pytest.raises(NotImplementedError, match="5b"):
        train.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                    "--steps", "1", "--seq", "8", "--batch", "1",
                    "--scan-impl", "chunked"])
    assert base.remat(len, False) is len


def test_rwkv6_cli_runs_as_a_module_without_jax():
    """``python -m repro_torch.launch.train --arch rwkv6-1.6b`` on the CPU
    in a fresh interpreter that never loads JAX."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['train', '--arch', 'rwkv6-1.6b', '--smoke',\n"
        "            '--device', 'cpu', '--steps', '2', '--seq', '20',\n"
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
