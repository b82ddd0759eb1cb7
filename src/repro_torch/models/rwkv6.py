"""RWKV6 "Finch" — attention-free LM with data-dependent decay.

The WKV recurrence is the SSAM linear-recurrence plan: per-(head, k, v)
channel ``S_t = d_t·S_{t−1} + k_tᵀv_t``, run by
:func:`repro_torch.nn.ssm.wkv6_chunked` through the scan engine (K5 on
the card) when a whole prompt is prefilled or a batch is trained: the
streamed chunks run forward through K5 and, in the backward, their
time-reversed λ-recurrence through K5 too. Training runs each layer
under :func:`repro_torch.models.base.remat` when ``cfg.remat``, and the
loss is the chunked cross entropy through the tied embedding. Decoding
steps the O(1) state one token at a time in plain torch, without
autograd. Layers run in a Python loop; the decode state stacks
layer-first ``(L, B, …)`` as in the reference, so states compare
directly across the two packages.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import layers as nnl
from ..nn import ssm
from ..nn.spec import (ParamSpec, as_module, init_params, stack_specs,
                       unstack)
from .base import ArchConfig, chunked_cross_entropy, remat


def layer_specs(c: ArchConfig) -> dict:
    return {
        "norm_tm": nnl.rmsnorm_specs(c.d_model),
        "norm_cm": nnl.rmsnorm_specs(c.d_model),
        "tm": ssm.rwkv6_timemix_specs(
            c.d_model, n_heads=c.n_heads, head_k=c.head_k, head_v=c.head_v),
        "cm": ssm.rwkv6_channelmix_specs(c.d_model, c.d_ff),
    }


def specs(c: ArchConfig) -> dict:
    """The reference's spec tree of ``c``: layers stacked on a leading
    axis. Allocates nothing (``param_count(specs(c))`` sizes a model)."""
    return {
        "embed": nnl.embedding_specs(c.vocab, c.d_model),
        "norm_in": nnl.rmsnorm_specs(c.d_model),
        "layers": stack_specs(layer_specs(c), c.n_layers),
        "norm_f": nnl.rmsnorm_specs(c.d_model),
    }


def train_launches(c: ArchConfig, seq: int, batch: int) -> dict:
    """Kernel launches of one training step (loss and gradients) on the
    card, derived from the code: only K5 runs. The streamed WKV runs
    ⌈seq/L⌉ chunks (``L = min(wkv_chunk, seq)``), each checkpointed
    inside the checkpointed layer, so with remat a chunk's forward runs
    three times (forward, the layer's recompute, the chunk's recompute)
    and its λ-recurrence once: 4 per chunk; without remat 3.
    ``engine_unchunked``: one forward call and one λ call instead of the
    chunks (3 with remat, 2 without). ``batch`` does not change the
    count (a call's rows are B·H·K·V)."""
    del batch
    per = 2 if c.remat else 1
    if c.scan_schedule == "engine":
        k5 = -(-seq // min(c.wkv_chunk, seq)) * (per + 2)
    else:
        k5 = per + 1
    return {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": c.n_layers * k5}


class RWKV6(nn.Module):
    """The model and its trainable parameters. ``params`` is a tree with a
    list of per-layer trees under ``"layers"`` (as
    :func:`repro_torch.convert.params_from_reference` gives); without it
    the weights are drawn from ``seed`` on ``device`` (default ``cuda``).
    Serving (:meth:`prefill`, :meth:`prefill_logits`, :meth:`serve_step`)
    runs without autograd."""

    def __init__(self, cfg: ArchConfig, params=None, *, device=None,
                 seed: int = 0):
        super().__init__()
        if not (cfg.head_k and cfg.head_v and cfg.n_heads):
            raise ValueError(f"{cfg.name}: RWKV6 needs n_heads, head_k and "
                             "head_v")
        self.cfg = cfg
        if params is None:
            device = torch.device("cuda" if device is None else device)
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            params = init_params(self.specs(), gen, device)
            params["layers"] = unstack(params["layers"], cfg.n_layers)
        self.params = as_module(params, requires_grad=True)

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    def specs(self) -> dict:
        return specs(self.cfg)

    def _layer(self, p, x, *, state=None):
        c = self.cfg
        tm_state = None if state is None else {"S": state["S"],
                                               "prev": state["prev_tm"]}
        cm_state = None if state is None else {"prev": state["prev_cm"]}
        h, tm_new = ssm.rwkv6_timemix_apply(
            p["tm"], nnl.rmsnorm_apply(p["norm_tm"], x),
            n_heads=c.n_heads, head_k=c.head_k, head_v=c.head_v,
            chunk=c.wkv_chunk, state=tm_state, wkv_impl=c.scan_schedule)
        x = x + h
        h, cm_new = ssm.rwkv6_channelmix_apply(
            p["cm"], nnl.rmsnorm_apply(p["norm_cm"], x), state=cm_state)
        x = x + h
        return x, {"S": tm_new["S"], "prev_tm": tm_new["prev"],
                   "prev_cm": cm_new["prev"]}

    def train_inputs(self, batch: int, seq: int) -> dict:
        """Shapes and dtypes of one training batch."""
        return {"tokens": ((batch, seq), torch.int64),
                "labels": ((batch, seq), torch.int64)}

    def _embed(self, tokens, params=None):
        P = self.params if params is None else params
        x = nnl.embedding_apply(P["embed"], tokens).to(self.cfg.param_dtype)
        return nnl.rmsnorm_apply(P["norm_in"], x)

    def _logits(self, x):
        """Tied readout of the last position, fp32 ``(B, vocab)``."""
        table = self.params["embed"]["table"]
        return (x[:, -1] @ table.T.to(x.dtype)).float()

    def _run(self, tokens, state=None, params=None):
        """Final normed hidden states and the per-layer final states
        stacked layer-first, each layer under :func:`remat` when
        ``cfg.remat`` (the reference's ``remat(body, c.remat)``; a no-op
        without autograd, as in serving)."""
        P = self.params if params is None else params
        x = self._embed(tokens, P)
        layer = remat(self._layer, self.cfg.remat)
        new = []
        for i, p_i in enumerate(P["layers"]):
            st_i = None if state is None else {k: v[i]
                                               for k, v in state.items()}
            x, st = layer(p_i, x, state=st_i)
            new.append(st)
        x = nnl.rmsnorm_apply(P["norm_f"], x)
        stacked = {k: torch.stack([s[k] for s in new]) for k in new[0]}
        return x, stacked

    def forward(self, tokens: torch.Tensor, params=None) -> torch.Tensor:
        """Final normed hidden states ``(B, T, d)`` of ``(B, T)`` tokens."""
        return self._run(tokens, params=params)[0]

    def loss(self, batch: dict, params=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch`` (``tokens``,
        ``labels``) through the tied embedding, in chunks of
        ``cfg.loss_chunk`` positions."""
        params = self.params if params is None else params
        x = self.forward(batch["tokens"], params)
        return chunked_cross_entropy(x, params["embed"]["table"],
                                     batch["labels"],
                                     chunk=self.cfg.loss_chunk)

    @torch.no_grad()
    def prefill_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._logits(self._run(tokens)[0])

    # ---- decode: O(1) recurrent state -------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """Whole-prompt prefill of fresh (zero-state) streams.

        ``tokens`` is ``(B, L)``. Each layer's WKV runs once over the
        prompt through :func:`repro_torch.nn.ssm.wkv6_chunked` (one K5
        launch per chunk of ``wkv_chunk`` tokens on the card) instead of
        L ``serve_step`` calls. Returns ``(last-token logits, decode
        state)``, the state stacked layer-first like
        :meth:`decode_state_specs`.
        """
        x, state = self._run(tokens)
        return self._logits(x), state

    def decode_state_specs(self, batch: int, cache_len: int) -> dict:
        """cache_len is irrelevant — state is O(1)."""
        c = self.cfg
        return {
            "S": ParamSpec((c.n_layers, batch, c.n_heads, c.head_k, c.head_v),
                           ("layers", "batch", "heads", "head_dim", None),
                           init="zeros"),
            "prev_tm": ParamSpec((c.n_layers, batch, 1, c.d_model),
                                 ("layers", "batch", None, "embed"),
                                 init="zeros", dtype=c.param_dtype),
            "prev_cm": ParamSpec((c.n_layers, batch, 1, c.d_model),
                                 ("layers", "batch", None, "embed"),
                                 init="zeros", dtype=c.param_dtype),
        }

    @torch.no_grad()
    def serve_step(self, state: dict, tokens: torch.Tensor, index=None):
        """One decode step of ``(B, 1)`` tokens from ``state``: ``(logits,
        new state)``. Position-free: ``index`` is unused."""
        x, new_state = self._run(tokens, state)
        return self._logits(x), new_state
