"""Hymba — hybrid-head architecture: attention and Mamba heads in parallel
within every layer (arXiv:2411.13676), sliding-window attention with a few
global layers (first / middle / last). The training path.

The Mamba branch runs the SSAM plans: the depthwise causal conv1d through
K1's per-lane path (forward, recomputed pre-activation and ``dx``) and K4
(``dW``), the selective scan through K5 (forward, and the time-reversed
λ-recurrence of its backward). Attention and the MLPs are plain torch, as
the reference leaves them to XLA. Layers run in a Python loop over
per-layer parameter trees, each under :func:`repro_torch.models.base.remat`
when ``cfg.remat``.

Simplifications of the reference, kept here: no meta tokens and no
cross-layer KV sharing; the two branch outputs are mean-combined after
learned per-channel rescales. Serving (KV caches, the O(1) Mamba decode
step, ``serve_step``) is not ported yet (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import engine
from ..nn import attention as attn
from ..nn import layers as nnl
from ..nn import ssm
from ..nn.spec import ParamSpec, as_module, init_params, stack_specs, unstack
from .base import ArchConfig, chunked_cross_entropy, remat

SCAN_CHUNK = 128              # selective-scan chunk (mamba_apply's default)


def layer_specs(c: ArchConfig) -> dict:
    return {
        "norm_mix": nnl.rmsnorm_specs(c.d_model),
        "norm_mlp": nnl.rmsnorm_specs(c.d_model),
        "attn": attn.gqa_specs(c.d_model, c.n_heads, c.kv_heads, c.head_dim),
        "mamba": ssm.mamba_specs(c.d_model, d_inner=c.d_inner,
                                 ssm_state=c.ssm_state, conv_k=c.conv_k),
        "beta_attn": ParamSpec((c.d_model,), ("embed",), init="ones"),
        "beta_mamba": ParamSpec((c.d_model,), ("embed",), init="ones"),
        "ffn": nnl.gated_mlp_specs(c.d_model, c.d_ff),
    }


def specs(c: ArchConfig) -> dict:
    """The reference's spec tree of ``c``: layers stacked on a leading
    axis. Allocates nothing (``param_count(specs(c))`` sizes a model)."""
    return {
        "embed": nnl.embedding_specs(c.vocab, c.d_model),
        "layers": stack_specs(layer_specs(c), c.n_layers),
        "norm_f": nnl.rmsnorm_specs(c.d_model),
    }


def train_launches(c: ArchConfig, seq: int, batch: int) -> dict:
    """Kernel launches of one training step (loss and gradients) on the
    card, derived from the code. Per layer, with remat each layer's
    forward runs twice (once, and again in its backward) and the conv's
    backward recomputes its pre-activation: K1 4 (2 forwards, the
    recompute, ``dx``), K4 1 call (``dW``; two launches when its
    reduction is split, :func:`engine.perlane_wgrad_launches`). The
    streamed selective scan runs ⌈seq/128⌉ chunks, each checkpointed
    inside the checkpointed layer, so a chunk's forward runs three times
    (forward, the layer's recompute, the chunk's recompute) and its
    λ-recurrence once: K5 4 per chunk. Without remat: K1 3, K5 3 per
    chunk. ``engine_unchunked``: one forward call and one λ call instead
    of the chunks (K5 3 with remat, 2 without)."""
    per = 2 if c.remat else 1
    if (c.scan_impl or "engine") == "engine":
        k5 = -(-seq // SCAN_CHUNK) * (per + 2)
    else:
        k5 = per + 1
    return {"k1": c.n_layers * (per + 2),
            "k4": c.n_layers * engine.perlane_wgrad_launches(batch, seq,
                                                             c.d_inner),
            "k5": c.n_layers * k5}


class Hymba(nn.Module):
    """The model and its trainable parameters. ``params`` is a tree with a
    list of per-layer trees under ``"layers"`` (as
    :func:`repro_torch.convert.params_from_reference` gives); without it
    the weights are drawn from ``seed`` on ``device`` (default ``cuda``)
    with the reference's initialisers."""

    def __init__(self, cfg: ArchConfig, params=None, *, device=None,
                 seed: int = 0):
        super().__init__()
        if not (cfg.d_inner and cfg.ssm_state):
            raise ValueError(f"{cfg.name}: Hymba needs d_inner and ssm_state")
        self.cfg = cfg
        self.attn_cfg = attn.AttnConfig(
            d_model=cfg.d_model, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, rope_base=cfg.rope_base,
            window=cfg.window, block_q=cfg.block_q, block_kv=cfg.block_kv)
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

    def train_inputs(self, batch: int, seq: int) -> dict:
        """Shapes and dtypes of one training batch."""
        return {"tokens": ((batch, seq), torch.int64),
                "labels": ((batch, seq), torch.int64)}

    def layer(self, p, x, *, positions, is_global: bool):
        """One hybrid layer: attention and Mamba on the same normed input,
        rescaled and mean-combined, then the gated MLP."""
        c = self.cfg
        h = nnl.rmsnorm_apply(p["norm_mix"], x)
        a, _ = attn.gqa_apply(p["attn"], h, self.attn_cfg,
                              positions=positions, is_global=is_global)
        m, _ = ssm.mamba_apply(p["mamba"], h, ssm_state=c.ssm_state,
                               conv_k=c.conv_k, chunk=SCAN_CHUNK,
                               work_dtype=getattr(torch, c.scan_dtype),
                               scan_impl=c.scan_impl)
        mix = 0.5 * (a * p["beta_attn"].to(x.dtype)
                     + m * p["beta_mamba"].to(x.dtype))
        x = x + mix
        h = nnl.rmsnorm_apply(p["norm_mlp"], x)
        return x + nnl.gated_mlp_apply(p["ffn"], h, act="silu")

    def forward(self, tokens: torch.Tensor, params=None) -> torch.Tensor:
        """Final normed hidden states ``(B, S, d)`` of ``(B, S)`` tokens."""
        params = self.params if params is None else params
        c = self.cfg
        x = nnl.embedding_apply(params["embed"], tokens).to(c.param_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        layer = remat(self.layer, c.remat)
        for p_i, g_i in zip(params["layers"], c.is_global_layers()):
            x = layer(p_i, x, positions=positions, is_global=g_i)
        return nnl.rmsnorm_apply(params["norm_f"], x)

    def loss(self, batch: dict, params=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch`` (``tokens``,
        ``labels``)."""
        params = self.params if params is None else params
        x = self.forward(batch["tokens"], params)
        return chunked_cross_entropy(x, params["embed"]["table"],
                                     batch["labels"],
                                     chunk=self.cfg.loss_chunk)
