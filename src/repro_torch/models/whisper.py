"""Whisper-style encoder-decoder backbone, the training path.

The mel stem (``conv_frontend=True``) is the real Whisper stem: two k=3
'same' convolutions with a bias+GELU epilogue, the second at stride 2,
each an NCHW minibatch ``(B, C, 1, T)`` through the engine's reduce-axes
plan (on the card K1, or K2 under ``conv_strategy="mxu"``; time on the
lane axis, the mel→d_model channel mix the plan's C_in reduction). Their
backward runs the input-adjoint plan through the same kernel and the
weight gradient through K3. Without the stem, ``frames`` are
precomputed frame embeddings.

Encoder: bidirectional self-attention; decoder: causal self-attention and
cross-attention to the encoder output. LayerNorm, biases, GELU MLP and
learned positions, as in the reference. Layers run in a Python loop over
per-layer parameter trees. Serving (``serve_step``,
``prime_cross_cache``) is not ported yet (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import attention as attn
from ..nn import layers as nnl
from ..nn.spec import ParamSpec, as_module, init_params, stack_specs, unstack
from .base import ArchConfig, chunked_cross_entropy

ENC_QPOS = 2 ** 30        # non-causal queries: every key position is visible


def enc_layer_specs(c: ArchConfig) -> dict:
    xattn = attn.gqa_specs(c.d_model, c.n_heads, c.kv_heads, c.head_dim,
                           bias=True)
    return {
        "norm_attn": nnl.layernorm_specs(c.d_model),
        "attn": xattn,
        "norm_mlp": nnl.layernorm_specs(c.d_model),
        "ffn": nnl.mlp_specs(c.d_model, c.d_ff, bias=True),
    }


def dec_layer_specs(c: ArchConfig) -> dict:
    s = enc_layer_specs(c)
    s["norm_xattn"] = nnl.layernorm_specs(c.d_model)
    s["xattn"] = attn.gqa_specs(c.d_model, c.n_heads, c.kv_heads, c.head_dim,
                                bias=True)
    return s


def specs(c: ArchConfig) -> dict:
    """The reference's spec tree: layers stacked on a leading axis.
    Allocates nothing (``param_count(specs(c))`` sizes a model)."""
    s = {
        "enc_pos": {"table": ParamSpec((c.n_frames, c.d_model),
                                       (None, "embed"), init="small")},
        "enc_layers": stack_specs(enc_layer_specs(c), c.encoder_layers),
        "enc_norm": nnl.layernorm_specs(c.d_model),
        "embed": nnl.embedding_specs(c.vocab, c.d_model),
        "dec_pos": {"table": ParamSpec((32768, c.d_model), (None, "embed"),
                                       init="small")},
        "dec_layers": stack_specs(dec_layer_specs(c), c.n_layers),
        "dec_norm": nnl.layernorm_specs(c.d_model),
    }
    if c.conv_frontend:
        s["frontend"] = {
            "conv1": nnl.conv2d_specs(c.n_mels, c.d_model, (1, 3)),
            "conv2": nnl.conv2d_specs(c.d_model, c.d_model, (1, 3)),
        }
    return s


class Whisper(nn.Module):
    """The model and its trainable parameters. ``params`` is a tree with
    lists of per-layer trees under ``"enc_layers"`` and ``"dec_layers"``
    (as :func:`repro_torch.convert.params_from_reference` gives); without
    it the weights are drawn from ``seed`` on ``device`` (default
    ``cuda``) with the reference's initialisers."""

    def __init__(self, cfg: ArchConfig, params=None, *, device=None,
                 seed: int = 0):
        super().__init__()
        if cfg.conv_frontend and not cfg.n_mels:
            raise ValueError(f"{cfg.name}: the conv stem needs n_mels")
        self.cfg = cfg
        if params is None:
            device = torch.device("cuda" if device is None else device)
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            params = init_params(self.specs(), gen, device)
            params["enc_layers"] = unstack(params["enc_layers"],
                                           cfg.encoder_layers)
            params["dec_layers"] = unstack(params["dec_layers"], cfg.n_layers)
        self.params = as_module(params, requires_grad=True)

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    def specs(self) -> dict:
        return specs(self.cfg)

    def train_inputs(self, batch: int, seq: int) -> dict:
        """Shapes and dtypes of one training batch."""
        c = self.cfg
        first = ("mel", (batch, c.n_mels, 2 * c.n_frames)) \
            if c.conv_frontend else ("frames", (batch, c.n_frames, c.d_model))
        return {first[0]: (first[1], c.param_dtype),
                "tokens": ((batch, seq), torch.int64),
                "labels": ((batch, seq), torch.int64)}

    # ---- conv stem (K1, or K2 for mxu: forward and dx; K3 dW) --------------
    def frontend(self, p, mel: torch.Tensor) -> torch.Tensor:
        """``mel (B, n_mels, T)`` → frames ``(B, T//2, d_model)``."""
        c = self.cfg
        x = mel[:, :, None, :]
        x = nnl.conv2d_apply(p["conv1"], x, activation="gelu",
                             strategy=c.conv_strategy)
        x = nnl.conv2d_apply(p["conv2"], x, stride=(1, 2), activation="gelu",
                             strategy=c.conv_strategy)
        return x[:, :, 0, :].transpose(1, 2).to(c.param_dtype)

    # ---- attention -------------------------------------------------------
    def _attend(self, p, x, kv, q_pos, kv_pos):
        c = self.cfg

        def proj(src, w, b):
            return torch.einsum("bsd,dhk->bshk", src, p[w].to(x.dtype)) \
                + p[b].to(x.dtype)

        q = proj(x, "wq", "bq")
        k, v = proj(kv, "wk", "bk"), proj(kv, "wv", "bv")
        if x.shape[1] > 1024:
            out = attn.mha_chunked(q, k, v, q_pos, kv_pos, block_q=c.block_q,
                                   block_kv=c.block_kv)
        else:
            out = attn.mha_direct(q, k, v, q_pos, kv_pos)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)) \
            + p["bo"].to(x.dtype)

    def _self_attn(self, p, x, *, causal: bool):
        pos = torch.arange(x.shape[1], device=x.device)
        q_pos = pos if causal else torch.full_like(pos, ENC_QPOS)
        return self._attend(p, x, x, q_pos, pos)

    def _cross_attn(self, p, x, enc):
        q_pos = torch.full((x.shape[1],), ENC_QPOS, device=x.device)
        kv_pos = torch.arange(enc.shape[1], device=x.device)
        return self._attend(p, x, enc, q_pos, kv_pos)

    # ---- forward ---------------------------------------------------------
    def encode(self, frames: torch.Tensor, params=None) -> torch.Tensor:
        params = self.params if params is None else params
        c = self.cfg
        x = frames.to(c.param_dtype) + params["enc_pos"]["table"].to(
            c.param_dtype)
        for p in params["enc_layers"]:
            h = nnl.layernorm_apply(p["norm_attn"], x)
            x = x + self._self_attn(p["attn"], h, causal=False)
            h = nnl.layernorm_apply(p["norm_mlp"], x)
            x = x + nnl.mlp_apply(p["ffn"], h, act="gelu")
        return nnl.layernorm_apply(params["enc_norm"], x)

    def decode_train(self, enc: torch.Tensor, tokens: torch.Tensor,
                     params=None) -> torch.Tensor:
        params = self.params if params is None else params
        c = self.cfg
        S = tokens.shape[1]
        x = nnl.embedding_apply(params["embed"], tokens).to(c.param_dtype)
        x = x + params["dec_pos"]["table"][:S].to(c.param_dtype)
        for p in params["dec_layers"]:
            h = nnl.layernorm_apply(p["norm_attn"], x)
            x = x + self._self_attn(p["attn"], h, causal=True)
            h = nnl.layernorm_apply(p["norm_xattn"], x)
            x = x + self._cross_attn(p["xattn"], h, enc)
            h = nnl.layernorm_apply(p["norm_mlp"], x)
            x = x + nnl.mlp_apply(p["ffn"], h, act="gelu")
        return nnl.layernorm_apply(params["dec_norm"], x)

    def frames(self, batch: dict, params=None) -> torch.Tensor:
        """Encoder input: the conv stem on ``batch['mel']``, or the stub
        embeddings ``batch['frames']``."""
        params = self.params if params is None else params
        if self.cfg.conv_frontend:
            return self.frontend(params["frontend"], batch["mel"])
        return batch["frames"]

    def loss(self, batch: dict, params=None) -> torch.Tensor:
        """Mean next-token cross entropy of ``batch`` (``mel`` or
        ``frames``, ``tokens``, ``labels``)."""
        params = self.params if params is None else params
        enc = self.encode(self.frames(batch, params), params)
        x = self.decode_train(enc, batch["tokens"], params)
        return chunked_cross_entropy(x, params["embed"]["table"],
                                     batch["labels"],
                                     chunk=self.cfg.loss_chunk)
