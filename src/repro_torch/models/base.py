"""Model base of the port: :class:`ArchConfig`, the fields of the
reference's config (the same names and defaults), with torch dtypes,
:func:`remat` and the chunked language-model loss.

Attention, MoE, MLA, hybrid and audio fields are carried so configs
compare field for field with the reference; only the families that
``repro_torch.models.build_model`` builds use them. ``remat`` trades
memory for recomputation: a model that honours it (Hymba) runs each
layer under :func:`remat`, which changes no value.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention
    rope_base: float = 1e4
    rot_frac: float = 1.0        # partial rotary (stablelm 0.25, chatglm 0.5)
    attn_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"        # rmsnorm | layernorm | rmsnorm_p1 (gemma)
    mlp: str = "gated_silu"      # gated_silu | gated_gelu | mlp_gelu
    sandwich_norm: bool = False  # gemma3 post-norms
    # local:global attention pattern
    window: int = 0              # 0 ⇒ all-global
    global_every: int = 0        # every Nth layer is global (gemma3: 6)
    global_layers: tuple[int, ...] = ()   # explicit global layers (hymba)
    rope_base_global: float | None = None
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # ssm / rwkv / hybrid
    ssm_state: int = 0
    d_inner: int = 0
    conv_k: int = 4
    head_k: int = 0
    head_v: int = 0
    wkv_chunk: int = 64
    # modality stubs
    n_prefix: int = 0            # VLM patches / enc-dec handled separately
    encoder_layers: int = 0      # whisper
    n_frames: int = 0            # whisper encoder frames (stub embeds)
    conv_frontend: bool = False  # whisper: real mel conv stem through the
    n_mels: int = 0              #   SSAM engine (2×conv k=3, stride 1/2)
    conv_strategy: str | None = None  # frontend lowering: None (auto) |
    #   "lanes" (VPU shift-fma) | "mxu" (im2row matmul, DESIGN.md §13)
    pos_emb: str = "rope"        # rope | learned
    # numerics / runtime
    tie_embeddings: bool = True
    emb_scale: bool = False      # gemma ×√d
    dtype: str = "float32"
    remat: bool = True
    block_q: int = 512
    block_kv: int = 1024
    # decode-cache options of the reference's transformer
    constrain_cache: bool = True    # re-pin decode-cache sharding in-scan
    decode_write_outside: bool = True   # one stacked cache write/step
    scan_dtype: str = "float32"     # recurrence-chunk intermediate dtype
    # recurrence schedule: None → 'engine' (chunk-streamed); or
    # 'engine_unchunked' (one engine call over all of T)
    scan_impl: str | None = None
    loss_chunk: int = 512
    aux_loss_weight: float = 0.01

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def scan_schedule(self) -> str:
        """The recurrence schedule: ``scan_impl``, or 'engine' when None."""
        return self.scan_impl or "engine"

    def is_global_layers(self) -> tuple[bool, ...]:
        """Per layer, whether it attends globally (no sliding window): all
        layers when ``window == 0``, else every ``global_every``-th and the
        ``global_layers``."""
        if self.window == 0:
            return (True,) * self.n_layers
        return tuple(
            bool(self.global_every and i % self.global_every
                 == self.global_every - 1) or i in self.global_layers
            for i in range(self.n_layers))


def remat(fn, enabled: bool):
    """``fn`` with its activations recomputed in the backward pass when
    ``enabled``: ``torch.utils.checkpoint`` (non-reentrant) of each call
    under autograd. The reference checkpoints each layer too (saving the
    matmul outputs, a memory/time choice); here a layer keeps only its
    inputs."""
    if not enabled:
        return fn

    def run(*args, **kw):
        if not torch.is_grad_enabled():
            return fn(*args, **kw)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def chunked_cross_entropy(x: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor, *,
                          chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross entropy without materialising ``(B, S, V)``
    logits at once: sequence chunks of ``chunk`` positions, each read out
    through the tied ``(V, d)`` embedding ``table`` in fp32. Labels < 0
    are excluded."""
    B, S, d = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for c in range(0, S + pad, chunk):
        xx, ll = x[:, c:c + chunk], labels[:, c:c + chunk]
        logits = (xx @ table.T.to(xx.dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, ll.clamp_min(0)[..., None])[..., 0]
        valid = (ll >= 0).float()
        tot = tot + ((lse - tgt) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp_min(cnt, 1.0)
