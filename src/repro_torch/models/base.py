"""Model base of the port: :class:`ArchConfig`, the fields of the
reference's config (the same names and defaults), with torch dtypes.

Attention, MoE, MLA, hybrid and audio fields are carried so configs
compare field for field with the reference; only the families that
``repro_torch.models.build_model`` builds use them.
"""
from __future__ import annotations

import dataclasses

import torch


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
