"""whisper-base — encoder-decoder audio backbone.

[arXiv:2212.04356] 6L enc + 6L dec, d_model=512 8H (MHA) d_ff=2048
vocab=51865; 1500 encoder frames. ``CONFIG`` takes precomputed frame
embeddings; ``--conv-frontend`` (``n_mels=80``) trains the real mel
stem, whose convolutions run through K1 and K3 (K2 and K3 under
``conv_strategy="mxu"``).
"""
import dataclasses

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865,
    encoder_layers=6, n_frames=1500, pos_emb="learned",
    norm="layernorm", mlp="mlp_gelu", attn_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
    d_ff=160, vocab=512, encoder_layers=2, n_frames=16,
)

# The real mel stem at smoke size (whisper-base uses n_mels=80).
SMOKE_CONV = dataclasses.replace(SMOKE, conv_frontend=True, n_mels=8)

# The same stem pinned to the tensor-core lowering: its convolutions run
# the im2row contraction (K2 on the card) forward and for dx, K3 for dW.
SMOKE_CONV_MXU = dataclasses.replace(SMOKE_CONV, conv_strategy="mxu")
