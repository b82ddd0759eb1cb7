"""rwkv6-1.6b — RWKV-6 "Finch": attention-free, data-dependent decay.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536; 32 heads of
64 (K=V=64) per the RWKV-6 head convention (d_model/64).
"""
import dataclasses

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536,
    head_k=64, head_v=64, wkv_chunk=64,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
    d_ff=224, vocab=512, head_k=16, head_v=16, wkv_chunk=16,
)
