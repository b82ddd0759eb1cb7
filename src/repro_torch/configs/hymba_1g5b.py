"""hymba-1.5b — hybrid-head: parallel attention + Mamba heads per layer.

[arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base] 32L d_model=1600 25H
(kv=5, head_dim=64) d_ff=5504 ssm_state=16 vocab=32001. Sliding window
1024 with global layers {first, middle, last} per the paper.
"""
import dataclasses

from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    window=1024, global_layers=(0, 15, 31),
    ssm_state=16, d_inner=3200, conv_k=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
    d_ff=160, vocab=512, window=8, global_layers=(0,), d_inner=128,
    ssm_state=8,
)
