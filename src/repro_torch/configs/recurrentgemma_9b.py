"""RecurrentGemma-9B — Griffin hybrid: RG-LRU + local attention 1:2
[arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1, head_dim=256) d_ff=12288 vocab=256000.
Pattern: (rglru, rglru, attn) cycled; local attention window 2048.
Sub-quadratic -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp_kind="swiglu",
    layer_pattern=("rglru", "rglru", "attn"),
    local_window=2048,
    rglru_width=4096,
))
