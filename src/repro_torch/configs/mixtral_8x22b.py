"""Mixtral-8x22B — MoE 8 experts top-2, SWA per assignment [arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) expert d_ff=16384 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    mlp_kind="swiglu",
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
))
