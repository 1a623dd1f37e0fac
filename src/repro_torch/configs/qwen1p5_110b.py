"""Qwen1.5-110B — dense GQA with QKV bias [hf:Qwen/Qwen1.5-0.5B family].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    mlp_kind="swiglu",
    qkv_bias=True,
))
