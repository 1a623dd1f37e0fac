"""Mamba2-2.7B — attention-free SSM with SSD [arXiv:2405.21060].

64L d_model=2560, expand=2 (d_inner=5120), head_dim=64 (80 SSM heads),
state=128, vocab=50280. Sub-quadratic: decode holds O(heads*headdim*state)
per layer, so long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    layer_pattern=("ssm",),
))
