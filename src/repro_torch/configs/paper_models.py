"""The paper's own evaluation models (codec/layout experiments replicate on
reduced variants of these): LWM-7B [hf:LargeWorldModel/LWM-Text-Chat-1M],
Yi-34B [hf:01-ai/Yi-34B], Llama3-70B [hf:meta-llama/Llama-3.3-70B-Instruct].
"""
from repro_torch.configs.base import ModelConfig, register

LWM_7B = register(ModelConfig(
    name="lwm-7b",
    arch_type="dense",
    source="hf:LargeWorldModel/LWM-Text-Chat-1M",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,  # llama-2-7b base: MHA
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    mlp_kind="swiglu",
))

YI_34B = register(ModelConfig(
    name="yi-34b",
    arch_type="dense",
    source="hf:01-ai/Yi-34B",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    mlp_kind="swiglu",
))

LLAMA3_70B = register(ModelConfig(
    name="llama3-70b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.3-70B-Instruct",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    mlp_kind="swiglu",
))
