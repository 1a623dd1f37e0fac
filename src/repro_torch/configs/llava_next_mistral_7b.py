"""LLaVA-NeXT (v1.6) Mistral-7B backbone — VLM
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Language backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
AnyRes tiling: the vision tower + projector are stubbed per assignment;
``input_specs`` provides up to 2880 (5x576) patch embeddings prepended to
the text tokens.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    mlp_kind="swiglu",
    frontend="vision",
    num_patch_tokens=2880,  # anyres: base 576 + 4 tiles x 576
))
