"""H2O-Danube-3-4B — llama+mistral mix with SWA [arXiv:2401.16818].

24L d_model=3840 32H (GQA kv=8, head_dim=120) d_ff=10240 vocab=32000.
Sliding-window attention enables the long_500k decode shape (the decode KV
working set is window-sized).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    mlp_kind="swiglu",
))
