"""Nemotron-4-340B — dense GQA with squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8, head_dim=192) d_ff=73728 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    source="arXiv:2402.16819",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    mlp_kind="squared_relu",
))
