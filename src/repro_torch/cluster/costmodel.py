"""Analytic engine cost model for the discrete-event simulator.

Prefill is compute-bound (2*N_active*T matmul flops + attention term at an
assumed MFU); decode is memory-bound (params + KV traffic over HBM). GPU
specs cover the paper's three platforms; ``tpu-v5e`` is the target
deployment of this repo's adaptation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float  # bf16
    hbm_bw: float  # bytes/s
    hbm_bytes: float


CHIPS: Dict[str, ChipSpec] = {
    "h20": ChipSpec("h20", 148e12, 4.0e12, 96e9),
    "a100": ChipSpec("a100", 312e12, 2.0e12, 80e9),
    "l20": ChipSpec("l20", 119e12, 864e9, 48e9),
    "tpu-v5e": ChipSpec("tpu-v5e", 197e12, 819e9, 16e9),
}


@dataclasses.dataclass
class EngineCostModel:
    cfg: ModelConfig
    chip: ChipSpec
    n_chips: int = 2
    mfu: float = 0.45
    hbm_eff: float = 0.75

    def _flops_prefill(self, n_tokens: int, ctx: int) -> float:
        dense = 2.0 * self.cfg.param_count(active_only=True) * n_tokens
        n_attn = sum(1 for k in self.cfg.layer_kinds() if k == "attn")
        attn = (2.0 * 2.0 * n_tokens * (ctx + n_tokens) / 2 * n_attn
                * self.cfg.num_heads * self.cfg.head_dim)
        return dense + attn

    def prefill_time(self, n_tokens: int, ctx: int = 0) -> float:
        return self._flops_prefill(n_tokens, ctx) / (
            self.n_chips * self.chip.peak_flops * self.mfu)

    def decode_step_time(self, batch: int, mean_context: float) -> float:
        pbytes = 2.0 * self.cfg.param_count(active_only=True)
        kv = self.cfg.kv_bytes_per_token() * mean_context * batch
        return (pbytes + kv) / (self.n_chips * self.chip.hbm_bw *
                                self.hbm_eff)

    def layer_comp_times(self, n_tokens: int) -> list:
        """Per-layer prefill compute time (for Appx A.3 admission)."""
        t = self.prefill_time(n_tokens)
        L = self.cfg.num_layers
        return [t / L] * L
