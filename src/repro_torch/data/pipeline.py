"""Synthetic data pipeline: deterministic, seedable batch streams for every
architecture family (decoder LM, VLM, audio encoder) with next-token
labels, plus markovian token streams so KV caches exhibit the
token-adjacent structure the codec exploits."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0


def _zipf_tokens(rng, vocab: int, shape) -> np.ndarray:
    """Zipf-ish marginal with markov repetition (natural-text-like)."""
    base = rng.zipf(1.3, size=shape)
    toks = np.minimum(base - 1, vocab - 1).astype(np.int32)
    rep = rng.random(shape) < 0.2
    out = toks.copy()
    out[..., 1:] = np.where(rep[..., 1:], out[..., :-1], toks[..., 1:])
    return out


def batches(cfg: ModelConfig, dcfg: DataConfig
            ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(dcfg.seed)
    b, s = dcfg.batch_size, dcfg.seq_len
    while True:
        if cfg.is_encoder:  # audio: frame embeddings + unit labels + mask
            yield {
                "frame_embeds": rng.standard_normal(
                    (b, s, cfg.d_model)).astype(np.float32) * 0.02,
                "labels": rng.integers(0, cfg.vocab_size,
                                       (b, s)).astype(np.int32),
                "mask": (rng.random((b, s)) < 0.2),
            }
        elif cfg.frontend == "vision":
            n_text = max(s - cfg.num_patch_tokens, 8)
            toks = _zipf_tokens(rng, cfg.vocab_size, (b, n_text))
            yield {
                "tokens": toks,
                "labels": toks,
                "patch_embeds": rng.standard_normal(
                    (b, cfg.num_patch_tokens, cfg.d_model)
                ).astype(np.float32) * 0.02,
            }
        else:
            toks = _zipf_tokens(rng, cfg.vocab_size, (b, s))
            yield {"tokens": toks, "labels": toks}
