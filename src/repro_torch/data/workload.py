"""Workload generation: shared-prefix corpora for the live engine."""
from __future__ import annotations

import numpy as np


def shared_prefix_tokens(rng: np.random.Generator, vocab: int,
                         prefix_len: int, n_requests: int,
                         suffix_len: int) -> tuple:
    """(prefix, [full_prompt_i]) token arrays for the live engine."""
    prefix = rng.integers(0, vocab, prefix_len)
    prompts = [np.concatenate([prefix,
                               rng.integers(0, vocab, suffix_len)])
               for _ in range(n_requests)]
    return prefix, prompts
