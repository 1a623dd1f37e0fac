"""Training loop: config in, loss curve out (counterpart of
``repro/training/loop.py``).  CPU-smoke friendly with ``device="cpu"``."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.steps import init_state, make_train_step


def train(cfg: ModelConfig, *, steps: int = 20, batch_size: int = 4,
          seq_len: int = 64, lr: float = 3e-4, accum_steps: int = 1,
          seed: int = 0, ckpt_path: Optional[str] = None,
          log_every: int = 5, device: DeviceLike = None
          ) -> List[Dict[str, float]]:
    device = resolve_device(device)
    optimizer = AdamW(lr=cosine_schedule(lr, warmup=max(steps // 10, 1),
                                         total=steps))
    state = init_state(cfg, optimizer,
                       torch.Generator(device=device).manual_seed(seed),
                       device)
    step_fn = make_train_step(cfg, optimizer, accum_steps=accum_steps)
    data = batches(cfg, DataConfig(batch_size=batch_size, seq_len=seq_len,
                                   seed=seed))
    history: List[Dict[str, float]] = []
    # training progress logging is operator-facing wall time, not
    # replayed state — the loss curve itself is seed-deterministic
    t0 = time.time()  # repro-lint: allow(no-wall-clock)
    for i in range(steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        state, metrics = step_fn(state, batch)
        rec = {k: float(v) for k, v in metrics.items()}
        rec["step"] = i
        history.append(rec)
        if log_every and i % log_every == 0:
            print(f"step {i:4d} loss {rec['loss']:.4f} "
                  f"gnorm {rec['grad_norm']:.3f} "
                  # repro-lint: allow(no-wall-clock) -- progress print
                  f"({time.time() - t0:.1f}s)")
    if ckpt_path:
        checkpoint.save(ckpt_path, state.params)
    return history
