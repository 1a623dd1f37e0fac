"""AdamW with decoupled weight decay and LR schedules, over the port's
parameter trees (counterpart of ``repro/training/optimizer.py``, in its
arithmetic: clipping by the global norm, bias corrections and the
learning rate as fp32 tensors of the int32 step count, the decay added
to the update in fp32).

``update`` works in place, one leaf at a time under ``torch.no_grad()``:
at mamba2-2.7b's width the parameters, their gradients and the two
moments are 42 GiB in fp32, and a second copy of any of them would not
fit one card beside the activations."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32, 0-dim
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        first = leaves(params)[0]
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=first.device),
            tree_map(zeros, params), tree_map(zeros, params))

    def update(self, grads, state: AdamWState, params):
        """One step: ``params``, ``state.m``, ``state.v`` and
        ``state.count`` are updated in place and returned as
        ``(params, state)``."""
        with torch.no_grad():
            g_leaves = leaves(grads)
            scale = None
            if self.grad_clip:
                gnorm = global_norm(g_leaves)
                scale = torch.clamp_max(
                    self.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            state.count.add_(1)
            c = state.count.to(torch.float32)
            b1c = 1 - self.b1 ** c
            b2c = 1 - self.b2 ** c
            lr = self.lr(state.count)
            for p, g, m, v in zip(leaves(params), g_leaves,
                                  leaves(state.m), leaves(state.v)):
                g = g.to(torch.float32)
                if scale is not None:
                    g = g * scale
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g * g)
                du = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
                du = du + self.weight_decay * p.to(torch.float32)
                p.copy_((p.to(torch.float32) - lr * du).to(p.dtype))
        return params, state


def global_norm(tree) -> torch.Tensor:
    """The fp32 norm of all leaves together."""
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2)
                          for x in leaves(tree)))


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    def lr(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        warm = peak * c / max(warmup, 1)
        frac = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(c < warmup, warm, cos)
    return lr


def constant_schedule(value: float):
    return lambda count: torch.tensor(value, dtype=torch.float32,
                                      device=count.device)
