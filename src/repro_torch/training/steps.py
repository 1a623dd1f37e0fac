"""Train step over the model zoo (all architectures): counterpart of
``repro/training/steps.py``.

``make_train_step`` builds a (state, batch) -> (state, metrics) function
with per-layer activation checkpointing (``remat``), optional gradient
accumulation over contiguous row blocks of the batch, the MoE aux loss,
and the per-arch loss heads (causal LM / VLM text-only / HuBERT masked
units).  The state is updated in place (``AdamW.update``) and returned.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import cross_entropy
from repro_torch.params import init_params
from repro_torch.sharding.rules import local_region
from repro_torch.training.optimizer import AdamW, AdamWState, global_norm
from repro_torch.tree import leaves, unflatten


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    step: torch.Tensor  # int32, 0-dim


def init_state(cfg: ModelConfig, optimizer: AdamW,
               generator: torch.Generator, device: DeviceLike = None,
               dtype: torch.dtype = torch.float32) -> TrainState:
    """Seeded weights (``params.init_params``; ``generator`` lives on
    ``device``) and zero moments."""
    device = resolve_device(device)
    params = init_params(cfg, generator, device=device, dtype=dtype)
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=device))


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            aux_coef: float = 0.01, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    tokens = batch.get("tokens")
    embeds = batch.get("patch_embeds", batch.get("frame_embeds"))
    mask_positions = batch.get("mask")
    logits, moe_aux = tf.forward_full(params, cfg, tokens=tokens,
                                      embeds=embeds,
                                      mask_positions=mask_positions,
                                      remat=remat)
    labels = batch["labels"]
    if cfg.is_encoder:
        # HuBERT-style masked-unit prediction: loss on masked frames only
        loss = cross_entropy(logits, labels, mask=mask_positions)
    elif cfg.frontend == "vision":
        # loss over text positions only (patches are prefix)
        np_ = cfg.num_patch_tokens
        text_logits = logits[:, np_:, :]
        loss = cross_entropy(text_logits[:, :-1], labels[:, 1:])
    else:
        loss = cross_entropy(logits[:, :-1], labels[:, 1:])
    total = loss + aux_coef * moe_aux
    return total, {"loss": loss, "moe_aux": moe_aux}


def value_and_grad(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   remat: bool = True
                   ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """(gradient of ``loss_fn``'s total for every leaf of ``params``, in
    ``tree.leaves`` order; its metrics).  The leaves require grad only
    for the call; a leaf the loss does not reach gets zeros."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    try:
        total, metrics = loss_fn(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(total, ps, allow_unused=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    return grads, {k: v.detach() for k, v in metrics.items()}


def _micro_batch(v: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Row block i of n of ``v`` (a local region over the batch dim)."""
    axes = ("batch",) + (None,) * (v.dim() - 1)
    return local_region(
        lambda t: t.reshape((n, -1) + tuple(t.shape[1:]))[i], (v,), (axes,),
        axes)


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *,
                    accum_steps: int = 1, remat: bool = True):
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if accum_steps == 1:
            grads, metrics = value_and_grad(state.params, cfg, batch, remat)
        else:
            # micro-batches are contiguous row blocks, as the JAX
            # package's reshape((accum, -1) + ...) cuts them (of each
            # rank's rows, under a sharding rule context on DTensors)
            grads, ms = None, []
            for i in range(accum_steps):
                mb = {k: _micro_batch(v, accum_steps, i)
                      for k, v in batch.items()}
                g, m = value_and_grad(state.params, cfg, mb, remat)
                g = [x.to(torch.float32) for x in g]
                grads = g if grads is None else [
                    a.add_(x) for a, x in zip(grads, g)]
                ms.append(m)
            grads = [g / accum_steps for g in grads]
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads = unflatten(state.params, grads)
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        optimizer.update(grads, state.opt, state.params)
        state.step.add_(1)
        return state, metrics

    return train_step
