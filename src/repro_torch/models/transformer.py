"""Model composition: embeddings -> layer stack -> head.

Counterpart of ``repro/models/transformer.py``.  The JAX package stacks
the repeating layer cycle and scans it; here the stack is the ``layers``
list that ``params.from_numpy`` builds, and a cache is a list with one
dict per layer.  Mamba2 (``ssm``) layers are ported; ``attn`` and
``rglru`` layers of the dense-cache zoo raise until the model-zoo slice
(the paged attention path of the engine lives in
``repro_torch/serving/paged_model.py``).

Entry points:
  forward_full(params, cfg, tokens/embeds, ...)   -> (logits, aux)
  prefill(params, cfg, tokens/embeds)             -> (logits, cache)
  decode_step(params, cfg, token, pos, cache)     -> (logits, cache)
  init_cache(cfg, batch, seq_len, dtype, device)
  snapshot_states(cache, cfg) / cache_from_snapshot(states, cfg, device)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import rms_norm

Cache = List[Dict[str, torch.Tensor]]


def _unported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kind!r} layers of the dense-cache model zoo are not ported yet; "
        f"they arrive with the model-zoo slice (ROADMAP Queue 1 item 9)")


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig) -> Tuple[int, int, Tuple[str, ...]]:
    """(n_prefix_layers, n_cycles, rest_kinds)."""
    kinds = cfg.layer_kinds()
    n_prefix = 1 if cfg.first_layer_dense else 0
    body = kinds[n_prefix:]
    cl = len(cfg.layer_pattern)
    n_cycles = len(body) // cl
    rest = body[n_cycles * cl:]
    return n_prefix, n_cycles, rest


def _check_plan(cfg: ModelConfig) -> None:
    """The ported stacks are whole cycles of their pattern (Mamba2: 64
    cycles of one ``ssm`` layer); a dense first layer (``prefix``) or
    remainder layers (``rest``) come with the model-zoo slice."""
    n_prefix, _, rest = layer_plan(cfg)
    if n_prefix or rest:
        raise _unported("prefix" if n_prefix else "rest")


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int,
                      dtype: torch.dtype, device: torch.device) -> dict:
    if kind == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    raise _unported(kind)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Cache:
    """One cache dict per layer (``seq_len`` sizes the attention caches of
    a later slice; recurrent caches do not depend on it)."""
    del seq_len
    _check_plan(cfg)
    device = resolve_device(device)
    return [_init_layer_cache(cfg, kind, batch, dtype, device)
            for kind in cfg.layer_kinds()]


def snapshot_states(cache: Cache, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The cache as the named float32 arrays that the JAX package's
    snapshot path flattens its cache tree into: layer ``c * cl + j`` of
    the scanned cycles (pattern length cl) at index c of
    ``cycles/l<j>/<name>``, for Mamba2 ``cycles/l0/state``
    [n_cycles, b, nh, hd, S] and ``cycles/l0/conv``
    [n_cycles, b, w-1, din+2GS].  Keeping the stacked names matters:
    ``encode_state_snapshot`` takes one absmax scale per named array."""
    _check_plan(cfg)
    cl = len(cfg.layer_pattern)
    stacks: Dict[str, List[torch.Tensor]] = {}
    for i, layer in enumerate(cache):
        for name, t in layer.items():
            stacks.setdefault(f"cycles/l{i % cl}/{name}", []).append(t)
    return {name: torch.stack(ts).detach().to(torch.float32).cpu().numpy()
            for name, ts in stacks.items()}


def cache_from_snapshot(states: Dict[str, np.ndarray], cfg: ModelConfig,
                        device: DeviceLike = None,
                        batch: Optional[int] = None) -> Cache:
    """Rebuild a cache from ``snapshot_states``' arrays (or their decoded
    copies), bit for bit.  ``batch`` repeats a batch-1 snapshot for that
    many sequences."""
    _check_plan(cfg)
    device = resolve_device(device)
    cl = len(cfg.layer_pattern)
    cache: Cache = [{} for _ in range(cfg.num_layers)]
    for full, arr in states.items():
        _, lj, name = full.split("/")
        t = torch.tensor(arr, dtype=torch.float32, device=device)
        if batch is not None and batch != t.shape[1]:
            if t.shape[1] != 1:
                raise ValueError(f"{full}: batch {t.shape[1]} cannot be "
                                 f"repeated to {batch}")
            t = t.repeat_interleave(batch, dim=1)
        for c in range(t.shape[0]):
            cache[c * cl + int(lj[1:])][name] = t[c]
    return cache


# ---------------------------------------------------------------------------
# Layer application and stack
# ---------------------------------------------------------------------------

def _apply_layer(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 mode: str, cache: Optional[dict]
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, new_cache).  No ported layer has an auxiliary loss (the
    MoE layers that do arrive with the model-zoo slice)."""
    if kind != "ssm":
        raise _unported(kind)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "decode":
        out, new_cache = ssm_mod.apply_ssm_decode(p["ssm"], h, cfg, cache)
    else:
        out, new_cache = ssm_mod.apply_ssm_full(
            p["ssm"], h, cfg, with_cache=(mode == "prefill"))
    return x + out, new_cache


def _run_stack(params, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
               cache: Optional[Cache]
               ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (x, new_cache, aux_loss)."""
    new_cache: Cache = []
    _check_plan(cfg)
    for i, (kind, lp) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        c = cache[i] if cache is not None else None
        x, nc = _apply_layer(kind, lp, x, cfg, mode=mode, cache=c)
        new_cache.append(nc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, (new_cache if cache is not None else None), aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                 embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Frontend embeddings (if any) then token embeddings, along the
    sequence.  Learned positions and encoder masks come with the
    model-zoo slice: the port's params carry no ``pos_embed`` or
    ``mask_embed``."""
    parts = []
    if embeds is not None:
        parts.append(embeds)
    if tokens is not None:
        parts.append(params["embed"][tokens])
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x [b, s, d] -> logits [b, s, V] (tied or untied head)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, w)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward_full(params, cfg: ModelConfig, *, tokens=None, embeds=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (train path). Returns (logits, moe_aux)."""
    x = embed_inputs(params, cfg, tokens, embeds)
    x, _, aux = _run_stack(params, cfg, x, mode="full", cache=None)
    return lm_logits(params, cfg, x), aux


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            cache: Optional[Cache] = None,
            dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, Cache]:
    """Process the full prompt, fill the cache, return last-pos logits."""
    x = embed_inputs(params, cfg, tokens, embeds)
    if cache is None:
        cache = init_cache(cfg, x.shape[0], x.shape[1], dtype,
                           device=x.device)
    x, new_cache, _ = _run_stack(params, cfg, x, mode="prefill", cache=cache)
    return lm_logits(params, cfg, x[:, -1:, :]), new_cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos: int,
                cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One decode step. token [b] int; pos (next index), which recurrent
    layers do not read."""
    del pos
    x = params["embed"][token][:, None, :]
    x, new_cache, _ = _run_stack(params, cfg, x, mode="decode", cache=cache)
    return lm_logits(params, cfg, x)[:, 0], new_cache
