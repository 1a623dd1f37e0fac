"""Model composition: embeddings -> layer stack -> head.

Counterpart of ``repro/models/transformer.py``, for every layer kind
(``attn``, ``rglru``, ``ssm``), a dense first layer (``prefix``), the
cycles of the layer pattern and the remainder layers (``rest``).  The JAX
package stacks the repeating cycle and scans it; here the stack is the
``layers`` list that ``params.from_numpy`` builds (prefix, then cycles,
then rest), and a cache is a list with one dict per layer.  The paged
attention path of the serving engine lives in
``repro_torch/serving/paged_model.py``.

Entry points:
  forward_full(params, cfg, tokens/embeds, ...)   -> (logits, moe_aux)
  prefill(params, cfg, tokens/embeds)             -> (logits, cache)
  decode_step(params, cfg, token, pos, cache)     -> (logits, cache)
  init_cache(cfg, batch, seq_len, dtype, device)
  snapshot_states(cache, cfg) / cache_from_snapshot(states, cfg, device)

Under a sharding rule context on DTensors (the dry run) the embedding
lookups and the head run as local regions (``sharding.rules``), and
``shard_hint`` lays the residual stream and the logits out at the JAX
package's four sites.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import rms_norm
from repro_torch.sharding import rules
from repro_torch.sharding.rules import local_region, shard_hint

MAX_LEARNED_POS = 32_768  # hubert prefill_32k upper bound

Cache = List[Dict[str, torch.Tensor]]


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


def stack_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """Each layer's kind in the order of ``params["layers"]``: the prefix
    (attention with a dense MLP), the cycles of the pattern, the rest."""
    n_prefix, n_cycles, rest = layer_plan(cfg)
    return (("attn",) * n_prefix + tuple(cfg.layer_pattern) * n_cycles
            + tuple(rest))


def _attn_window(cfg: ModelConfig) -> int:
    return cfg.sliding_window or cfg.local_window


def _check_whole_cycles(cfg: ModelConfig) -> None:
    """The snapshot names (``cycles/l<j>/<name>``) cover stacks made of
    whole cycles of their pattern only (Mamba2: 64 cycles of one ``ssm``
    layer), as the JAX package's snapshot path does."""
    n_prefix, _, rest = layer_plan(cfg)
    if n_prefix or rest:
        raise ValueError(
            f"{cfg.name}: state snapshots name the layers of whole cycles; "
            f"this stack has {'a prefix' if n_prefix else 'remainder'} "
            f"layers")


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                      dtype: torch.dtype, device: torch.device) -> dict:
    if kind == "attn":
        spec = attn_mod.cache_spec(cfg, seq_len, local=cfg.local_window > 0)
        return attn_mod.init_kv_cache(cfg, batch, spec, dtype, device)
    if kind == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Cache:
    """One cache dict per layer; attention caches hold ``seq_len`` slots,
    or a ring of the window when the window is shorter."""
    device = resolve_device(device)
    return [_init_layer_cache(cfg, kind, batch, seq_len, dtype, device)
            for kind in stack_kinds(cfg)]


def snapshot_states(cache: Cache, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The cache as the named float32 arrays that the JAX package's
    snapshot path flattens its cache tree into: layer ``c * cl + j`` of
    the scanned cycles (pattern length cl) at index c of
    ``cycles/l<j>/<name>``, for Mamba2 ``cycles/l0/state``
    [n_cycles, b, nh, hd, S] and ``cycles/l0/conv``
    [n_cycles, b, w-1, din+2GS].  Keeping the stacked names matters:
    ``encode_state_snapshot`` takes one absmax scale per named array."""
    _check_whole_cycles(cfg)
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
    _check_whole_cycles(cfg)
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
                 mode: str, cache: Optional[dict], pos: Optional[int],
                 positions: torch.Tensor, token_cache_updates: bool = False
                 ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    window = _attn_window(cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    new_cache = None
    if kind == "attn":
        causal = not cfg.is_encoder
        if mode == "full":
            out = attn_mod.attention_full(p["attn"], h, cfg, positions,
                                          window=window, causal=causal)
        elif mode == "prefill":
            cap = cache["k"].shape[1]
            # ring writes only needed when the prompt overflows the window
            spec = attn_mod.CacheSpec(cap, windowed=cap < positions.shape[-1])
            out, new_cache = attn_mod.attention_prefill(
                p["attn"], h, cfg, positions, cache, spec, causal=causal)
        else:  # decode
            # windowed slot/validity math is a no-op while pos < capacity,
            # so it is safe to use ring semantics whenever a window exists
            spec = attn_mod.CacheSpec(cache["k"].shape[1],
                                      windowed=window > 0)
            if token_cache_updates:
                # the layers of the JAX package's scanned cycles: attend
                # over the stale cache plus the new token, then write it
                out, tok = attn_mod.attention_decode_token(
                    p["attn"], h, cfg, pos, cache, spec)
                slot = (pos % spec.capacity) if window > 0 else pos
                new_cache = {
                    "k": attn_mod.write_slot(cache["k"], tok["k_tok"], slot),
                    "v": attn_mod.write_slot(cache["v"], tok["v_tok"], slot)}
            else:
                out, new_cache = attn_mod.attention_decode(
                    p["attn"], h, cfg, pos, cache, spec)
    elif kind == "rglru":
        if mode == "decode":
            out, new_cache = rglru_mod.apply_rglru_decode(p["rec"], h, cfg,
                                                          cache)
        else:
            out, new_cache = rglru_mod.apply_rglru_full(
                p["rec"], h, cfg, with_cache=(mode == "prefill"))
    elif kind == "ssm":
        if mode == "decode":
            out, new_cache = ssm_mod.apply_ssm_decode(p["ssm"], h, cfg, cache)
        else:
            out, new_cache = ssm_mod.apply_ssm_full(
                p["ssm"], h, cfg, with_cache=(mode == "prefill"))
        x = x + out  # mamba2 blocks have no MLP
        x = shard_hint(x, ("batch", "seq", "embed_act"))
        return x, new_cache, aux
    else:
        raise ValueError(kind)

    x = x + out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        if mode == "decode":
            # the batch's tokens route as one group
            b = h2.shape[0]
            out2, aux = moe_mod.apply_moe(p["moe"], h2.reshape(1, b, -1),
                                          cfg)
            out2 = out2.reshape(b, 1, -1)
        else:
            out2, aux = moe_mod.apply_moe(p["moe"], h2, cfg)
    else:
        out2 = mlp_mod.apply_mlp(p["mlp"], h2, cfg.mlp_kind)
    x = x + out2
    x = shard_hint(x, ("batch", "seq", "embed_act"))
    return x, new_cache, aux


def _full_layer(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x, _, aux = _apply_layer(kind, p, x, cfg, mode="full", cache=None,
                             pos=None, positions=positions)
    return x, aux


def _run_stack(params, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
               cache: Optional[Cache], pos: Optional[int],
               positions: torch.Tensor, remat: bool = False
               ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (x, new_cache, summed aux loss).  ``remat`` (mode "full"
    only) keeps no activation of a layer for the backward but its input,
    and runs the layer again there, as ``jax.checkpoint`` around the JAX
    package's scanned layer body does."""
    n_prefix, n_cycles, _ = layer_plan(cfg)
    cycle_end = n_prefix + n_cycles * len(cfg.layer_pattern)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Cache = []
    for i, (kind, lp) in enumerate(zip(stack_kinds(cfg), params["layers"])):
        if remat:
            x, aux = checkpoint(_full_layer, kind, lp, x, cfg, positions,
                                use_reentrant=False)
            nc = None
        else:
            x, nc, aux = _apply_layer(
                kind, lp, x, cfg, mode=mode,
                cache=cache[i] if cache is not None else None, pos=pos,
                positions=positions,
                token_cache_updates=(mode == "decode"
                                     and n_prefix <= i < cycle_end))
        aux_total = aux_total + aux
        new_cache.append(nc)
    return x, (new_cache if cache is not None else None), aux_total


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                 embeds: Optional[torch.Tensor], positions: torch.Tensor,
                 mask_positions: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Frontend embeddings (an encoder's masked frames replaced by
    ``mask_embed``) then token embeddings, along the sequence, plus
    learned positions where the config has no RoPE."""
    parts = []
    if embeds is not None:
        e = embeds
        if cfg.is_encoder and mask_positions is not None:
            e = torch.where(mask_positions[..., None],
                            params["mask_embed"].to(e.dtype), e)
        parts.append(e)
    if tokens is not None:
        parts.append(lookup(params["embed"], tokens, "vocab"))
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    if "pos_embed" in params:
        x = x + lookup(params["pos_embed"], positions, None)
    return shard_hint(x, ("batch", "seq", "embed_act"))


def lookup(table: torch.Tensor, ids: torch.Tensor,
           axis: Optional[str]) -> torch.Tensor:
    """``table[ids]``: rows of a [n, d] table by ids [b] or [b, s].  In a
    region whose table rows shard over logical ``axis`` (the vocab), each
    rank looks up the ids its rows hold and leaves zeros elsewhere: a
    partial sum over those shards."""
    ids_axes = ("batch", "seq")[:ids.dim()]
    return local_region(_lookup_local, (table, ids), ((axis, None), ids_axes),
                        ids_axes + (None,), partial=(axis,) if axis else ())


def _lookup_local(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    ids = ids.long()
    n = table.shape[0]
    if n == rules.global_size("vocab", n):
        return table[ids]
    local = ids - rules.local_offset("vocab")
    hit = (local >= 0) & (local < n)
    rows = table[torch.where(hit, local, 0)]
    return torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x [b, s, d] -> logits [b, s, V] (tied or untied head)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = rules.einsum("bsd,dv->bsv", x, w, ("batch", "seq", None),
                          (None, "vocab"), ("batch", "seq", "vocab"))
    return shard_hint(logits, ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _positions(tokens, embeds) -> torch.Tensor:
    ref = tokens if tokens is not None else embeds
    b = ref.shape[0]
    s = (0 if tokens is None else tokens.shape[1]) + \
        (0 if embeds is None else embeds.shape[1])
    return torch.arange(s, dtype=torch.int32, device=ref.device).expand(b, s)


def forward_full(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                 mask_positions=None, remat: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (train path). Returns (logits, moe_aux).
    ``remat`` checkpoints each layer (``torch.utils.checkpoint``): the
    same values, with a layer's activations rebuilt in the backward."""
    positions = _positions(tokens, embeds)
    x = embed_inputs(params, cfg, tokens, embeds, positions, mask_positions)
    x, _, aux = _run_stack(params, cfg, x, mode="full", cache=None, pos=None,
                           positions=positions, remat=remat)
    return lm_logits(params, cfg, x), aux


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            cache: Optional[Cache] = None,
            dtype: torch.dtype = torch.float32
            ) -> Tuple[torch.Tensor, Cache]:
    """Process the full prompt, fill the cache, return last-pos logits."""
    positions = _positions(tokens, embeds)
    b, s = positions.shape
    if cache is None:
        cache = init_cache(cfg, b, s, dtype, device=positions.device)
    x = embed_inputs(params, cfg, tokens, embeds, positions)
    x, new_cache, _ = _run_stack(params, cfg, x, mode="prefill", cache=cache,
                                 pos=None, positions=positions)
    return lm_logits(params, cfg, x[:, -1:, :]), new_cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos: int,
                cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One decode step. token [b] int; pos (the next index, the same for
    the batch)."""
    pos = int(pos)
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=token.device)
    x = lookup(params["embed"], token, "vocab")[:, None, :]
    if "pos_embed" in params:
        x = x + lookup(params["pos_embed"], positions, None)
    x, new_cache, _ = _run_stack(params, cfg, x, mode="decode", cache=cache,
                                 pos=pos, positions=positions)
    return lm_logits(params, cfg, x)[:, 0], new_cache
