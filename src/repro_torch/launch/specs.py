"""Abstract input specs and layouts for every (arch x input shape) pair:
the counterpart of ``repro/launch/specs.py``.

A meta tensor (shape and dtype, no memory) stands in for a
``jax.ShapeDtypeStruct`` and DTensor placements for a ``NamedSharding``.
``build_dryrun`` returns the complete recipe that ``dryrun.py`` traces:
the step function, and its inputs as ``DTensor``s of fake local shards
on the mesh, made in the recipe's ``FakeTensorMode`` and each laid out by
the logical-axis rules (``sharding/axes.py``, ``sharding/rules.py``).
Nothing is allocated: trace ``recipe.fn(*recipe.args)`` under
``roofline.trace.recording(recipe.fake_mode)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed.tensor as dtensor
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.params import init_params
from repro_torch.sharding import axes as ax
from repro_torch.sharding import rules
from repro_torch.training import steps as steps_mod
from repro_torch.training.optimizer import AdamW, constant_schedule
from repro_torch.tree import tree_map


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder:
        return {
            "frame_embeds": _sds((B, S, cfg.d_model), dtype),
            "labels": _sds((B, S), torch.int32),
            "mask": _sds((B, S), torch.bool),
        }
    if cfg.frontend == "vision":
        n_text = S - cfg.num_patch_tokens
        return {
            "tokens": _sds((B, n_text), torch.int32),
            "labels": _sds((B, n_text), torch.int32),
            "patch_embeds": _sds((B, cfg.num_patch_tokens, cfg.d_model),
                                 dtype),
        }
    return {"tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32)}


def prefill_arg_specs(cfg: ModelConfig, shape: InputShape,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder:
        return {"frame_embeds": _sds((B, S, cfg.d_model), dtype)}
    if cfg.frontend == "vision":
        return {"tokens": _sds((B, S - cfg.num_patch_tokens), torch.int32),
                "patch_embeds": _sds((B, cfg.num_patch_tokens, cfg.d_model),
                                     dtype)}
    return {"tokens": _sds((B, S), torch.int32)}


def _placed(spec: torch.Tensor, axes, mesh) -> dtensor.DTensor:
    """An uninitialised DTensor of ``spec``'s shape and dtype laid out by
    ``axes`` (call it under a ``FakeTensorMode``: its shards are fake)."""
    return dtensor.empty(spec.shape, dtype=spec.dtype, device_mesh=mesh,
                         placements=rules.placements(axes, spec.shape, mesh))


def _placed_tree(specs, axes_tree, mesh):
    return tree_map(lambda s, a: _placed(s, a, mesh), specs, axes_tree)


def decode_overlay(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """Context/sequence-parallel overlays for decode shapes."""
    overlay: dict = {}
    sizes = rules.mesh_sizes(mesh)
    model = sizes.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if shape.kind != "decode":
        return overlay
    if cfg.num_kv_heads and cfg.num_kv_heads % model != 0:
        # KV heads can't shard over the model axis -> shard cache seq
        overlay["cache_seq"] = [None, "model"]
    if shape.global_batch == 1:
        # batch-1 long-context: context parallelism over the data axes
        cand = overlay.get("cache_seq", [None])[:1]
        overlay["cache_seq"] = cand + [data_axes, "model"] \
            if cand != [None] else [data_axes, "model"]
        overlay["batch"] = []
    return overlay


@dataclasses.dataclass
class DryrunRecipe:
    fn: Any  # the step function
    args: Tuple  # DTensors of fake shards, in fn's positional order
    description: str
    scan_trips: int = 1  # layer-scan cycles x grad-accum microbatches
    fake_mode: Optional[FakeTensorMode] = None  # the args' fake mode


def default_accum(cfg: ModelConfig, shape: InputShape, mesh) -> int:
    sizes = rules.mesh_sizes(mesh)
    data_ways = 1
    for a in ("pod", "data"):
        data_ways *= sizes.get(a, 1)
    local_batch = max(shape.global_batch // data_ways, 1)
    if cfg.d_model >= 12288:
        want = 16
    elif cfg.d_model >= 6144:
        want = 8
    elif cfg.d_model >= 3840:
        want = 4
    else:
        want = 1
    return max(1, min(want, local_batch))


def build_dryrun(cfg: ModelConfig, shape: InputShape, mesh, *,
                 dtype: torch.dtype = torch.bfloat16,
                 accum: Optional[int] = None,
                 remat: bool = True) -> DryrunRecipe:
    """Recipe for one (arch, input-shape, mesh) combination, under the
    rules that the caller activated (``rules.activate(mesh, overlay)``).
    ``scan_trips`` keeps the JAX package's meaning (its layer-scan cycles
    x micro-batches); the port's trace is unrolled and does not use it."""
    fake_mode = FakeTensorMode()
    B, S = shape.global_batch, shape.seq_len
    _, n_cycles, _ = tf.layer_plan(cfg)
    if shape.kind == "train":
        accum = accum or default_accum(cfg, shape, mesh)
        opt = AdamW(lr=constant_schedule(3e-4))
        state_specs = steps_mod.init_state(cfg, opt, torch.Generator(),
                                           device="meta", dtype=dtype)
        p_axes = ax.param_axes(state_specs.params)
        batch_specs = train_batch_specs(cfg, shape, dtype)
        with fake_mode:
            state = steps_mod.TrainState(
                params=_placed_tree(state_specs.params, p_axes, mesh),
                opt=type(state_specs.opt)(
                    count=_placed(state_specs.opt.count, (), mesh),
                    m=_placed_tree(state_specs.opt.m, p_axes, mesh),
                    v=_placed_tree(state_specs.opt.v, p_axes, mesh)),
                step=_placed(state_specs.step, (), mesh))
            batch = _placed_tree(batch_specs, ax.batch_axes(batch_specs),
                                 mesh)
        fn = steps_mod.make_train_step(cfg, opt, accum_steps=accum,
                                       remat=remat)
        return DryrunRecipe(fn, (state, batch), f"train_step accum={accum}",
                            scan_trips=max(n_cycles, 1) * accum,
                            fake_mode=fake_mode)

    params_specs = init_params(cfg, torch.Generator(), device="meta",
                               dtype=dtype)
    p_axes = ax.param_axes(params_specs)
    with fake_mode:
        params = _placed_tree(params_specs, p_axes, mesh)

    if shape.kind == "prefill":
        specs = prefill_arg_specs(cfg, shape, dtype)
        with fake_mode:
            args = _placed_tree(specs, ax.batch_axes(specs), mesh)

        if cfg.is_encoder:
            def fn(params, frame_embeds):
                logits, _ = tf.forward_full(params, cfg,
                                            embeds=frame_embeds)
                return logits
        else:
            cache_specs = tf.init_cache(cfg, B, S, dtype, device="meta")
            cache_axes = ax.cache_axes(cache_specs)

            def empty_cache():
                # the returned cache is laid out by the rules, as the JAX
                # recipe's out_shardings constrain it
                return tree_map(lambda s, a: dtensor.zeros(
                    s.shape, dtype=s.dtype, device_mesh=mesh,
                    placements=rules.placements(a, s.shape, mesh)),
                    cache_specs, cache_axes)

            if cfg.frontend == "vision":
                def fn(params, tokens, patch_embeds):
                    return tf.prefill(params, cfg, tokens=tokens,
                                      embeds=patch_embeds,
                                      cache=empty_cache(), dtype=dtype)
            else:
                def fn(params, tokens):
                    return tf.prefill(params, cfg, tokens=tokens,
                                      cache=empty_cache(), dtype=dtype)
        order = [k for k in ("frame_embeds", "tokens", "patch_embeds")
                 if k in args]  # matches each fn's positional signature
        return DryrunRecipe(fn, (params,) + tuple(args[k] for k in order),
                            "prefill_step", scan_trips=max(n_cycles, 1),
                            fake_mode=fake_mode)

    # decode
    cache_specs = tf.init_cache(cfg, B, S, dtype, device="meta")
    with fake_mode:
        cache = _placed_tree(cache_specs, ax.cache_axes(cache_specs), mesh)
        token = _placed(_sds((B,), torch.int32), ("batch",), mesh)
    # the step writes the cache's last slot (the JAX package traces the
    # position abstract; the port's decode takes it as an int)
    pos = S - 1

    def fn(params, token, cache):
        return tf.decode_step(params, cfg, token, pos, cache)

    return DryrunRecipe(fn, (params, token, cache),
                        "serve_step (1 new token, cached context)",
                        scan_trips=max(n_cycles, 1), fake_mode=fake_mode)
