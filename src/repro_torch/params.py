"""Model parameters for the port: the bridge from the JAX package's
parameter tree, and a seeded init with the same distributions.

The port's parameters are a plain dict::

    {"embed": [V, d], "final_norm": [d], "lm_head": [d, V] (untied only),
     "pos_embed": [32768, d] (no RoPE only), "mask_embed": [d] (encoders
     only), "layers": [per-layer dict, ...]}

Each layer dict keeps the JAX package's names and layouts: ``ln1``/``ln2``
[d]; ``attn`` {``wq`` [d, H, hd], ``wk``/``wv`` [d, K, hd], ``wo``
[H, hd, d], optional ``bq``/``bk``/``bv``} or ``rec`` (RG-LRU: ``w_x``,
``w_gate`` [d, w], ``conv`` [4, w], ``w_a``/``w_i`` [w, w], ``lam`` [w]
fp32, ``w_out`` [w, d]); then ``mlp`` {``wi`` [d, 2, ff] for SwiGLU else
[d, ff], ``wo`` [ff, d]} or ``moe`` {``router`` [d, E] fp32, ``wi``
[E, d, 2, ff] for SwiGLU else [E, d, ff], ``wo`` [E, ff, d], optional
``shared`` (an ``mlp`` of ``num_shared_experts * d_ff``)}.  A Mamba2
layer has ``ln1`` and ``ssm`` {``w_in`` [d, 2 din + 2 G S + nh], ``conv``
[w, din + 2 G S], ``A_log``/``D``/``dt_bias`` [nh] fp32, ``norm_w``
[din], ``w_out`` [din, d]} only.  The JAX tree holds a dense first layer
in ``prefix``, stacks the repeating layer cycle along a leading axis
(``jax.vmap`` init) in ``cycles`` and keeps the remainder in ``rest``;
here the three are unstacked, in that order, into the ``layers`` list.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (MAX_LEARNED_POS, layer_plan,
                                            stack_kinds)


def _to_torch(x, device: torch.device):
    if isinstance(x, dict):
        return {k: _to_torch(v, device) for k, v in x.items()}
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
               device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX ``init_params`` tree, as numpy arrays, -> the port's params.

    ``tree`` is e.g. ``jax.tree.map(np.asarray, params)``: ``embed``,
    ``final_norm``, ``lm_head`` unless tied, ``pos_embed`` (learned
    positions) and ``mask_embed`` (encoders) where the config has them,
    and the layer stack as
    ``prefix`` (tuple) + ``cycles`` (dict of ``l<j>`` layers stacked on a
    leading cycle axis, or None) + ``rest`` (tuple).
    """
    device = resolve_device(device)
    out: Dict[str, Any] = {k: _to_torch(tree[k], device)
                           for k in ("embed", "final_norm", "lm_head",
                                     "pos_embed", "mask_embed")
                           if k in tree}
    layers: List[dict] = [_to_torch(lp, device) for lp in tree["prefix"]]
    cycles = tree["cycles"]
    if cycles is not None:
        n_cycles = len(np.asarray(cycles["l0"]["ln1"]))
        for c in range(n_cycles):
            cyc = _index(cycles, c)
            layers.extend(_to_torch(cyc[f"l{j}"], device)
                          for j in range(len(cfg.layer_pattern)))
    layers.extend(_to_torch(lp, device) for lp in tree["rest"])
    assert len(layers) == cfg.num_layers, (len(layers), cfg.num_layers)
    out["layers"] = layers
    return out


def layer_params(params: Dict[str, Any], cfg: ModelConfig, i: int) -> dict:
    """Layer ``i``'s parameters (``serving/paged_model.py::_layer_params``
    in the JAX package; the cycle index math is done once, in
    ``from_numpy``)."""
    return params["layers"][i]


def _dense(shape, fan_in: int, generator: torch.Generator,
           device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``models/common.py::dense_init``: N(0, 1) / sqrt(fan_in)."""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, std, generator=generator).to(dtype)


def _embed(shape, generator: torch.Generator, device: torch.device,
           dtype: torch.dtype) -> torch.Tensor:
    """``models/common.py::embed_init``: N(0, 0.02^2)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, 0.02, generator=generator).to(dtype)


def _ssm_layer(cfg: ModelConfig, dense, zeros, device) -> dict:
    """``models/ssm.py::init_ssm``: a Mamba2 block with no MLP."""
    d, din = cfg.d_model, cfg.d_inner
    G, S, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    convdim = din + 2 * G * S
    f32 = dict(dtype=torch.float32, device=device)
    return {"ln1": zeros((d,)), "ssm": {
        "w_in": dense((d, 2 * din + 2 * G * S + nh), d),
        "conv": dense((cfg.ssm_conv, convdim), cfg.ssm_conv),
        "A_log": torch.zeros((nh,), **f32),  # A = -exp(A_log) = -1
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm_w": zeros((din,)),
        "w_out": dense((din, d), din),
    }}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random weights for any config of the zoo, drawn from the same
    distributions as the JAX ``init_params`` (not the same numbers: the
    two frameworks' generators differ).  ``generator`` must live on
    ``device``."""
    device = resolve_device(device)
    d = cfg.d_model

    def dense(shape, fan_in, dt=dtype):
        return _dense(shape, fan_in, generator, device, dt)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def embed(shape):
        return _embed(shape, generator, device, dtype)

    def mlp(ff):
        """``models/mlp.py::init_mlp``."""
        wi = (d, 2, ff) if cfg.mlp_kind == "swiglu" else (d, ff)
        return {"wi": dense(wi, d), "wo": dense((ff, d), ff)}

    def attention():
        """``models/attention.py::init_attention``."""
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        p = {"wq": dense((d, H, hd), d), "wk": dense((d, K, hd), d),
             "wv": dense((d, K, hd), d), "wo": dense((H, hd, d), H * hd)}
        if cfg.qkv_bias:
            p.update(bq=zeros((H, hd)), bk=zeros((K, hd)), bv=zeros((K, hd)))
        return p

    def rglru():
        """``models/rglru.py::init_rglru``."""
        w = cfg.rglru_width or d
        return {"w_x": dense((d, w), d), "w_gate": dense((d, w), d),
                "conv": dense((4, w), 4), "w_a": dense((w, w), w),
                "w_i": dense((w, w), w),
                "lam": torch.full((w,), 0.65, dtype=torch.float32,
                                  device=device),
                "w_out": dense((w, d), w)}

    def moe():
        """``models/moe.py::init_moe``: the router stays fp32."""
        ff, E = cfg.d_ff, cfg.num_experts
        wi = (E, d, 2, ff) if cfg.mlp_kind == "swiglu" else (E, d, ff)
        p = {"router": dense((d, E), d, torch.float32), "wi": dense(wi, d),
             "wo": dense((E, ff, d), ff)}
        if cfg.num_shared_experts:
            p["shared"] = mlp(cfg.num_shared_experts * ff)
        return p

    def layer(kind: str, dense_mlp: bool = False) -> dict:
        """``models/transformer.py::_init_layer``."""
        if kind == "ssm":
            return _ssm_layer(cfg, dense, zeros, device)
        p: Dict[str, Any] = {"ln1": zeros((d,))}
        p["attn" if kind == "attn" else "rec"] = (
            attention() if kind == "attn" else rglru())
        p["ln2"] = zeros((d,))
        if cfg.num_experts and not dense_mlp:
            p["moe"] = moe()
        else:
            p["mlp"] = mlp(cfg.dense_d_ff if (dense_mlp and cfg.dense_d_ff)
                           else (cfg.d_ff if cfg.d_ff else 4 * d))
        return p

    params: Dict[str, Any] = {"embed": embed((cfg.vocab_size, d)),
                              "final_norm": zeros((d,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size), d)
    if cfg.rope_theta <= 0:
        params["pos_embed"] = embed((MAX_LEARNED_POS, d))
    if cfg.is_encoder:
        params["mask_embed"] = embed((d,))
    n_prefix = layer_plan(cfg)[0]
    params["layers"] = [layer(kind, dense_mlp=i < n_prefix)
                        for i, kind in enumerate(stack_kinds(cfg))]
    return params
