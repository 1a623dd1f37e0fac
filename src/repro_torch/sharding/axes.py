"""Logical-axis annotation of whole trees (params, optimizer state, KV
caches, batches) by key path: the bridge between the port's parameter
structure and the mesh rules in `repro_torch.sharding.rules`.

The port's trees hold their layers unstacked (the ``layers`` list of
per-layer dicts of ``params.py``, the per-layer cache dicts of
``models/transformer.py::init_cache``), so no leaf carries the leading
``"layers"`` axis that the JAX package gives a leaf of its scanned
``cycles``.  Otherwise the name rules are the JAX package's.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch.tree import flatten, unflatten


def _map_by_names(fn, tree) -> Any:
    """``fn(names, leaf)`` over the leaves of ``tree``, by their key
    paths split into names, into a tree of the same structure."""
    return unflatten(tree, [fn(tuple(path.split("/")), leaf)
                            for path, leaf in flatten(tree)])


def _rank_checked(names: Tuple[str, ...], ndim: int, axes) -> Tuple:
    axes = tuple(axes)
    if len(axes) != ndim:
        raise ValueError(f"{names}: {len(axes)} logical axes {axes} for a "
                         f"rank-{ndim} leaf")
    return axes


def _param_leaf_axes(names: Tuple[str, ...], ndim: int) -> Tuple:
    """Logical axes for one parameter leaf, by its tree path."""
    name = names[-1]
    in_moe = "moe" in names and "shared" not in names

    def wrap(axes):
        return _rank_checked(names, ndim, axes)

    if name == "embed":
        return ("vocab", "embed")
    if name == "pos_embed":
        return (None, "embed")
    if name == "lm_head":
        return ("embed", "vocab")
    if name in ("final_norm", "mask_embed"):
        return (None,)
    if name in ("ln1", "ln2", "norm_w", "lam", "A_log", "D", "dt_bias"):
        return wrap((None,) * ndim)
    if name == "wq":
        return wrap(("embed", "heads", None))
    if name in ("wk", "wv"):
        return wrap(("embed", "kv_heads", None))
    if name == "bq":
        return wrap(("heads", None))
    if name in ("bk", "bv"):
        return wrap(("kv_heads", None))
    if name == "wo" and "attn" in names:
        return wrap(("heads", None, "embed"))
    if name == "router":
        return wrap(("embed", "experts"))
    if name == "wi":
        if in_moe:
            return wrap(("experts", "embed", None, "mlp") if ndim == 4
                        else ("experts", "embed", "mlp"))
        return wrap(("embed", None, "mlp") if ndim == 3
                    else ("embed", "mlp"))
    if name == "wo":  # mlp / moe (attn handled above)
        if in_moe:
            return wrap(("experts", "mlp", "embed"))
        return wrap(("mlp", "embed"))
    if name == "w_in":
        return wrap(("embed", "ssm_inner"))
    if name == "conv":
        kind = "ssm_inner" if "ssm" in names else "rglru_width"
        return wrap((None, kind))
    if name == "w_out":
        kind = "ssm_inner" if "ssm" in names else "rglru_width"
        return wrap((kind, "embed"))
    if name in ("w_x", "w_gate"):
        return wrap(("embed", "rglru_width"))
    if name in ("w_a", "w_i"):
        return wrap((None, "rglru_width"))
    raise ValueError(f"no axis rule for param {names}")


def param_axes(params) -> Any:
    """Tree of logical-axes tuples matching a params(-shaped) tree."""
    return _map_by_names(
        lambda names, x: _param_leaf_axes(names, len(x.shape)), params)


def _cache_leaf_axes(names: Tuple[str, ...], ndim: int) -> Tuple:
    name = names[-1]

    def wrap(axes):
        return _rank_checked(names, ndim, axes)

    if name in ("k", "v"):
        return wrap(("batch", "cache_seq", "kv_heads", None))
    if name == "state":
        return wrap(("batch", "ssm_heads", None, "ssm_state"))
    if name == "conv":
        # ssm conv [b, w-1, convdim] / rglru conv [b, w-1, w]: the channel
        # dim shards over "model" either way (logical "conv_channels")
        return wrap(("batch", None, "conv_channels"))
    if name == "h":
        return wrap(("batch", "rglru_width"))
    raise ValueError(f"no axis rule for cache leaf {names}")


def cache_axes(cache) -> Any:
    return _map_by_names(
        lambda names, x: _cache_leaf_axes(names, len(x.shape)), cache)


def batch_axes(batch) -> Any:
    def leaf(names, x):
        if names[-1] in ("patch_embeds", "frame_embeds"):
            return ("batch", None, None)
        return ("batch",) + (None,) * (len(x.shape) - 1)
    return _map_by_names(leaf, batch)
