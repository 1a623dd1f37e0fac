"""Random weights in the tree layout ``repro_torch.serving.engine.
LiveEngine`` takes, made on the device from the seed in a few large
calls: one ``normal_`` over a flat buffer that holds every leaf, then one
scale per group of leaves that share a standard deviation.

Leaves are views of the one buffer.  Both the program and the reference
read these tensors; neither changes them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[Tuple, Tuple[int, ...], float]  # (path, shape, std)


def leaf_specs(m: dict, weights: dict) -> List[Spec]:
    """Every leaf of the tree for the config ``m`` (the ``model`` section
    of a configuration file): its path, shape and standard deviation.
    Dense products draw N(0, 1/fan_in); the embedding N(0, embed_std²);
    norm weights, stored centred on 0 as the port's ``(1 + w)`` scale
    reads them, N(0, norm_std²)."""
    d, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    E = m.get("num_experts", 0)
    norm = weights["norm_std"]
    specs: List[Spec] = [(("embed",), (V, d), weights["embed_std"]),
                         (("final_norm",), (d,), norm)]
    if not m.get("tie_embeddings", False):
        specs.append((("lm_head",), (d, V), 1 / math.sqrt(d)))

    def mlp(path, ff):
        return [(path + ("wi",), (d, 2, ff), 1 / math.sqrt(d)),
                (path + ("wo",), (ff, d), 1 / math.sqrt(ff))]

    for i in range(L):
        p = ("layers", i)
        specs += [(p + ("ln1",), (d,), norm),
                  (p + ("attn", "wq"), (d, H, hd), 1 / math.sqrt(d)),
                  (p + ("attn", "wk"), (d, K, hd), 1 / math.sqrt(d)),
                  (p + ("attn", "wv"), (d, K, hd), 1 / math.sqrt(d)),
                  (p + ("attn", "wo"), (H, hd, d), 1 / math.sqrt(H * hd)),
                  (p + ("ln2",), (d,), norm)]
        dense = not E or (i == 0 and m.get("first_layer_dense", False))
        if dense:
            ff = m["dense_d_ff"] if (E and m.get("dense_d_ff")) else m["d_ff"]
            specs += mlp(p + ("mlp",), ff)
        else:
            ff = m["d_ff"]
            specs += [(p + ("moe", "router"), (d, E), 1 / math.sqrt(d)),
                      (p + ("moe", "wi"), (E, d, 2, ff), 1 / math.sqrt(d)),
                      (p + ("moe", "wo"), (E, ff, d), 1 / math.sqrt(ff))]
            if m.get("num_shared_experts", 0):
                specs += mlp(p + ("moe", "shared"),
                             m["num_shared_experts"] * ff)
    return specs


def n_params(m: dict, weights: dict) -> int:
    return sum(math.prod(s) for _, s, _ in leaf_specs(m, weights))


def make_weights(m: dict, weights: dict, seed: int,
                 device: torch.device) -> Dict:
    """The tree for ``m`` in float32 on ``device``, drawn from ``seed``.
    The leaves are laid out by standard deviation, so each group is one
    contiguous range of the buffer and one in-place scale."""
    specs = sorted(leaf_specs(m, weights), key=lambda s: s[2])
    total = sum(math.prod(s) for _, s, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    buf.normal_(0.0, 1.0, generator=gen)
    tree: Dict = {"layers": [{} for _ in range(m["num_layers"])]}
    off, start, std0 = 0, 0, None
    for path, shape, std in specs:
        if std != std0:
            if std0 is not None:
                buf[start:off].mul_(std0)
            start, std0 = off, std
        n = math.prod(shape)
        node = tree
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(
                key, {})
        node[path[-1]] = buf[off:off + n].view(shape)
        off += n
    buf[start:off].mul_(std0)
    return tree
