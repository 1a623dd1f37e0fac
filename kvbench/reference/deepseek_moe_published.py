"""DeepSeekMoE 16B as published (arXiv:2401.06066; the model card's
``config.json`` of deepseek-ai/deepseek-moe-16b-base): the first layer a
dense SwiGLU (``first_k_dense_replace`` 1), each later layer 64
fine-grained routed SwiGLU experts and 2 shared experts.  The router is a
softmax over the routed experts in float32 (``scoring_func`` softmax);
each token takes its top 6 (``topk_method`` greedy), whose probabilities
are its weights as they are (``norm_topk_prob`` false: not renormalised),
and no choice is dropped (no capacity).  The shared experts are one
SwiGLU of width 2 x 1,408 that every token passes.

Departures from the published description, each a representation that
computes the same function: the norms store their weight centred on 0
and scale by ``1 + w`` (``common.rms_norm``); the weights are random from
the seed, in float32 where the checkpoint is bfloat16; among equal router
probabilities the lower expert index comes first (a stable sort; the
published ``torch.topk`` promises no order).  Routing groups mean nothing
here: every token routes alone, so the ``groups`` the harness passes are
not read.
"""
from __future__ import annotations

import torch

from kvbench.reference import common


def _routed(lp, x, m):
    """The routed experts over x [s, d]: each token's top-k choices, each
    expert's output times its softmax probability, summed over a token's
    choices in choice order."""
    moe = lp["moe"]
    k = m["experts_per_token"]
    probs = torch.softmax(x @ moe["router"], -1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    ys = x.new_zeros(x.shape[0], k, x.shape[1])
    for e in torch.unique(top_e).tolist():
        t, j = (top_e == e).nonzero(as_tuple=True)
        ys[t, j] = common.swiglu(moe["wi"][e], moe["wo"][e], x[t]) \
            * top_w[t, j, None]
    return ys.sum(1)


def mlp(lp, x, m, i, groups):
    if "mlp" in lp:
        return common.swiglu(lp["mlp"]["wi"], lp["mlp"]["wo"], x)
    sh = lp["moe"]["shared"]
    return _routed(lp, x, m) + common.swiglu(sh["wi"], sh["wo"], x)


def stored_prefix(w, m, tokens):
    return common.stored_prefix(w, m, mlp, tokens)


def logits(w, m, tokens, start, prefix, groups, first):
    return common.forward(w, m, mlp, tokens, start, prefix, groups, first)[0]
