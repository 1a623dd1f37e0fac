"""DeepSeekMoE (arXiv:2401.06066): the first layer dense SwiGLU, the rest
fine-grained experts: a softmax router over ``num_experts`` routed
experts, the top ``experts_per_token`` taken (the lower index first among
equal scores), plus ``num_shared_experts`` experts' worth of one shared
SwiGLU that every token passes.

As the port routes today, which is not as the published model does
(``norm_topk_prob`` false, no choice dropped): the top-k weights are
renormalised to sum to 1, and each routing group (a prefill's tokens, or
one decode token) gives an expert room for ``max(1, int(s k cf / E))``
choices, taken in token order; a choice beyond that room is dropped and
its weight is not given back.  No cell uses this reference: it is to
follow the published routing once the port has it.
"""
from __future__ import annotations

import torch

from kvbench.reference import common


def _routed(lp, x, m, groups):
    """The routed experts over x [s, d], whose tokens route in the runs
    ``groups`` (each run its own room per expert)."""
    moe = lp["moe"]
    s, dev = x.shape[0], x.device
    E, k = m["num_experts"], m["experts_per_token"]
    sizes = torch.tensor(list(groups), device=dev)
    cap = torch.clamp_min((sizes * k * m["moe_capacity_factor"] / E
                           ).floor().long(), 1)
    probs = torch.softmax(x @ moe["router"], -1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True,
                              stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(-1)  # token-major choices
    group = torch.repeat_interleave(torch.arange(len(groups), device=dev),
                                    sizes * k)
    onehot = torch.nn.functional.one_hot(flat_e, E)
    before = torch.cumsum(onehot, 0) - onehot  # earlier choices, per expert
    first = torch.cumsum(sizes * k, 0) - sizes * k  # each run's first choice
    before = before - before[first][group]
    keep = before.gather(1, flat_e[:, None])[:, 0] < cap[group]
    tok = torch.arange(s, device=dev).repeat_interleave(k)
    wts = top_w.reshape(-1)
    out = torch.zeros_like(x)
    for e in torch.unique(flat_e[keep]).tolist():
        sel = keep & (flat_e == e)
        t = tok[sel]
        y = common.swiglu(moe["wi"][e], moe["wo"][e], x[t])
        out.index_add_(0, t, y * wts[sel][:, None])
    return out


def mlp(lp, x, m, i, groups):
    if "mlp" in lp:
        return common.swiglu(lp["mlp"]["wi"], lp["mlp"]["wo"], x)
    sh = lp["moe"]["shared"]
    return _routed(lp, x, m, groups) + common.swiglu(sh["wi"], sh["wo"], x)


def stored_prefix(w, m, tokens):
    return common.stored_prefix(w, m, mlp, tokens)


def logits(w, m, tokens, start, prefix, groups, first):
    return common.forward(w, m, mlp, tokens, start, prefix, groups, first)[0]
