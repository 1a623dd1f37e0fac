"""Dense grouped-query decoder with SwiGLU blocks (Yi, arXiv:2403.04652;
the Llama block): every layer is attention then SwiGLU."""
from __future__ import annotations

from kvbench.reference import common


def mlp(lp, x, m, i, groups):
    return common.swiglu(lp["mlp"]["wi"], lp["mlp"]["wo"], x)


def stored_prefix(w, m, tokens):
    return common.stored_prefix(w, m, mlp, tokens)


def logits(w, m, tokens, start, prefix, groups, first):
    return common.forward(w, m, mlp, tokens, start, prefix, groups, first)[0]
