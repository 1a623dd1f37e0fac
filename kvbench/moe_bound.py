"""The grouped expert kernels' bytes and operations per launch
(``repro_torch/kernels/moe_experts``), frozen as ``flops.py`` is, so that
no change to the program moves them.

One MoE layer call on the serving path (a ``moe`` span of the program:
``tokens``, ``choices`` = tokens x experts per token, ``experts`` = the
distinct experts chosen) makes one gate-up launch and one down launch.
Each input byte is counted read once and each output byte written once:
the gate-up launch reads the chosen experts' gate and up weights and the
tokens' rows and writes a row of ff a choice; the down launch reads the
chosen experts' down weights, those rows and a weight a choice, and
writes a row of d a choice.  Operations: 2 x 2 x d x ff a choice for
gate-up, 2 x ff x d for down, so 2 x 3 x d x ff a choice in all.
"""
from __future__ import annotations

from kvbench import flops


def gate_up_bound_s(m: dict, tokens: int, choices: int,
                    experts: int) -> float:
    d, ff = m["d_model"], m["d_ff"]
    n_bytes = 4 * (experts * d * 2 * ff + tokens * d + choices * ff)
    return flops.bound_s(n_bytes, 2.0 * choices * d * 2 * ff)


def down_bound_s(m: dict, choices: int, experts: int) -> float:
    d, ff = m["d_model"], m["d_ff"]
    n_bytes = 4 * (experts * ff * d + choices * (ff + 1) + choices * d)
    return flops.bound_s(n_bytes, 2.0 * choices * ff * d)


def layer_bound_s(m: dict, tokens: int, choices: int, experts: int) -> float:
    """The two launches of one MoE layer call, each at its own bound."""
    return (gate_up_bound_s(m, tokens, choices, experts)
            + down_bound_s(m, choices, experts))
