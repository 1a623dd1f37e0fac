"""The yardstick's arithmetic: the card's peaks, the model's operations
per token, and each kernel's bytes and operations per call.

Frozen copies, kept here so that no change to the program moves them:
the operations follow ``repro_torch/roofline/analysis.py::model_flops``
(2 x active parameters per token) and its attention term (4 x context x
heads x head_dim per token and layer), with two corrections for serving:
the embedding lookup is no product, and a prefill computes logits at its
last position only.  The kernels' bytes follow ``chip_smoke.py::bound``:
each input byte read once, each output byte written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet (dense, no sparsity), at 700 W
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12


def layer_params(m: dict, i: int) -> int:
    """Active parameters of layer ``i`` outside the norms."""
    d = m["d_model"]
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    attn = d * H * hd * 2 + 2 * d * K * hd
    E = m.get("num_experts", 0)
    if not E or (i == 0 and m.get("first_layer_dense", False)):
        ff = m["dense_d_ff"] if (E and m.get("dense_d_ff")) else m["d_ff"]
        return attn + 3 * d * ff
    active = m["experts_per_token"] + m.get("num_shared_experts", 0)
    return attn + active * 3 * d * m["d_ff"] + d * E


def token_flops(m: dict, context: int) -> float:
    """Operations of one token through every layer, attending over
    ``context`` positions (itself included), without the logits."""
    body = sum(layer_params(m, i) for i in range(m["num_layers"]))
    attn = 4.0 * context * m["num_heads"] * m["head_dim"] * m["num_layers"]
    return 2.0 * body + attn


def logits_flops(m: dict) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def prefill_flops(m: dict, start: int, n: int) -> float:
    """A prefill of ``n`` tokens at positions ``start`` .. ``start + n -
    1`` (after ``start`` restored prefix tokens), with its last logits."""
    body = 2.0 * sum(layer_params(m, i) for i in range(m["num_layers"])) * n
    # sum of contexts start + 1 .. start + n
    ctx = n * start + n * (n + 1) / 2.0
    attn = 4.0 * ctx * m["num_heads"] * m["head_dim"] * m["num_layers"]
    return body + attn + logits_flops(m)


def decode_flops(m: dict, context: int) -> float:
    return token_flops(m, context) + logits_flops(m)


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the operations over the fp32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S)


def paged_attention_bound_s(m: dict, contexts, page_size: int) -> float:
    """One ``paged_attention`` call over a decode batch with ``contexts``
    (fp32 pages): K and V of every context token, q in, out written, the
    block tables and lengths."""
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    B, ctx = len(contexts), sum(contexts)
    n_bytes = (2 * ctx * K * hd * 4 + 2 * B * H * hd * 4
               + 4 * sum(-(-n // page_size) for n in contexts) + 4 * B)
    return bound_s(n_bytes, 4 * ctx * H * hd + 5 * ctx * H)


def kv_restore_bound_s(m: dict, n_layers: int, n_tokens: int) -> float:
    """One ``kv_restore_layers`` launch: uint8 frames read, fp32 rows
    written, scales and slots read."""
    K, hd = m["num_kv_heads"], m["head_dim"]
    G, n = n_layers, n_tokens
    n_bytes = G * n * K * hd * (1 + 4) + G * K * 4 + n * 4
    return bound_s(n_bytes, 2 * G * n * K * hd)
