"""Model/config system: ModelConfig dataclass, registry, smoke reduction.

Every architecture registers a ``ModelConfig`` here via its own module in
``repro_torch.configs``; the registry is the single source of truth for
``--arch <id>`` selection in launchers, benchmarks and tests.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned, fixed)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description, sufficient to build params + step fns."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str  # citation (arXiv id / hf model card)

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention behaviour
    is_encoder: bool = False  # bidirectional, no decode path
    sliding_window: int = 0  # 0 = full attention
    qkv_bias: bool = False
    rope_theta: float = 1.0e6

    # mlp behaviour
    mlp_kind: str = "swiglu"  # swiglu | squared_relu | gelu

    # MoE
    num_experts: int = 0  # routed experts (0 = dense MLP)
    num_shared_experts: int = 0
    experts_per_token: int = 0
    first_layer_dense: bool = False  # deepseek-moe: layer 0 is dense
    dense_d_ff: int = 0  # d_ff of that dense layer (0 -> d_ff)
    moe_capacity_factor: float = 1.25  # expert capacity = s*k*cf/E
    # routing as DeepSeek's config.json names it: True renormalises the
    # top-k softmax weights to sum to 1 (the JAX package always does)
    norm_topk_prob: bool = True
    # no capacity on the serving path (serving/paged_model.py): every
    # (token, expert) choice is computed; training keeps capacity routing
    moe_dropless: bool = False

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1

    # hybrid layer pattern, cycled over num_layers. entries: attn|rglru|ssm
    layer_pattern: Tuple[str, ...] = ("attn",)
    # local attention window for hybrid local-attn layers (recurrentgemma)
    local_window: int = 0
    rglru_width: int = 0  # 0 -> d_model

    # modality frontend (stubbed; input_specs provides embeddings)
    frontend: str = "none"  # none | audio | vision
    num_patch_tokens: int = 0  # vision: patches prepended to text

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind, pattern cycled to num_layers."""
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def sub_quadratic(self) -> bool:
        """True if decode at 500k context holds O(window/state) memory."""
        kinds = set(self.layer_kinds())
        if kinds <= {"ssm", "rglru"}:
            return True
        if "attn" in kinds:
            # all attention layers must be windowed
            window = self.sliding_window or self.local_window
            return window > 0
        return True

    def shape_supported(self, shape: InputShape) -> Tuple[bool, str]:
        """(supported, reason-if-not) for an (arch, input-shape) pair."""
        if shape.kind == "decode" and self.is_encoder:
            return False, "encoder-only: no autoregressive decode"
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, "full attention: no sub-quadratic 500k decode path"
        return True, ""

    # approx parameter count (for roofline MODEL_FLOPS)
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.layer_kinds():
            if kind == "attn":
                q = d * self.num_heads * self.head_dim
                kv = 2 * d * self.num_kv_heads * self.head_dim
                o = self.num_heads * self.head_dim * d
                total += q + kv + o
            elif kind == "rglru":
                w = self.rglru_width or d
                total += 2 * d * w + w * d + 3 * w * w + 2 * w  # branches+gates
            elif kind == "ssm":
                din = self.d_inner
                proj_in = d * (2 * din + 2 * self.ssm_ngroups * self.ssm_state
                               + self.ssm_nheads)
                total += proj_in + din * d + self.ssm_conv * (
                    din + 2 * self.ssm_ngroups * self.ssm_state)
            # mlp
            if kind in ("attn", "rglru"):
                mult = 3 if self.mlp_kind == "swiglu" else 2
                if self.num_experts:
                    n_e = (self.experts_per_token + self.num_shared_experts
                           if active_only else
                           self.num_experts + self.num_shared_experts)
                    total += n_e * mult * d * self.d_ff
                    total += d * self.num_experts  # router
                else:
                    total += mult * d * self.d_ff
        return total

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Raw KV cache bytes/token (the quantity the codec compresses)."""
        per_layer = 2 * self.num_kv_heads * self.head_dim * dtype_bytes
        n_attn = sum(1 for k in self.layer_kinds() if k == "attn")
        return per_layer * n_attn


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _validate(cfg)
    _REGISTRY[cfg.name] = cfg
    return cfg


def _validate(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds())
    if "attn" in kinds:
        assert cfg.num_heads > 0 and cfg.head_dim > 0, cfg.name
        assert cfg.num_heads % max(cfg.num_kv_heads, 1) == 0, cfg.name
    if "ssm" in kinds:
        assert cfg.ssm_state > 0 and cfg.d_inner % cfg.ssm_head_dim == 0
    if cfg.num_experts:
        assert cfg.experts_per_token > 0
    assert cfg.vocab_size > 0 and cfg.num_layers > 0 and cfg.d_model > 0


def jax_routing(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` routed as the JAX package routes: top-k weights
    renormalised and each routing group's capacity dropping choices on
    every path.  The tests that hold the port to the JAX package pass it."""
    return dataclasses.replace(cfg, norm_topk_prob=True, moe_dropless=False)


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


ASSIGNED_ARCHS = (
    "hubert-xlarge",
    "nemotron-4-340b",
    "h2o-danube-3-4b",
    "llava-next-mistral-7b",
    "deepseek-moe-16b",
    "yi-9b",
    "mamba2-2.7b",
    "mixtral-8x22b",
    "recurrentgemma-9b",
    "qwen1.5-110b",
)

PAPER_ARCHS = ("lwm-7b", "yi-34b", "llama3-70b")

_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import every sibling module so registration side-effects run
    from repro_torch.configs import (  # noqa: F401
        hubert_xlarge, nemotron_4_340b, h2o_danube_3_4b,
        llava_next_mistral_7b, deepseek_moe_16b, yi_9b, mamba2_2p7b,
        mixtral_8x22b, recurrentgemma_9b, qwen1p5_110b, paper_models,
    )


# ---------------------------------------------------------------------------
# Smoke reduction — same family, tiny dims (2 layers, d_model<=512, <=4 exp)
# ---------------------------------------------------------------------------


def reduce_config(cfg: ModelConfig, *, d_model: int = 256,
                  num_layers: int = 2, vocab: int = 512) -> ModelConfig:
    """Reduced variant of the same architecture family for CPU smoke tests."""
    changes: Dict[str, object] = dict(
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=min(d_model, 512),
        vocab_size=min(cfg.vocab_size, vocab),
    )
    if cfg.num_heads:
        heads = max(4, min(8, cfg.num_heads))
        kv = max(1, heads // max(cfg.q_per_kv, 1))
        # keep the GQA ratio when possible
        while heads % kv:
            kv -= 1
        changes.update(num_heads=heads, num_kv_heads=kv,
                       head_dim=changes["d_model"] // heads)  # type: ignore
    if cfg.d_ff:
        changes["d_ff"] = 2 * int(changes["d_model"])  # type: ignore
    if cfg.dense_d_ff:
        changes["dense_d_ff"] = 2 * int(changes["d_model"])  # type: ignore
    if cfg.num_experts:
        # capacity_factor = E makes capacity >= s*k: no token dropping, so
        # smoke tests can check prefill/decode against the full forward.
        changes.update(num_experts=4,
                       experts_per_token=min(2, cfg.experts_per_token),
                       num_shared_experts=min(1, cfg.num_shared_experts),
                       moe_capacity_factor=4.0)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=32)
    if cfg.rglru_width:
        changes["rglru_width"] = int(changes["d_model"])  # type: ignore
    if cfg.sliding_window:
        changes["sliding_window"] = 64
    if cfg.local_window:
        changes["local_window"] = 64
    if cfg.num_patch_tokens:
        changes["num_patch_tokens"] = 16
    # hybrid pattern: keep every distinct layer kind represented
    if len(cfg.layer_pattern) > 1 and num_layers < len(cfg.layer_pattern):
        uniq = tuple(dict.fromkeys(cfg.layer_pattern))
        changes["layer_pattern"] = uniq[:num_layers]
    return dataclasses.replace(cfg, **changes)  # type: ignore[arg-type]
