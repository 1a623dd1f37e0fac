"""The port's ``prefill`` + ``decode_step`` against the JAX package for
every reduced decoder of ``ASSIGNED_ARCHS`` (and the deeper cuts of
tests/test_torch_zoo_archs.py), from bridged weights on the CPU: a
72-token prompt overflows the reduced 64-token windows, so sliding-window
and local-attention layers fill their ring caches in slots pos % 64, and
decode wraps the ring further.  Logits and the caches after prefill
within 2e-4 (fp32 on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as jax_tf  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

from test_torch_zoo_archs import (  # noqa: E402
    ARCH_CASES, B, _close, _inputs, _j, _jax_layers, _model, _t)

#: prompt and decode lengths: the prompt overflows the reduced windows
#: (64), and decode wraps the ring further
N_PROMPT, N_DECODE = 72, 4
DECODERS = [c for c in ARCH_CASES
            if configs.get_config(c[0]).supports_decode]


def _jax_cache_layers(cache, cfg):
    """The JAX cache tree as the port's per-layer list."""
    return _jax_layers(jax.tree.map(np.asarray, cache), cfg)


@pytest.mark.parametrize("arch,layers", DECODERS)
def test_prefill_and_decode_match_jax(arch, layers):
    cfg, jcfg, jp, params = _model(arch, layers)
    tokens, embeds, _ = _inputs(cfg, 2, N_PROMPT + N_DECODE)
    n_emb = 0 if embeds is None else embeds.shape[1]
    total = n_emb + N_PROMPT + N_DECODE
    cache = tf.init_cache(cfg, B, total, device="cpu")
    cache_j = jax_tf.init_cache(jcfg, B, total)
    window = cfg.sliding_window or cfg.local_window
    caps = {c["k"].shape[1] for c, kind in zip(cache, tf.stack_kinds(cfg))
            if kind == "attn"}
    # a ring shorter than the prompt where the config has a window
    assert caps <= {window or total} and (not window or window < N_PROMPT)

    logits, cache = tf.prefill(params, cfg, tokens=_t(tokens[:, :N_PROMPT]),
                               embeds=_t(embeds), cache=cache)
    want, cache_j = jax_tf.prefill(jp, jcfg, tokens=_j(tokens[:, :N_PROMPT]),
                                   embeds=_j(embeds), cache=cache_j)
    _close(logits, want, 2e-4)
    for got, ref in zip(cache, _jax_cache_layers(cache_j, cfg)):
        assert sorted(got) == sorted(ref)
        for name in got:
            _close(got[name], ref[name], 2e-4)

    step = jax.jit(lambda p, t, pos, c: jax_tf.decode_step(p, jcfg, t, pos,
                                                            c))
    for i in range(N_PROMPT, N_PROMPT + N_DECODE):
        pos = n_emb + i
        logits, cache = tf.decode_step(params, cfg, _t(tokens[:, i]), pos,
                                       cache)
        want, cache_j = step(jp, jnp.asarray(tokens[:, i]), jnp.int32(pos),
                             cache_j)
        _close(logits, want, 2e-4)


def test_snapshot_names_need_whole_cycles():
    cfg, _, _, _ = _model("deepseek-moe-16b", 2)
    cache = tf.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="whole cycles"):
        tf.snapshot_states(cache, cfg)
