"""The port's model zoo entry points for Mamba2: configs, weights,
``forward_full``, ``prefill`` and ``decode_step`` of the reduced
mamba2-2.7b held against the JAX package at fp32 on the CPU (the other
archs: tests/test_torch_zoo_archs.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.params import from_numpy, init_params  # noqa: E402

CFG = reduce_config(get_config("mamba2-2.7b"))
JAX_CFG = jax_reduce_config(jax_get_config("mamba2-2.7b"))
B, S = 2, 32


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(JAX_CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return from_numpy(jax.tree.map(np.asarray, jax_params), CFG,
                      device="cpu")


def _tokens(seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("reduced", [False, True])
def test_mamba2_config_matches(reduced):
    cfg, ref = get_config("mamba2-2.7b"), jax_get_config("mamba2-2.7b")
    if reduced:
        cfg, ref = reduce_config(cfg), jax_reduce_config(ref)
        assert (cfg.d_model, cfg.d_inner, cfg.ssm_nheads, cfg.ssm_state,
                cfg.num_layers, cfg.vocab_size) == (256, 512, 16, 16, 2, 512)
    # the port's MoE routing fields, at the JAX package's routing
    ours = dataclasses.asdict(cfg)
    assert (ours.pop("norm_topk_prob"), ours.pop("moe_dropless")) == (
        True, False)
    assert ours == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()


def test_param_bridge_mamba2_bit_equal(jax_params, params):
    tree = jax.tree.map(np.asarray, jax_params)
    n_prefix, n_cycles, rest = tf.layer_plan(CFG)
    assert (n_prefix, n_cycles, rest) == jax_tf.layer_plan(JAX_CFG)
    assert len(params["layers"]) == CFG.num_layers == n_cycles
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(params[name].numpy(), tree[name])
    for c, layer in enumerate(params["layers"]):
        want = jax.tree_util.tree_leaves_with_path(tree["cycles"]["l0"])
        got = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), layer))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype, path
            np.testing.assert_array_equal(g, w[c])


def test_init_params_mamba2_shapes_and_distributions(params):
    mine = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), mine))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), params)))
    assert len(flat) == len(flat_ref)
    for path, leaf in flat:
        want = flat_ref[path]
        assert leaf.shape == want.shape and leaf.dtype == want.dtype, path
        # same law: constant leaves equal, std within a few percent
        if want.std() == 0:
            np.testing.assert_array_equal(leaf, want)
        else:
            assert np.isclose(leaf.std(), want.std(), rtol=0.1), path


def test_init_cache_matches_jax(monkeypatch):
    cache = tf.init_cache(CFG, B, S, device="cpu")
    ref = jax_tf.init_cache(JAX_CFG, B, S)
    flat = tf.snapshot_states(cache, CFG)
    flat_ref = {"/".join(str(k.key) for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    assert sorted(flat) == sorted(flat_ref)
    for name, arr in flat.items():
        np.testing.assert_array_equal(arr, flat_ref[name])
    # the card unless the caller names a device, and no silent fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_cache(CFG, B, S)


def test_forward_full_matches_jax(jax_params, params):
    toks = _tokens(1)
    logits, aux = tf.forward_full(params, CFG, tokens=torch.from_numpy(toks))
    want, aux_j = jax_tf.forward_full(jax_params, JAX_CFG,
                                      tokens=jnp.asarray(toks))
    assert logits.shape == (B, S, CFG.vocab_size)
    assert float(aux) == float(aux_j) == 0.0
    _close(logits, want, 2e-4)


def test_prefill_and_decode_match_jax(jax_params, params):
    toks = _tokens(2)
    n_pre = S // 2
    logits, cache = tf.prefill(params, CFG,
                               tokens=torch.from_numpy(toks[:, :n_pre]))
    want, cache_j = jax_tf.prefill(jax_params, JAX_CFG,
                                   tokens=jnp.asarray(toks[:, :n_pre]))
    assert logits.shape == (B, 1, CFG.vocab_size)
    _close(logits, want, 2e-4)
    for i in range(n_pre, n_pre + 6):
        logits, cache = tf.decode_step(params, CFG,
                                       torch.from_numpy(toks[:, i]), i,
                                       cache)
        want, cache_j = jax_tf.decode_step(jax_params, JAX_CFG,
                                           jnp.asarray(toks[:, i]),
                                           jnp.int32(i), cache_j)
        assert logits.shape == (B, CFG.vocab_size)
        _close(logits, want, 3e-4)


def test_prefill_decode_matches_full_forward(params):
    """decode_step after prefill reproduces the full-sequence logits
    (tests/test_models_smoke.py's check, on the port alone)."""
    toks = torch.from_numpy(_tokens(3))
    full, _ = tf.forward_full(params, CFG, tokens=toks)
    n_pre = S // 2
    cache = tf.init_cache(CFG, B, S, device="cpu")
    logits, cache = tf.prefill(params, CFG, tokens=toks[:, :n_pre],
                               cache=cache)
    _close(logits[:, 0], full[:, n_pre - 1].detach(), 2e-4)
    for i in range(n_pre, S):
        logits, cache = tf.decode_step(params, CFG, toks[:, i], i, cache)
        _close(logits, full[:, i].detach(), 2e-4)
