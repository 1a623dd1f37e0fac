"""The port's dense model math and parameter bridge, held against the JAX
package at fp32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as jax_attention  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving.paged_model import _layer_params  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models import attention, common, mlp  # noqa: E402
from repro_torch.models.transformer import lm_logits  # noqa: E402
from repro_torch.params import from_numpy, init_params, layer_params  # noqa: E402

RTOL = 1e-5


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=atol)


def _rng(seed):
    return np.random.default_rng(seed)


def test_rms_norm_matches():
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("theta", [1.0e6, 1.0e4, 0.0])
def test_apply_rope_matches(theta):
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
           jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_apply_mlp_matches(kind):
    rng = _rng(2)
    d, ff = 32, 48
    wi_shape = (d, 2, ff) if kind == "swiglu" else (d, ff)
    p = {"wi": (rng.standard_normal(wi_shape) / np.sqrt(d)).astype(
        np.float32),
         "wo": (rng.standard_normal((ff, d)) / np.sqrt(ff)).astype(
        np.float32)}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    _close(mlp.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), kind),
           jax_mlp.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind))


# q positions, k positions, causal, window, threshold: the threshold
# drives each branch at small size (naive, blocked, blocked+windowed)
ATTEND_CASES = {
    "naive_gqa": (0, 0, 24, True, 0, 2048),
    "naive_suffix": (40, 0, 8, True, 0, 2048),  # suffix queries at n_pre
    "naive_window": (0, 0, 24, True, 6, 2048),
    "blocked_gqa": (0, 0, 24, True, 0, 8),
    "blocked_suffix": (40, 0, 8, True, 0, 8),
    "blocked_bidirectional": (0, 0, 24, False, 0, 8),
    "blocked_windowed": (0, 0, 24, True, 6, 8),
}


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_attend_branches_match(case):
    n_pre, k0, s, causal, window, thr = ATTEND_CASES[case]
    rng = _rng(len(case))
    b, H, K, hd = 2, 8, 2, 16
    S = n_pre + s
    q = rng.standard_normal((b, s, H, hd)).astype(np.float32)
    k = rng.standard_normal((b, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((b, S, K, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(n_pre, S, dtype=np.int32), (b, s))
    kpos = np.broadcast_to(np.arange(k0, k0 + S, dtype=np.int32), (b, S))
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, k, v, qpos, kpos)]
    got = attention.attend(*t, causal=causal, window=window,
                           blocked_threshold=thr)
    want = jax_attention.attend(*(jnp.asarray(a) for a in (q, k, v, qpos,
                                                            kpos)),
                                causal=causal, window=window,
                                blocked_threshold=thr)
    _close(got, want)


@pytest.mark.parametrize("tied", [False, True])
def test_lm_logits_matches(tied):
    rng = _rng(3)
    d, V = 32, 40
    cfg = reduce_config(get_config("lwm-7b"), d_model=d)
    cfg = dataclasses.replace(cfg, tie_embeddings=tied, vocab_size=V)
    params = {"embed": rng.standard_normal((V, d)).astype(np.float32),
              "final_norm": (0.1 * rng.standard_normal(d)).astype(
                  np.float32)}
    if not tied:
        params["lm_head"] = rng.standard_normal((d, V)).astype(np.float32)
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    _close(lm_logits({k: torch.from_numpy(v) for k, v in params.items()},
                     cfg, torch.from_numpy(x)),
           jax_tf.lm_logits({k: jnp.asarray(v) for k, v in params.items()},
                            cfg, jnp.asarray(x)))


def test_param_bridge_round_trips_bit_equal(tiny_cfg, tiny_params):
    tree = jax.tree.map(np.asarray, tiny_params)
    params = from_numpy(tree, tiny_cfg, device="cpu")
    assert len(params["layers"]) == tiny_cfg.num_layers
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(params[name].numpy(), tree[name])
    for i in range(tiny_cfg.num_layers):
        want = jax.tree.map(np.asarray, _layer_params(tiny_params, tiny_cfg,
                                                      i))
        got = layer_params(params, tiny_cfg, i)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat_w) == len(jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), got)))
        for path, leaf in flat_w:
            node = got
            for key in path:
                node = node[key.key]
            assert node.dtype == torch.float32
            np.testing.assert_array_equal(node.numpy(), leaf)


def test_init_params_shapes_and_distributions(tiny_cfg, tiny_params):
    gen = torch.Generator().manual_seed(0)
    params = init_params(tiny_cfg, gen, device="cpu")
    ref = from_numpy(jax.tree.map(np.asarray, tiny_params), tiny_cfg,
                     device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), params))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), ref)))
    assert len(flat) == len(flat_ref)
    for path, leaf in flat:
        want = flat_ref[path]
        assert leaf.shape == want.shape and leaf.dtype == want.dtype
        # same law: zero norms stay zero, std within a few percent
        assert np.isclose(leaf.std(), want.std(), rtol=0.1, atol=1e-6), path
    again = init_params(tiny_cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    assert torch.equal(again["layers"][1]["attn"]["wq"],
                       params["layers"][1]["attn"]["wq"])
