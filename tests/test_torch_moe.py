"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's on the CPU, from the same weights and inputs: the routing (the
selected experts equal, ties broken toward the lower index as
``jax.lax.top_k`` does), the routing tables, the outputs within 1e-5 and
the aux loss within 1e-6.  Both grouping forms are held: b groups of s
tokens ([b, s, d], the prefill and the paged decode) and one group of
the batch ([1, b, d], ``transformer.decode_step``); at the reduced
``capacity_factor`` of 4 (nothing dropped) and at ones that drop
choices, as deepseek's 1.25 does at full width."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402

#: (name, arch, changes to its reduced config): the two reduced MoE
#: archs; deepseek's full-width routing (64 experts, top 6, 2 shared) at
#: a narrow width; and the two other expert MLP kinds
MOE_CASES = [
    ("deepseek reduced", "deepseek-moe-16b", {}),
    ("mixtral reduced", "mixtral-8x22b", {}),
    ("deepseek routing", "deepseek-moe-16b",
     dict(num_experts=64, experts_per_token=6, num_shared_experts=2,
          moe_capacity_factor=1.25, d_model=64, d_ff=32)),
    ("squared_relu experts", "mixtral-8x22b",
     dict(mlp_kind="squared_relu")),
    ("gelu experts", "mixtral-8x22b", dict(mlp_kind="gelu")),
]
#: (b, s) of the inputs: a prefill of 3 groups, the paged decode of 3
#: sequences (3 groups of one token), the suffix prefill's one group of 16
SHAPES = [(3, 24), (3, 1), (1, 16)]


def _cfgs(arch, changes):
    return (dataclasses.replace(
                configs.reduce_config(configs.get_config(arch)), **changes),
            dataclasses.replace(
                jax_configs.reduce_config(jax_configs.get_config(arch)),
                **changes))


def _weights(jcfg, seed):
    jp = jax_moe.init_moe(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jp)
    port = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    return jp, port


def _x(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)


def _jax_route(jp, x, k):
    logits = jnp.einsum("bsd,de->bse", x, jp["router"],
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    topw, tope = jax.lax.top_k(probs, k)
    return probs, topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9), tope


@pytest.mark.parametrize("cf", [0.0, 0.5])
@pytest.mark.parametrize("b,s", SHAPES)
@pytest.mark.parametrize("name,arch,changes", MOE_CASES)
def test_apply_moe_matches_jax(name, arch, changes, b, s, cf):
    cfg, jcfg = _cfgs(arch, changes)
    jp, port = _weights(jcfg, len(name))
    x = _x(cfg, (b, s), b * 100 + s)
    probs, topw, tope = moe.route(port, torch.from_numpy(x), cfg)
    p_j, w_j, e_j = _jax_route(jp, jnp.asarray(x), cfg.experts_per_token)
    np.testing.assert_array_equal(tope.numpy(), np.asarray(e_j))
    np.testing.assert_allclose(probs.numpy(), np.asarray(p_j), atol=1e-6)
    np.testing.assert_allclose(topw.numpy(), np.asarray(w_j), atol=1e-6)

    E, k = cfg.num_experts, cfg.experts_per_token
    cap = max(1, int(s * k * (cf or cfg.moe_capacity_factor) / E))
    tables, wtabs = moe._route_tables(tope, topw, s, E, cap, torch.float32)
    t_j, wt_j = jax.vmap(lambda te, tw: jax_moe._route_tables(
        te, tw, s, E, cap, jnp.float32))(e_j, w_j)
    np.testing.assert_array_equal(tables.numpy(), np.asarray(t_j))
    np.testing.assert_allclose(wtabs.numpy(), np.asarray(wt_j), atol=1e-6)

    out, aux = moe.apply_moe(port, torch.from_numpy(x), cfg,
                             capacity_factor=cf)
    want, aux_j = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg,
                                    capacity_factor=cf)
    assert out.shape == (b, s, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(aux_j)) <= 1e-6


@pytest.mark.parametrize("name,arch,changes", MOE_CASES[:3])
def test_batch_as_one_group_matches_jax(name, arch, changes):
    """``transformer.decode_step``'s form: the batch's tokens route as one
    group [1, b, d], so they share each expert's capacity."""
    cfg, jcfg = _cfgs(arch, changes)
    jp, port = _weights(jcfg, 7)
    x = _x(cfg, (5, 1), 11).reshape(1, 5, cfg.d_model)
    out, aux = moe.apply_moe(port, torch.from_numpy(x), cfg)
    want, aux_j = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(aux_j)) <= 1e-6


def test_capacity_drops_the_overflowing_choices():
    """At the suffix prefill's group of 16 under deepseek's routing, cap is
    max(1, int(16 * 6 * 1.25 / 64)) = 1: each expert keeps its first
    (token, choice) in token-major order and the rest add nothing."""
    cfg, jcfg = _cfgs(*MOE_CASES[2][1:])
    jp, port = _weights(jcfg, 3)
    x = torch.from_numpy(_x(cfg, (1, 16), 5))
    del port["shared"]
    out, _ = moe.apply_moe(port, x, cfg)
    _, topw, tope = moe.route(port, x, cfg)
    seen, w = set(), torch.zeros(16, cfg.experts_per_token)
    for t in range(16):
        for c in range(cfg.experts_per_token):
            e = int(tope[0, t, c])
            if e not in seen:
                seen.add(e)
                w[t, c] = topw[0, t, c]
    assert 0 < int((w > 0).sum()) < 16 * cfg.experts_per_token
    h = x[0]
    want = torch.zeros_like(h)
    for t in range(16):
        for c in range(cfg.experts_per_token):
            if w[t, c] > 0:
                e = int(tope[0, t, c])
                a = h[t] @ port["wi"][e, :, 0]
                g = h[t] @ port["wi"][e, :, 1]
                want[t] += w[t, c] * (torch.nn.functional.silu(a) * g
                                      ) @ port["wo"][e]
    np.testing.assert_allclose(out[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ties_go_to_the_lower_expert():
    """Equal router columns give equal probabilities; the lower expert id
    wins, as in ``jax.lax.top_k``."""
    cfg, jcfg = _cfgs("deepseek-moe-16b", MOE_CASES[2][2])
    jp, port = _weights(jcfg, 9)
    router = np.asarray(jp["router"]).copy()
    # nine equal columns, 8 and 40..47, made the largest for positive x
    router[:, 8] = 4.0 * np.abs(router[:, 8])
    router[:, 40:48] = router[:, 8:9]
    jp = dict(jp, router=jnp.asarray(router))
    port = dict(port, router=torch.from_numpy(router))
    x = np.abs(_x(cfg, (2, 8), 1))
    _, _, tope = moe.route(port, torch.from_numpy(x), cfg)
    _, _, e_j = _jax_route(jp, jnp.asarray(x), cfg.experts_per_token)
    np.testing.assert_array_equal(tope.numpy(), np.asarray(e_j))
    assert (np.sort(tope.numpy(), axis=-1) == [8, 40, 41, 42, 43, 44]).all()


def test_expert_weights_are_read_in_place(monkeypatch):
    """SwiGLU's ``wi`` [E, d, 2, ff] reaches the product as a view: no
    copy of the expert weights per call."""
    cfg, jcfg = _cfgs(*MOE_CASES[2][1:])
    _, port = _weights(jcfg, 2)
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(b)
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    moe._expert_ffn(port, torch.zeros(3, cfg.num_experts, 1, cfg.d_model),
                    "swiglu")
    assert seen[0].data_ptr() == port["wi"].data_ptr()
    assert seen[1].data_ptr() == port["wo"].data_ptr()
