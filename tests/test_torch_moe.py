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
    """The port's config routed as the JAX package routes
    (``configs.jax_routing``), and the JAX package's."""
    return (dataclasses.replace(configs.jax_routing(
                configs.reduce_config(configs.get_config(arch))), **changes),
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


# -- the published routing and the dropless serving layer --------------------

from repro_torch.kernels.moe_experts import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_experts import ref as moe_ref  # noqa: E402

#: deepseek's full-width routing at a narrow width, as published:
#: unnormalised top-6 weights, no capacity
PUBLISHED = dict(MOE_CASES[2][2], norm_topk_prob=False, moe_dropless=True)


def _published(seed):
    cfg = dataclasses.replace(
        configs.reduce_config(configs.get_config("deepseek-moe-16b")),
        **PUBLISHED)
    assert (cfg.norm_topk_prob, cfg.moe_dropless) == (False, True)
    _, port = _weights(dataclasses.replace(
        jax_configs.reduce_config(jax_configs.get_config("deepseek-moe-16b")),
        **MOE_CASES[2][2]), seed)
    return cfg, port


def _loop(port, x, cfg, ids, w):
    """Each token's choices, one at a time: weight x SwiGLU expert output,
    summed in choice order; no shared experts."""
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for c in range(ids.shape[1]):
            e = int(ids[t, c])
            h = torch.nn.functional.silu(x[t] @ port["wi"][e, :, 0]) \
                * (x[t] @ port["wi"][e, :, 1])
            out[t] += w[t, c] * (h @ port["wo"][e])
    return out


def test_published_weights_are_the_top_probabilities_as_they_are():
    """``norm_topk_prob`` false: a token's six weights are its six largest
    softmax probabilities, unscaled, so they sum below 1."""
    cfg, port = _published(4)
    x = torch.from_numpy(_x(cfg, (2, 9), 3))
    probs, topw, tope = moe.route(port, x, cfg)
    assert torch.equal(topw, torch.gather(probs, -1, tope))
    assert bool((topw.sum(-1) < 1.0).all())
    renorm = dataclasses.replace(cfg, norm_topk_prob=True)
    _, topw_n, tope_n = moe.route(port, x, renorm)
    assert torch.equal(tope, tope_n)
    np.testing.assert_allclose(topw_n.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_dropless_keeps_every_choice_when_every_token_picks_one_expert():
    """Every token's first choice is expert 8: the dropless layer computes
    all 16 x 6 choices, as a loop over each token's choices does, where
    capacity routing keeps one of expert 8's sixteen."""
    cfg, port = _published(5)
    del port["shared"]
    router = port["router"].clone()
    router[:, 8] = 4.0 * router[:, 8].abs()
    port = dict(port, router=router)
    x = torch.from_numpy(np.abs(_x(cfg, (1, 16), 2)))
    _, topw, tope = moe.route(port, x, cfg)
    assert bool((tope[0, :, 0] == 8).all())
    got = moe.apply_moe_dropless(port, x, cfg)
    want = _loop(port, x[0], cfg, tope[0], topw[0])
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    capped, _ = moe.apply_moe(port, x, dataclasses.replace(
        cfg, moe_dropless=False))
    assert float((capped - got).abs().max()) > 1e-3 * float(
        want.abs().max())


def test_dropless_result_is_the_same_whatever_the_grouping():
    """A prefill's tokens routed together, as sequences, one token at a
    time, or split as a reuse request splits prefix and suffix: the same
    output, up to float rounding."""
    cfg, port = _published(6)
    x = torch.from_numpy(_x(cfg, (3, 8), 9))
    whole = moe.apply_moe_dropless(port, x, cfg)
    scale = float(whole.abs().max())
    for parts in ([x.reshape(1, 24, -1)], [x.reshape(24, 1, -1)],
                  [x.reshape(1, 24, -1)[:, :17], x.reshape(1, 24, -1)[:, 17:]]):
        got = torch.cat([moe.apply_moe_dropless(port, p, cfg).reshape(-1, 64)
                         for p in parts])
        assert float((got - whole.reshape(-1, 64)).abs().max()) \
            <= 1e-6 * scale


CHOICES = {
    "random": lambda g, n, E, k: torch.stack(
        [torch.randperm(E, generator=g)[:k] for _ in range(n)]),
    "every token on expert 3": lambda g, n, E, k: torch.cat(
        [torch.full((n, 1), 3), torch.stack([
            torch.randperm(E - 1, generator=g)[:k - 1] + 4
            for _ in range(n)]) % E], 1),
    "few experts chosen": lambda g, n, E, k: torch.stack(
        [torch.randperm(k + 1, generator=g)[:k] * 7 for _ in range(n)]),
}


@pytest.mark.parametrize("n", [1, 3, 40])
@pytest.mark.parametrize("kind", sorted(CHOICES))
def test_grouped_plain_path_matches_a_per_expert_loop(kind, n):
    """The kernel's data flow on the CPU (counting sort, row tiles of each
    variant's size, gate-up over sorted rows, down written at each
    choice's row, the combine) against the plain loop over the chosen
    experts, and that against each token's choices one at a time."""
    g = torch.Generator().manual_seed(n)
    E, k, d, ff = 64, 6, 32, 16
    ids = CHOICES[kind](g, n, E, k)
    assert all(len(set(r.tolist())) == k for r in ids)
    x = torch.randn(n, d, generator=g)
    w = torch.rand(n, k, generator=g) / k
    wi = torch.randn(E, d, 2, ff, generator=g) / d ** 0.5
    wo = torch.randn(E, ff, d, generator=g) / ff ** 0.5
    want, used = moe_ref.moe_experts_ref(x, ids, w, wi, wo)
    assert int(used) == len(torch.unique(ids))
    port = {"wi": wi, "wo": wo}
    np.testing.assert_allclose(want.numpy(),
                               _loop(port, x, None, ids, w).numpy(),
                               rtol=1e-5, atol=1e-6)
    for _, bm in moe_ops.VARIANTS:
        got = moe_ref.moe_experts_grouped_ref(x, ids, w, wi, wo, bm)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
    out, count = moe_ops.moe_experts(x, ids, w, wi, wo)
    assert torch.equal(out, want) and count.tolist() == [int(used)]


@pytest.mark.parametrize("seed", range(6))
def test_counting_sort_tiles_only_the_chosen_experts(seed):
    """The sort is stable by expert; each tile holds at most bm rows of
    one expert; an expert with no choice has no tile; the tiles fit the
    host's bound that sizes the kernels' grid."""
    g = torch.Generator().manual_seed(seed)
    E, k = 64, 6
    n = int(torch.randint(1, 300, (1,), generator=g))
    ids = torch.stack([torch.randperm(E, generator=g)[:k]
                       for _ in range(n)]) % (8 + 7 * seed)
    flat = ids.reshape(-1)
    for _, bm in moe_ops.VARIANTS:
        s = moe_ref.moe_sort_ref(ids, E, bm)
        assert torch.equal(flat[s.order], torch.sort(flat).values)
        for e in range(E):
            mine = s.order[s.offsets[e]:s.offsets[e + 1]]
            assert bool((mine[1:] > mine[:-1]).all())  # stable
        assert set(s.tile_e.tolist()) == set(flat.tolist())
        assert s.used == len(set(flat.tolist()))
        ends = s.offsets[s.tile_e + 1]
        assert bool((s.tile_r < ends).all())
        assert bool((torch.minimum(s.tile_r + bm, ends) - s.tile_r
                     <= bm).all())
        assert len(s.tile_e) <= moe_ref.max_tiles(n * k, E, bm)


def test_variant_follows_the_choices_per_expert():
    assert moe_ops.plan(6, 64) == (0, 8)  # batch-1 decode
    assert moe_ops.plan(6 * 170, 64) == (0, 8)
    assert moe_ops.plan(6 * 256, 64) == (1, 32)  # a 256-token suffix
    assert moe_ops.plan(6 * 1024, 64) == (2, 64)  # a 1,024-token prefill
