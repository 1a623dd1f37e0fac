"""The port's model zoo against the JAX package, arch by arch, on the CPU:
the 13 configs and the config helpers, the weight bridge (prefix, cycles,
rest, learned positions, the encoder's mask embedding), ``init_params``'
shapes and laws, and ``forward_full`` / ``prefill`` + ``decode_step`` of
every reduced ``ASSIGNED_ARCH`` from bridged weights (``prefill`` +
``decode_step``: tests/test_torch_zoo_decode.py).  Tolerances: logits
within 2e-4, the MoE aux loss within 1e-5 (fp32 on both sides)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.params import from_numpy, init_params  # noqa: E402

B = 2
#: (arch, layers) of the model twins: every assigned arch reduced to 2
#: layers, and two deeper cuts for the stack's other parts: a hybrid with
#: remainder layers after one cycle, and deepseek's dense first layer
#: before three cycles
ARCH_CASES = [(a, 2) for a in configs.ASSIGNED_ARCHS] + [
    ("recurrentgemma-9b", 5), ("deepseek-moe-16b", 4)]


def _cfgs(arch, layers):
    """The port's reduced config, routed as the JAX package routes, and
    the JAX package's."""
    return (configs.jax_routing(configs.reduce_config(
                configs.get_config(arch), num_layers=layers)),
            jax_configs.reduce_config(jax_configs.get_config(arch),
                                      num_layers=layers))


_MODELS = {}


def _model(arch, layers):
    """(cfg, JAX params, the port's bridged params), built once per case."""
    if (arch, layers) not in _MODELS:
        cfg, jcfg = _cfgs(arch, layers)
        seed = configs.ASSIGNED_ARCHS.index(arch) + 10 * layers
        jp = jax_tf.init_params(jcfg, jax.random.PRNGKey(seed))
        _MODELS[arch, layers] = (cfg, jcfg, jp, from_numpy(
            jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return _MODELS[arch, layers]


def _inputs(cfg, seed, n_text):
    """(tokens, embeds, mask_positions) as numpy, per the frontend."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, n_text))
    if cfg.frontend == "vision":
        embeds = (rng.standard_normal((B, cfg.num_patch_tokens, cfg.d_model))
                  * 0.02).astype(np.float32)
        return tokens, embeds, None
    if cfg.frontend == "audio":
        embeds = (rng.standard_normal((B, n_text, cfg.d_model))
                  * 0.02).astype(np.float32)
        return None, embeds, rng.random((B, n_text)) < 0.2
    return tokens, None, None


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, want, tol):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# -- configs ------------------------------------------------------------------

def test_registry_matches_jax():
    assert configs.list_configs() == jax_configs.list_configs()
    assert len(configs.list_configs()) == 13
    assert configs.ASSIGNED_ARCHS == jax_configs.ASSIGNED_ARCHS
    assert configs.PAPER_ARCHS == jax_configs.PAPER_ARCHS
    assert {k: dataclasses.asdict(v)
            for k, v in configs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v)
         for k, v in jax_configs.INPUT_SHAPES.items()}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", jax_configs.list_configs())
def test_config_matches_jax(arch, reduced):
    cfg, ref = configs.get_config(arch), jax_configs.get_config(arch)
    if reduced:
        cfg, ref = configs.reduce_config(cfg), jax_configs.reduce_config(ref)
    # the port's routing fields, which the JAX package does not have: the
    # published routing for deepseek, the JAX package's for the rest
    ours = dataclasses.asdict(cfg)
    routing = (ours.pop("norm_topk_prob"), ours.pop("moe_dropless"))
    assert routing == ((False, True) if arch == "deepseek-moe-16b"
                       else (True, False))
    assert ours == dataclasses.asdict(ref)
    for active in (False, True):
        assert cfg.param_count(active) == ref.param_count(active)
    assert cfg.kv_bytes_per_token() == ref.kv_bytes_per_token()
    assert cfg.sub_quadratic == ref.sub_quadratic
    assert cfg.layer_kinds() == ref.layer_kinds()
    for name, shape in configs.INPUT_SHAPES.items():
        assert cfg.shape_supported(shape) == ref.shape_supported(
            jax_configs.INPUT_SHAPES[name])


# -- weights ------------------------------------------------------------------

def _jax_layers(tree, cfg):
    """The JAX tree's layers as a list in the port's order: prefix,
    cycles (cycle-major), rest."""
    layers = list(tree["prefix"])
    if tree["cycles"] is not None:
        n = len(jax.tree.leaves(tree["cycles"])[0])
        for c in range(n):
            layers.extend(jax.tree.map(lambda x: x[c],
                                       tree["cycles"][f"l{j}"])
                          for j in range(len(cfg.layer_pattern)))
    return layers + list(tree["rest"])


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy() if hasattr(t, "numpy") else t,
                     tree))


@pytest.mark.parametrize("arch,layers", ARCH_CASES)
def test_param_bridge_bit_equal(arch, layers):
    cfg, jcfg, jp, params = _model(arch, layers)
    tree = jax.tree.map(np.asarray, jp)
    assert tf.layer_plan(cfg) == jax_tf.layer_plan(jcfg)
    top = sorted(k for k in tree if k not in ("prefix", "cycles", "rest"))
    assert sorted(k for k in params if k != "layers") == top
    assert ("pos_embed" in top) == (cfg.rope_theta <= 0)
    assert ("mask_embed" in top) == cfg.is_encoder
    for name in top:
        np.testing.assert_array_equal(params[name].numpy(), tree[name])
    want_layers = _jax_layers(tree, cfg)
    assert len(params["layers"]) == len(want_layers) == cfg.num_layers
    for got, want in zip(params["layers"], want_layers):
        g, w = _leaves(got), _leaves(want)
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,layers", ARCH_CASES)
def test_init_params_shapes_and_distributions(arch, layers):
    cfg, _, _, bridged = _model(arch, layers)
    mine = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = _leaves(mine)
    want = dict(_leaves(bridged))
    assert len(flat) == len(want)
    for path, leaf in flat:
        ref = want[path]
        assert leaf.shape == ref.shape and leaf.dtype == ref.dtype, path
        # same law: constant leaves equal, spread within a few percent
        if ref.std() == 0:
            np.testing.assert_array_equal(leaf, ref)
        else:
            assert np.isclose(leaf.std(), ref.std(), rtol=0.15), path
            assert abs(leaf.mean()) < 4 * ref.std() / np.sqrt(ref.size) \
                + 1e-3, path


def test_init_params_full_width_count():
    """deepseek-moe-16b's full-width tree, counted from shapes alone
    (``jax.eval_shape``), equals what the port's init draws."""
    cfg = configs.get_config("deepseek-moe-16b")
    shapes = jax.eval_shape(
        lambda k: jax_tf.init_params(
            jax_configs.get_config("deepseek-moe-16b"), k),
        jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert n_jax == 16_375_728_128
    meta = init_params(cfg, None, device="meta")
    n_port = sum(t.numel() for _, t in jax.tree_util.tree_leaves_with_path(
        meta))
    assert n_port == n_jax


# -- model twins ----------------------------------------------------------------

@pytest.mark.parametrize("arch,layers", ARCH_CASES)
def test_forward_full_matches_jax(arch, layers):
    cfg, jcfg, jp, params = _model(arch, layers)
    tokens, embeds, mask = _inputs(cfg, 1, 40)
    logits, aux = tf.forward_full(params, cfg, tokens=_t(tokens),
                                  embeds=_t(embeds), mask_positions=_t(mask))
    want, aux_j = jax_tf.forward_full(jp, jcfg, tokens=_j(tokens),
                                      embeds=_j(embeds),
                                      mask_positions=_j(mask))
    _close(logits, want, 2e-4)
    assert abs(float(aux) - float(aux_j)) <= 1e-5
    assert (float(aux) > 0) == bool(cfg.num_experts)
    # remat (a checkpoint per layer) changes neither the values nor the
    # gradients of every parameter
    leaves = [p for _, p in jax.tree_util.tree_leaves_with_path(params)]
    rng = np.random.default_rng(2)
    weight = torch.from_numpy(rng.standard_normal(tuple(logits.shape))
                              .astype(np.float32))
    out = []
    for remat in (False, True):
        for p in leaves:
            p.requires_grad_(True)
        try:
            lg, ax = tf.forward_full(params, cfg, tokens=_t(tokens),
                                     embeds=_t(embeds),
                                     mask_positions=_t(mask), remat=remat)
            grads = torch.autograd.grad((lg * weight).sum() + ax, leaves,
                                        allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        out.append((lg.detach(), ax.detach(), grads))
    (lg0, ax0, g0), (lg1, ax1, g1) = out
    assert torch.equal(lg0, logits) and torch.equal(lg1, lg0)
    assert torch.equal(ax1, ax0)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            _close(b, a.numpy(), 1e-6)
