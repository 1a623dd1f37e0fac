"""The port's training against the JAX package's, on the CPU: twins of
tests/test_training.py's five tests, the data pipeline byte-equal,
``cross_entropy`` within 1e-6, ``AdamW.update`` and the schedules within
1e-6 relative, ``loss_fn``'s loss and every gradient leaf against
``jax.value_and_grad`` (each within 2e-4 of the leaf's largest magnitude),
loss and grad norm over 5 train steps within ``STEP_RTOL`` of the JAX
``make_train_step``, and the training launcher."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import steps as jax_steps  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    ASSIGNED_ARCHS, get_config, jax_routing, reduce_config)
from repro_torch.data.pipeline import DataConfig, batches  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.loop import train  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamW, constant_schedule, cosine_schedule)
from repro_torch.training.steps import (  # noqa: E402
    TrainState, init_state, loss_fn, make_train_step, value_and_grad)
from repro_torch.tree import flatten, leaves, tree_map, unflatten  # noqa: E402

#: loss and grad norm of the port's train steps against the JAX
#: make_train_step's, from the same weights and batches: fp32 sums in
#: another order, grown through 5 Adam steps (measured: up to 6e-7)
STEP_RTOL = 2e-5


def _gen():
    return torch.Generator().manual_seed(0)


def _batch(cfg, batch_size, seq_len, seed=0):
    """One batch of the port's pipeline as CPU tensors."""
    b = next(batches(cfg, DataConfig(batch_size=batch_size, seq_len=seq_len,
                                     seed=seed)))
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _clone(state):
    return tree_map(lambda t: t.clone(), state)


# -- twins of tests/test_training.py ------------------------------------------

def test_adamw_descends_quadratic():
    opt = AdamW(lr=constant_schedule(0.1), weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.05


def test_loss_decreases_small_lm():
    cfg = reduce_config(get_config("yi-9b"), num_layers=2, d_model=128,
                        vocab=256)
    hist = train(cfg, steps=12, batch_size=4, seq_len=32, lr=2e-3,
                 log_every=0, device="cpu")
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_train_step_smoke(arch):
    """One train step per assigned architecture (reduced config): finite
    metrics, the step counted, and every parameter leaf moved."""
    cfg = reduce_config(get_config(arch))
    opt = AdamW(lr=constant_schedule(1e-3))
    state = init_state(cfg, opt, _gen(), device="cpu")
    before = [t.clone() for t in leaves(state.params)]
    step = make_train_step(cfg, opt)
    state2, metrics = step(state, _batch(cfg, 2, 32))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(state2.step) == 1
    for (path, a), b in zip(flatten(state2.params), before):
        assert not torch.equal(a, b), path


def test_grad_accum_matches_full_batch():
    cfg = reduce_config(get_config("yi-9b"), num_layers=2, d_model=64,
                        vocab=128)
    opt = AdamW(lr=constant_schedule(1e-3), grad_clip=0.0)
    state = init_state(cfg, opt, _gen(), device="cpu")
    batch = _batch(cfg, 4, 16)
    s1, m1 = make_train_step(cfg, opt, accum_steps=1)(_clone(state), batch)
    s2, m2 = make_train_step(cfg, opt, accum_steps=2)(_clone(state), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-4)
    # Adam amplifies fp32 summation-order noise to ~2*lr at sign flips of
    # near-zero grads, so params only match within that envelope.
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3, rtol=0)


def test_checkpoint_roundtrip(tmp_path):
    cfg = reduce_config(get_config("yi-9b"), num_layers=2, d_model=64,
                        vocab=128)
    opt = AdamW(lr=constant_schedule(1e-3))
    state = init_state(cfg, opt, _gen(), device="cpu")
    p = str(tmp_path / "ckpt")
    checkpoint.save(p, state.params)
    assert checkpoint.exists(p)
    like = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), state.params)
    back = checkpoint.restore(p, like)
    for a, b in zip(leaves(state.params), leaves(back)):
        assert torch.equal(a, b)
    bad = dict(state.params, final_norm=torch.zeros(3))
    with pytest.raises(ValueError, match="final_norm"):
        checkpoint.restore(p, bad)


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-9b", "llava-next-mistral-7b",
                                  "hubert-xlarge"])
def test_batches_byte_equal_to_jax(arch):
    """The three families (tokens; patch embeds; frame embeds and mask)."""
    cfg = jax_routing(reduce_config(get_config(arch)))
    jcfg = jax_configs.reduce_config(jax_configs.get_config(arch))
    mine = batches(cfg, DataConfig(batch_size=3, seq_len=40, seed=7))
    ref = jax_pipeline.batches(jcfg, jax_pipeline.DataConfig(
        batch_size=3, seq_len=40, seed=7))
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = rng.random((2, 9)) < 0.4 if masked else None
    got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                        None if mask is None else torch.as_tensor(mask))
    want = jax_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None
                                    else jnp.asarray(mask))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    if masked:  # no masked position: the mean over max(0, 1)
        none = torch.zeros(2, 9, dtype=torch.bool)
        assert float(cross_entropy(torch.as_tensor(logits),
                                   torch.as_tensor(labels), none)) == 0.0


_MODELS = {}


def _model(arch):
    """(cfg, JAX cfg, JAX params, the port's bridged params)."""
    if arch not in _MODELS:
        cfg = jax_routing(reduce_config(get_config(arch)))
        jcfg = jax_configs.reduce_config(jax_configs.get_config(arch))
        jp = jax_tf.init_params(jcfg, jax.random.PRNGKey(
            ASSIGNED_ARCHS.index(arch) + 3))
        _MODELS[arch] = (cfg, jcfg, jp, from_numpy(
            jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    return _MODELS[arch]


def _bridge(tree, cfg):
    """A JAX tree shaped as the params (grads, moments) -> the port's."""
    return from_numpy(jax.tree.map(np.asarray, tree), cfg, device="cpu")


def _leaf_close(got_tree, want_tree, tol):
    got, want = flatten(got_tree), flatten(want_tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = a.detach().numpy(), b.numpy()
        assert a.shape == b.shape, path
        err = np.abs(a - b).max() if a.size else 0.0
        assert err <= tol * np.abs(b).max(), (path, err, np.abs(b).max())


def test_adamw_update_matches_jax():
    """3 updates on equal bridged gradients (clipped: their norm is above
    1) from equal parameters: parameters and moments within 1e-6 of each
    leaf's largest magnitude; the schedules' values within 1e-6."""
    cfg, jcfg, jp, params = _model("yi-9b")
    rng = np.random.default_rng(5)
    jopt = jax_opt.AdamW(lr=jax_opt.cosine_schedule(1e-2, 2, 10))
    opt = AdamW(lr=cosine_schedule(1e-2, 2, 10))
    jstate, state = jopt.init(jp), opt.init(params)
    params = tree_map(torch.clone, params)
    for _ in range(3):
        jg = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32) * 0.1), jp)
        jp, jstate = jopt.update(jg, jstate, jp)
        params, state = opt.update(_bridge(jg, cfg), state, params)
    assert int(state.count) == int(jstate.count) == 3
    _leaf_close(params, _bridge(jp, cfg), 1e-6)
    _leaf_close(state.m, _bridge(jstate.m, cfg), 1e-6)
    _leaf_close(state.v, _bridge(jstate.v, cfg), 1e-6)
    for c in range(12):
        cnt = torch.tensor(c, dtype=torch.int32)
        for mine, ref in ((cosine_schedule(3e-4, 2, 10),
                           jax_opt.cosine_schedule(3e-4, 2, 10)),
                          (cosine_schedule(1.0, 0, 5, floor=0.0),
                           jax_opt.cosine_schedule(1.0, 0, 5, floor=0.0)),
                          (constant_schedule(0.1),
                           jax_opt.constant_schedule(0.1))):
            # equal up to the last bits of cos (two libraries' cos)
            np.testing.assert_allclose(float(mine(cnt)),
                                       float(ref(jnp.int32(c))), rtol=1e-6,
                                       atol=0, err_msg=str(c))


GRAD_ARCHS = ["yi-9b", "deepseek-moe-16b", "mamba2-2.7b", "hubert-xlarge",
              "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """loss_fn's loss and every gradient leaf (Mamba2's through the scan's
    backward, ``ssd_scan_bwd_ref`` on the CPU; deepseek's with the MoE aux
    loss) against jax.value_and_grad from the same weights and batch."""
    cfg, jcfg, jp, params = _model(arch)
    nb = next(jax_pipeline.batches(jcfg, jax_pipeline.DataConfig(
        batch_size=2, seq_len=32, seed=1)))
    (jtotal, jm), jg = jax.value_and_grad(
        lambda p: jax_steps.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                              for k, v in nb.items()}),
        has_aux=True)(jp)
    batch = {k: torch.as_tensor(v) for k, v in nb.items()}
    grads, metrics = value_and_grad(params, cfg, batch, remat=True)
    total, _ = loss_fn(params, cfg, batch)
    for got, want in ((total, jtotal), (metrics["loss"], jm["loss"]),
                      (metrics["moe_aux"], jm["moe_aux"])):
        assert abs(float(got) - float(want)) <= 2e-5 * abs(float(want)) \
            + 1e-6
    assert (float(metrics["moe_aux"]) > 0) == bool(cfg.num_experts)
    _leaf_close(unflatten(params, grads), _bridge(jg, cfg), 2e-4)


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-moe-16b"])
def test_train_steps_match_jax(arch):
    """5 steps of make_train_step (AdamW, clipping on, MoE aux on for
    deepseek) from the same weights and batches as the JAX train step."""
    cfg, jcfg, jp, params = _model(arch)
    jopt = jax_opt.AdamW(lr=jax_opt.constant_schedule(1e-3))
    opt = AdamW(lr=constant_schedule(1e-3))
    jstate = jax_steps.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    params = tree_map(torch.clone, params)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jax_steps.make_train_step(jcfg, jopt))
    step = make_train_step(cfg, opt)
    data = jax_pipeline.batches(jcfg, jax_pipeline.DataConfig(
        batch_size=2, seq_len=32, seed=2))
    for i in range(5):
        nb = next(data)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        state, m = step(state, {k: torch.as_tensor(v) for k, v in nb.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=STEP_RTOL, err_msg=f"{k} {i}")
    assert int(state.step) == int(jstate.step) == 5


def test_launch_train_smoke_on_the_cpu(capsys):
    train_launcher.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1].startswith("final loss ")
    with pytest.raises(SystemExit,
                       match=r">=256-card mesh \(\d+ cards visible\)"):
        train_launcher.main(["--arch", "yi-9b", "--device", "cpu"])
