"""State-snapshot prefix reuse for Mamba2 through the port, held against
the JAX package on the CPU: the snapshot codec byte for byte, the cache
flattening under the JAX tree's names, and a torch twin of
tests/test_state_snapshot_reuse.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.core.chunks import (  # noqa: E402
    decode_state_snapshot as jax_decode_snapshot,
    encode_state_snapshot as jax_encode_snapshot)
from repro.models import transformer as jax_tf  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.chunks import (  # noqa: E402
    decode_state_snapshot, encode_state_snapshot)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402

CFG = reduce_config(get_config("mamba2-2.7b"))
JAX_CFG = jax_reduce_config(jax_get_config("mamba2-2.7b"))
PREFIX = 40


def _flatten_cache(cache):
    """The JAX test's flattening of a cache tree into named arrays."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        flat[name] = np.asarray(leaf, np.float32)
    return flat


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_params(JAX_CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return from_numpy(jax.tree.map(np.asarray, jax_params), CFG,
                      device="cpu")


@pytest.fixture(scope="module")
def donor(jax_params):
    """The JAX test's inputs and its donor: prefix, next token, the
    donor's cache and its next-token logits."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, CFG.vocab_size, PREFIX)
    nxt = int(rng.integers(0, CFG.vocab_size))
    _, cache = jax_tf.prefill(jax_params, JAX_CFG,
                              tokens=jnp.asarray(prefix[None]))
    logits, _ = jax_tf.decode_step(jax_params, JAX_CFG, jnp.asarray([nxt]),
                                   jnp.int32(PREFIX), cache)
    return prefix, nxt, cache, np.asarray(logits)


@pytest.mark.parametrize("seed,shapes", [
    (0, {"cycles/l0/state": (3, 2, 4, 8, 5), "cycles/l0/conv": (3, 2, 3, 9)}),
    (1, {"a": (17,), "b/c": (2, 300), "zeros": (4, 4)}),
])
def test_snapshot_codec_byte_identical(seed, shapes):
    rng = np.random.default_rng(seed)
    states = {k: (rng.standard_normal(s) * (k != "zeros")).astype(np.float32)
              for k, s in shapes.items()}
    blob = encode_state_snapshot(states)
    assert blob == jax_encode_snapshot(states)
    got, want = decode_state_snapshot(blob), jax_decode_snapshot(blob)
    assert sorted(got) == sorted(want) == sorted(states)
    for k in states:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


def test_snapshot_states_use_the_jax_tree_names(params, donor):
    prefix, _, cache_j, _ = donor
    flat_j = _flatten_cache(cache_j)
    _, cache = tf.prefill(params, CFG, tokens=torch.from_numpy(prefix[None]))
    flat = tf.snapshot_states(cache, CFG)
    assert sorted(flat) == sorted(flat_j) == ["cycles/l0/conv",
                                              "cycles/l0/state"]
    for name in flat:
        assert flat[name].shape == flat_j[name].shape
        assert flat[name].dtype == np.float32
        np.testing.assert_allclose(flat[name], flat_j[name], rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("batch", [None, 3])
def test_cache_round_trip_bit_equal(donor, batch):
    flat = _flatten_cache(donor[2])
    cache = tf.cache_from_snapshot(flat, CFG, "cpu", batch=batch)
    assert len(cache) == CFG.num_layers
    back = tf.snapshot_states(cache, CFG)
    assert sorted(back) == sorted(flat)
    for name, arr in flat.items():
        rows = back[name].shape[1]
        assert rows == (batch or arr.shape[1])
        for r in range(rows):
            np.testing.assert_array_equal(back[name][:, r:r + 1], arr)
    # the same arrays give the same blob on both sides: one scale per name
    assert encode_state_snapshot(tf.snapshot_states(
        tf.cache_from_snapshot(flat, CFG, "cpu"), CFG)) == \
        jax_encode_snapshot(flat)


def test_continuation_from_jax_snapshot_matches_jax(jax_params, params,
                                                    donor):
    _, nxt, cache_j, _ = donor
    back = jax_decode_snapshot(jax_encode_snapshot(_flatten_cache(cache_j)))
    leaves, treedef = jax.tree_util.tree_flatten(cache_j)
    names = list(_flatten_cache(cache_j))
    rebuilt_j = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(back[n], leaf.dtype)
                  for n, leaf in zip(names, leaves)])
    want, _ = jax_tf.decode_step(jax_params, JAX_CFG, jnp.asarray([nxt]),
                                 jnp.int32(PREFIX), rebuilt_j)
    got, _ = tf.decode_step(params, CFG, torch.tensor([nxt]), PREFIX,
                            tf.cache_from_snapshot(back, CFG, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_port_snapshot_reuse_end_to_end(params, donor):
    """The JAX test's criteria on the port's own path: donor prefill ->
    snapshot -> encode -> decode -> rebuild -> continuation."""
    prefix, nxt, _, jax_logits = donor
    _, cache = tf.prefill(params, CFG, tokens=torch.from_numpy(prefix[None]))
    donor_logits, _ = tf.decode_step(params, CFG, torch.tensor([nxt]),
                                     PREFIX, cache)
    np.testing.assert_allclose(donor_logits.numpy(), jax_logits, rtol=3e-4,
                               atol=3e-4)
    flat = tf.snapshot_states(cache, CFG)
    blob = encode_state_snapshot(flat)
    assert len(blob) < sum(v.nbytes for v in flat.values())  # compresses
    rebuilt = tf.cache_from_snapshot(decode_state_snapshot(blob), CFG, "cpu")
    got, _ = tf.decode_step(params, CFG, torch.tensor([nxt]), PREFIX,
                            rebuilt)
    assert int(got.argmax()) == int(donor_logits.argmax())
    err = float((got - donor_logits).abs().max())
    scale = float(donor_logits.abs().max())
    assert err < 0.1 * scale, (err, scale)
