"""One launch per fetched chunk: ``kv_restore_layers`` and
``PagedKVCache.restore_chunk`` held against the JAX package's op and cache
applied layer by layer, and the port's ``LiveEngine`` restoring each
fetched chunk with one call on both clocks, with the JAX engine's tokens
and stats.  All on the CPU, where the op runs its plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster import network as jax_network  # noqa: E402
from repro.cluster.storage import KVStore as JaxKVStore  # noqa: E402
from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import adaptive as jax_adaptive  # noqa: E402
from repro.kernels.kv_restore.ops import kv_restore as jax_kv_restore  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.paged.cache import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serving.engine import LiveEngine as JaxLiveEngine  # noqa: E402

from repro_torch.cluster import network  # noqa: E402
from repro_torch.cluster.storage import KVStore  # noqa: E402
from repro_torch.core import adaptive  # noqa: E402
from repro_torch.core.chunks import prefix_key  # noqa: E402
from repro_torch.kernels.kv_restore import ops as kv_ops  # noqa: E402
from repro_torch.kernels.kv_restore.ops import kv_restore_layers  # noqa: E402
from repro_torch.paged import cache as cache_mod  # noqa: E402
from repro_torch.paged.cache import PagedKVCache  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import LiveEngine  # noqa: E402

JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float16": jnp.float16}


def _layers_inputs(G, dtype, dropped, seed, L=5, R=12, n=5, H=4, D=16):
    rng = np.random.default_rng(seed)
    pages = rng.standard_normal((L, R, H, D)).astype(np.float32)
    layers = [int(x) for x in rng.choice(L, size=G, replace=False)]
    q = rng.integers(0, 256, (G, n, H, D)).astype(np.uint8)
    scales = (rng.random((G, H)) + 0.05).astype(np.float32)
    slots = rng.choice(np.arange(1, R), size=n, replace=False)
    if dropped:
        slots[1::2] = -1  # rows >= 1 beside them, as the JAX test
    jpages = jnp.asarray(pages, JDTYPES[dtype])
    tpages = torch.from_numpy(np.array(jpages.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jpages, tpages, layers, q, scales, slots.astype(np.int32)


@pytest.mark.parametrize("dropped", [False, True], ids=["kept", "dropped"])
@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("dtype", sorted(JDTYPES))
def test_kv_restore_layers_matches_jax_layer_by_layer(dtype, G, dropped):
    """Bit-equal to G sequential calls of the JAX op (its Pallas kernel in
    interpret mode), one per layer of the group."""
    jpages, tpages, layers, q, scales, slots = _layers_inputs(
        G, dtype, dropped, seed=10 * G + dropped)
    for g, layer in enumerate(layers):
        jpages = jpages.at[layer].set(jax_kv_restore(
            jpages[layer], jnp.asarray(q[g]), jnp.asarray(scales[g]),
            jnp.asarray(slots)))
    before = kv_ops.launches
    got = kv_restore_layers(tpages, layers, torch.from_numpy(q),
                            torch.from_numpy(scales), torch.from_numpy(slots))
    assert got is tpages  # updated in place
    assert kv_ops.launches == before  # the plain version, no kernel
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(jpages.astype(jnp.float32)))


def test_kv_restore_layers_slot_zero_beside_dropped_tokens():
    """Row 0 of every layer of the group takes its new token; the dropped
    tokens and the layers outside the group change nothing."""
    _, pages, _, q, scales, _ = _layers_inputs(3, "float32", False, seed=3,
                                               n=4)
    old = pages.clone()
    layers = (4, 0, 2)
    slots = torch.tensor([0, -1, 7, -1], dtype=torch.int32)
    kv_restore_layers(pages, layers, torch.from_numpy(q),
                      torch.from_numpy(scales), slots)
    deq = (torch.from_numpy(q).to(torch.float32) - 128.0) \
        * torch.from_numpy(scales)[:, None, :, None]
    for g, layer in enumerate(layers):
        assert torch.equal(pages[layer, 0], deq[g, 0])
        assert torch.equal(pages[layer, 7], deq[g, 2])
        rest = [r for r in range(pages.shape[1]) if r not in (0, 7)]
        assert torch.equal(pages[layer, rest], old[layer, rest])
    for layer in (1, 3):
        assert torch.equal(pages[layer], old[layer])


def test_kv_restore_layers_rejects_bad_layers():
    _, pages, _, q, scales, slots = _layers_inputs(2, "float32", False, 4)
    args = (torch.from_numpy(q), torch.from_numpy(scales),
            torch.from_numpy(slots))
    for layers in ((0, 5), (-1, 2), (3, 3)):  # L = 5
        with pytest.raises(ValueError, match="layers"):
            kv_restore_layers(pages, layers, *args)
    with pytest.raises(ValueError, match="host ints"):
        kv_restore_layers(pages, torch.empty(2, device="meta"), *args)
    with pytest.raises(ValueError, match=r"\[L, R, H, D\]"):
        kv_restore_layers(pages[0], (0, 1), *args)


def _cfg(num_layers):
    return reduce_config(get_config("lwm-7b"), num_layers=num_layers)


def test_restore_chunk_matches_jax_cache_per_layer():
    """PagedKVCache.restore_chunk (one call per chunk, through a staging
    buffer) against the JAX cache's restore_tokens called for each layer,
    over both kinds, a full 3-layer group and the 2-layer remainder."""
    cfg = _cfg(5)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)
    ours = PagedKVCache(cfg, n_pages=12, page_size=8, device="cpu")
    ref = JaxPagedKVCache(cfg, n_pages=12, page_size=8)
    for c in (ours, ref):
        c.add_seq(0, 20)
        c.add_seq(1, 40)
    assert ours.staging is None  # the CPU cache stages in plain memory
    for seq, t0, n in ((1, 0, 16), (1, 16, 16), (0, 4, 9)):
        # token order as the codec's frames interleave them
        token_ids = t0 + np.concatenate([np.arange(f, n, 2) for f in (0, 1)])
        for kind in ("k", "v"):
            for layers in ((0, 1, 2), (3, 4)):
                G = len(layers)
                q = rng.integers(0, 256, (G, n, K, hd)).astype(np.uint8)
                sc = (rng.random((G, K)) + 0.05).astype(np.float32)
                staged = ours.staging_buffer(G, n)
                assert staged.shape == (G, n, K, hd)
                staged.numpy()[:] = q
                ours.restore_chunk(kind, seq, layers, token_ids, staged,
                                   torch.from_numpy(sc))
                for g, layer in enumerate(layers):
                    ref.restore_tokens(layer, kind, seq, token_ids,
                                       jnp.asarray(q[g]), jnp.asarray(sc[g]))
    np.testing.assert_array_equal(ours.k_pages.numpy(),
                                  np.asarray(ref.k_pages))
    np.testing.assert_array_equal(ours.v_pages.numpy(),
                                  np.asarray(ref.v_pages))


# ---------------------------------------------------------------------------
# the engine: one kv_restore_layers call per fetched chunk, on both clocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def five_layers():
    """A reduced lwm-7b of 5 layers (groups of 3 and 2) with the JAX init
    and its port bridge."""
    cfg = _cfg(5)
    jax_params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    params = from_numpy(jax.tree.map(np.asarray, jax_params), cfg,
                        device="cpu")
    return cfg, jax_params, params


def _virtual_knobs(ns_adaptive, ns_network):
    table = ns_adaptive.DecodeTable(
        name="test", n_decoders=2, latency={"240p": (0.04, 0.05)},
        penalty={"240p": 0.0}, chunk_size_mb={"240p": 0.004})
    return dict(bandwidth=ns_network.BandwidthTrace.constant(0.0006),
                decode_table=table)


@pytest.mark.parametrize("clock", ["wall", "sync", "async"])
def test_engine_restores_each_chunk_with_one_call(clock, five_layers,
                                                  monkeypatch):
    cfg, jax_params, params = five_layers
    calls = []
    real = cache_mod.kv_restore_layers

    def counted(pages, layers, q_tokens, scales, slots):
        calls.append((tuple(layers), q_tokens.shape[1]))
        return real(pages, layers, q_tokens, scales, slots)

    monkeypatch.setattr(cache_mod, "kv_restore_layers", counted)
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab_size, 32)
    full = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 6)])
    plain = rng.integers(0, cfg.vocab_size, 12)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    ours, ref = KVStore(), JaxKVStore()
    for store in (ours, ref):
        store.register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=16,
                              resolutions=("240p",))
    kw, jax_kw = {}, {}
    if clock != "wall":
        kw = dict(fetch_mode=clock, **_virtual_knobs(adaptive, network))
        jax_kw = dict(fetch_mode=clock,
                      **_virtual_knobs(jax_adaptive, jax_network))
    logs = []
    for eng in (LiveEngine(params, cfg, ours, device="cpu", **kw),
                JaxLiveEngine(jax_params, cfg, ref, **jax_kw)):
        reqs = [eng.submit(full, reuse_prefix=prefix_key(prefix),
                           reuse_tokens=32, max_new_tokens=3),
                eng.submit(plain, max_new_tokens=3)]
        eng.run()
        assert len(eng.finished) == 2
        logs.append(dict(outputs=[eng.outputs[r.rid] for r in reqs],
                         token_times=([list(r.token_times) for r in reqs]
                                      if clock != "wall" else None),
                         stats=(eng.stats.restored_tokens,
                                eng.stats.fetched_bytes,
                                eng.stats.restore_buffer_high_water,
                                eng.stats.prefill_stall_time)))
    assert logs[0] == logs[1]
    man = ours.lookup(prefix_key(prefix))
    # 2 kinds x 2 layer groups x 2 token chunks, one call each
    assert len(man.refs) == 8
    assert sorted(calls) == sorted((r.layers, r.token_end - r.token_start)
                                   for r in man.refs)
