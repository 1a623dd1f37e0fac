"""The port's paged KV cache and paged model paths, held against the JAX
package's on the CPU (the torch twin of
tests/test_live_engine.py::test_paged_decode_matches_dense_decode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.paged.cache import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serving import paged_model as jax_pm  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.paged.cache import PagedKVCache  # noqa: E402
from repro_torch.params import from_numpy, init_params  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402


@pytest.fixture(scope="module")
def torch_params(tiny_cfg, tiny_params):
    return from_numpy(jax.tree.map(np.asarray, tiny_params), tiny_cfg,
                      device="cpu")


def _pages(cache):
    if isinstance(cache, PagedKVCache):
        return cache.k_pages.numpy(), cache.v_pages.numpy()
    return np.asarray(cache.k_pages), np.asarray(cache.v_pages)


def test_cache_writes_match_jax_exactly(tiny_cfg):
    cfg = tiny_cfg
    K, hd = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)
    ours = PagedKVCache(cfg, n_pages=12, page_size=8, device="cpu")
    ref = JaxPagedKVCache(cfg, n_pages=12, page_size=8)
    for c in (ours, ref):
        c.add_seq(0, 20)
        c.add_seq(1, 9)
        c.ensure_capacity(1, 30)
    assert ours.seqs[1].block_table == ref.seqs[1].block_table
    np.testing.assert_array_equal(ours.block_table_array([0, 1]),
                                  ref.block_table_array([0, 1]))
    for layer in range(cfg.num_layers):
        k = rng.standard_normal((13, K, hd)).astype(np.float32)
        v = rng.standard_normal((13, K, hd)).astype(np.float32)
        ours.write_prefill(layer, 1, torch.from_numpy(k),
                           torch.from_numpy(v), start_pos=3)
        ref.write_prefill(layer, 1, jnp.asarray(k), jnp.asarray(v),
                          start_pos=3)
        ours.write_decode_token(layer, 0, 17, torch.from_numpy(k[0]),
                                torch.from_numpy(v[0]))
        ref.write_decode_token(layer, 0, 17, jnp.asarray(k[0]),
                               jnp.asarray(v[0]))
        for kind in ("k", "v"):
            toks = np.array([0, 5, 9, 19])
            q = rng.integers(0, 256, (4, K, hd)).astype(np.uint8)
            sc = (rng.random(K) + 0.05).astype(np.float32)
            ours.restore_tokens(layer, kind, 0, toks, torch.from_numpy(q),
                                torch.from_numpy(sc))
            ref.restore_tokens(layer, kind, 0, toks, jnp.asarray(q),
                               jnp.asarray(sc))
    for a, b in zip(_pages(ours), _pages(ref)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        ours.slots_for(0, np.array([24]))  # past seq 0's 3 pages


def test_paged_prefill_and_decode_match_jax(tiny_cfg, tiny_params,
                                           torch_params):
    cfg = tiny_cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (24, 13)]
    ours = PagedKVCache(cfg, n_pages=64, page_size=8, device="cpu")
    ref = JaxPagedKVCache(cfg, n_pages=64, page_size=8)
    nxt = []
    for sid, toks in enumerate(prompts):
        lo, kvs = paged_model.prefill_collect_kv(
            torch_params, cfg, torch.as_tensor(toks[None]))
        lj, kvj = jax_pm.prefill_collect_kv(tiny_params, cfg,
                                            jnp.asarray(toks[None]))
        np.testing.assert_allclose(lo.numpy(), np.asarray(lj), rtol=2e-4,
                                   atol=2e-4)
        for (k, v), (kj, vj) in zip(kvs, kvj):
            np.testing.assert_allclose(k.numpy(), np.asarray(kj),
                                       rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(v.numpy(), np.asarray(vj),
                                       rtol=2e-4, atol=2e-4)
        for c, kv in ((ours, kvs), (ref, kvj)):
            c.add_seq(sid, len(toks) + 4)
            for layer, (k, v) in enumerate(kv):
                c.write_prefill(layer, sid, k[0], v[0])
        nxt.append(int(jnp.argmax(lj[0])))
    # two continuous-batching decode steps at distinct positions
    positions = np.array([len(p) for p in prompts], np.int32)
    toks = np.array(nxt, np.int32)
    for _ in range(2):
        lo = paged_model.decode_paged(torch_params, cfg,
                                      torch.from_numpy(toks),
                                      torch.from_numpy(positions), ours,
                                      [0, 1])
        lj = jax_pm.decode_paged(tiny_params, cfg, jnp.asarray(toks),
                                 jnp.asarray(positions), ref, [0, 1])
        np.testing.assert_allclose(lo.numpy(), np.asarray(lj), rtol=3e-4,
                                   atol=3e-4)
        toks = np.array(jnp.argmax(lj, axis=-1), np.int32)
        positions = positions + 1
    for a, b in zip(_pages(ours), _pages(ref)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_donor_prefix_kv_matches_jax(tiny_cfg, tiny_params, torch_params):
    toks = np.random.default_rng(4).integers(0, tiny_cfg.vocab_size, 20)
    k, v = paged_model.donor_prefix_kv(torch_params, tiny_cfg, toks)
    kj, vj = jax_pm.donor_prefix_kv(tiny_params, tiny_cfg, toks)
    assert k.shape == kj.shape == (20, tiny_cfg.num_layers,
                                   tiny_cfg.num_kv_heads, tiny_cfg.head_dim)
    assert k.dtype == np.float32
    np.testing.assert_allclose(k, kj, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(v, vj, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["lwm-7b", "deepseek-moe-16b"])
def test_prefill_over_no_prefix_is_the_plain_prefill(arch):
    """The suffix prefill over no prefix runs the plain prefill's layers:
    the same last logits bit for bit, every layer's hook in order, and
    the plain prefill's K/V in the sequence's pages."""
    cfg = reduce_config(get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    n = 21
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, n)))
    want, kvs = paged_model.prefill_collect_kv(params, cfg, tokens)
    cache = PagedKVCache(cfg, n_pages=8, page_size=8, device="cpu")
    cache.add_seq(3, n + 2)
    seen = []
    got = paged_model.prefill_over_pages(params, cfg, tokens, 0, cache, 3,
                                         before_layer=seen.append)
    assert seen == list(range(cfg.num_layers))
    assert got.shape == (1, cfg.vocab_size)
    assert torch.equal(got, want)
    rows = cache.slots_tensor(cache.slots_for(3, np.arange(n))).long()
    for layer, (k, v) in enumerate(kvs):
        assert torch.equal(cache.layer_rows(cache.k_pages, layer)[rows],
                           k[0])
        assert torch.equal(cache.layer_rows(cache.v_pages, layer)[rows],
                           v[0])
