"""The port's LiveEngine on the CPU: the torch twin of
tests/test_live_engine.py::test_engine_reuse_matches_full_prefill, run
against the port's own KVStore and held against the JAX LiveEngine on the
same submits; plus its refusal of the knobs that later slices bring."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster.storage import KVStore as JaxKVStore  # noqa: E402
from repro.serving.engine import LiveEngine as JaxLiveEngine  # noqa: E402

from repro_torch.cluster.storage import KVStore  # noqa: E402
from repro_torch.core.chunks import prefix_key  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import LiveEngine  # noqa: E402

STORE_KW = dict(tokens_per_chunk=16, resolutions=("240p",))


@pytest.fixture(scope="module")
def torch_params(tiny_cfg, tiny_params):
    return from_numpy(jax.tree.map(np.asarray, tiny_params), tiny_cfg,
                      device="cpu")


@pytest.fixture(scope="module")
def stores(tiny_cfg, torch_params):
    """Factory: the port's donor KV for ``prefix``, registered in the
    port's KVStore and (the same arrays) in the JAX one."""
    def _make(prefix):
        kv_k, kv_v = paged_model.donor_prefix_kv(torch_params, tiny_cfg,
                                                 prefix)
        ours, ref = KVStore(), JaxKVStore()
        ours.register_prefix(prefix, kv_k, kv_v, **STORE_KW)
        ref.register_prefix(prefix, kv_k, kv_v, **STORE_KW)
        assert ours.stored_bytes() == ref.stored_bytes()
        return ours, ref, prefix_key(prefix)
    return _make


def _serve(engine, submits):
    reqs = [engine.submit(toks, **kw) for toks, kw in submits]
    engine.run()
    assert all(r.t_first_token is not None for r in reqs)
    assert len(engine.finished) == len(reqs)
    return [engine.outputs[r.rid] for r in reqs]


@pytest.mark.parametrize("policy", ["kvfetcher", "fetch_agnostic"])
def test_engine_reuse_matches_full_prefill_and_jax(policy, tiny_cfg,
                                                   tiny_params, torch_params,
                                                   stores):
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, tiny_cfg.vocab_size, 48)
    full = np.concatenate([prefix, rng.integers(0, tiny_cfg.vocab_size, 8)])
    ours, ref, key = stores(prefix)
    reuse = dict(reuse_prefix=key, reuse_tokens=48, max_new_tokens=4)

    eng_a = LiveEngine(torch_params, tiny_cfg, KVStore(), policy=policy,
                       device="cpu")
    (out_a,) = _serve(eng_a, [(full, dict(max_new_tokens=4))])
    eng_b = LiveEngine(torch_params, tiny_cfg, ours, policy=policy,
                       device="cpu")
    (out_b,) = _serve(eng_b, [(full, reuse)])
    assert eng_b.stats.restored_tokens == 48 * 2  # k and v
    assert eng_b.stats.fetched_bytes > 0
    assert out_a == out_b  # lossless at the system level
    assert eng_b.stats.restore_buffer_high_water < 1_000_000

    jax_b = JaxLiveEngine(tiny_params, tiny_cfg, ref, policy=policy)
    (want,) = _serve(jax_b, [(full, reuse)])
    assert out_b == want
    assert eng_b.stats.restored_tokens == jax_b.stats.restored_tokens
    assert eng_b.stats.fetched_bytes == jax_b.stats.fetched_bytes
    assert eng_b.stats.restore_buffer_high_water == \
        jax_b.stats.restore_buffer_high_water


def test_engine_mixed_batch_matches_jax(tiny_cfg, tiny_params, torch_params,
                                        stores):
    """One reuse and one plain request decode in the same batch."""
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, tiny_cfg.vocab_size, 32)
    ours, ref, key = stores(prefix)
    rng2 = np.random.default_rng(3)
    submits = [
        (np.concatenate([prefix, rng2.integers(0, tiny_cfg.vocab_size, 4)]),
         dict(reuse_prefix=key, reuse_tokens=32, max_new_tokens=3)),
        (rng2.integers(0, tiny_cfg.vocab_size, 16), dict(max_new_tokens=3)),
    ]
    streamed = []
    eng = LiveEngine(torch_params, tiny_cfg, ours, max_running=4,
                     device="cpu",
                     on_token=lambda r, t, _: streamed.append((r.rid, t)))
    got = _serve(eng, submits)
    jax_eng = JaxLiveEngine(tiny_params, tiny_cfg, ref, max_running=4)
    assert got == _serve(jax_eng, submits)
    assert eng.stats.restored_tokens == jax_eng.stats.restored_tokens == 64
    assert eng.stats.fetched_bytes == jax_eng.stats.fetched_bytes
    assert sorted(streamed) == sorted((rid, t) for rid, out in enumerate(got)
                                      for t in out)


@pytest.mark.parametrize("knob,value", [
    ("bandwidth", object()), ("fairness", object()), ("loss", object()),
    ("prefetch", object()), ("decode_table", object()), ("mesh", object()),
    ("mesh_shards", 2), ("external_dispatch", True), ("fetch_mode", "async"),
])
def test_engine_refuses_knobs_of_later_slices(knob, value, tiny_cfg,
                                              torch_params):
    with pytest.raises(NotImplementedError, match=knob):
        LiveEngine(torch_params, tiny_cfg, KVStore(), device="cpu",
                   **{knob: value})


def test_engine_refuses_other_stores(tiny_cfg, torch_params):
    with pytest.raises(NotImplementedError, match="StorageCluster"):
        LiveEngine(torch_params, tiny_cfg, JaxKVStore(), device="cpu")


def test_entry_points_raise_without_a_card_unless_told_cpu(tiny_cfg,
                                                           torch_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.paged.cache import PagedKVCache
    from repro_torch.params import init_params
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LiveEngine(torch_params, tiny_cfg, KVStore())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(tiny_cfg, n_pages=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tiny_cfg, torch.Generator())
