"""The port's attention cache functions and RG-LRU block against the JAX
package's on the CPU, from the same weights and inputs:
``attention_prefill`` / ``attention_decode`` / ``attention_decode_token``
on a ring cache that the prompt overflows and decode wraps again (and on
a plain cache), ``linear_scan`` (a doubling scan here, an associative
scan there: the same products in another order, held within 1e-5) and
``apply_rglru_full`` / ``apply_rglru_decode``.  Outputs and caches within
2e-5 (fp32 on both sides)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

TOL = 2e-5


def _cfgs(arch):
    return (configs.reduce_config(configs.get_config(arch)),
            jax_configs.reduce_config(jax_configs.get_config(arch)))


def _port(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- attention caches ---------------------------------------------------------

#: (arch, capacity, windowed, prompt, decode steps): a ring of 8 slots
#: under a prompt of 13, then 9 decode steps that wrap it again; the same
#: for qwen's biased projections; a plain cache with room for everything
RING_CASES = [("h2o-danube-3-4b", 8, True, 13, 9),
              ("qwen1.5-110b", 8, True, 13, 9),
              ("yi-9b", 24, False, 13, 9)]


@pytest.mark.parametrize("arch,cap,windowed,n_pre,n_dec", RING_CASES)
def test_attention_cache_paths_match_jax(arch, cap, windowed, n_pre, n_dec):
    cfg, jcfg = _cfgs(arch)
    jp = jax_attn.init_attention(jcfg, jax.random.PRNGKey(3))
    if cfg.qkv_bias:  # the init's zero biases would test nothing
        jp = {k: (v + 0.1 * jnp.asarray(_x(v.shape, 9)) if k[0] == "b"
                  else v) for k, v in jp.items()}
    p = _port(jp)
    b = 2
    x = _x((b, n_pre + n_dec, cfg.d_model), 1)
    spec = attn.CacheSpec(cap, windowed)
    jspec = jax_attn.CacheSpec(cap, windowed)
    cache = attn.init_kv_cache(cfg, b, spec, device="cpu")
    jcache = jax_attn.init_kv_cache(jcfg, b, jspec)
    positions = np.tile(np.arange(n_pre, dtype=np.int32), (b, 1))
    out, cache = attn.attention_prefill(p, torch.from_numpy(x[:, :n_pre]),
                                        cfg, torch.from_numpy(positions),
                                        cache, spec)
    want, jcache = jax_attn.attention_prefill(
        jp, jnp.asarray(x[:, :n_pre]), jcfg, jnp.asarray(positions), jcache,
        jspec)
    _close(out, want)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    if windowed:  # the trailing window sits in slots pos % capacity
        k_all = np.asarray(jax_attn._project_qkv(
            jp, jnp.asarray(x[:, :n_pre]), jcfg, jnp.asarray(positions))[1])
        for pos in range(n_pre - cap, n_pre):
            _close(cache["k"][:, pos % cap], k_all[:, pos])
    for i in range(n_pre, n_pre + n_dec):
        xi = torch.from_numpy(x[:, i:i + 1])
        out, new = attn.attention_decode(p, xi, cfg, i, cache, spec)
        want, jnew = jax_attn.attention_decode(
            jp, jnp.asarray(x[:, i:i + 1]), jcfg, jnp.int32(i), jcache,
            jspec)
        _close(out, want)
        out_t, tok = attn.attention_decode_token(p, xi, cfg, i, cache, spec)
        want_t, jtok = jax_attn.attention_decode_token(
            jp, jnp.asarray(x[:, i:i + 1]), jcfg, jnp.int32(i), jcache,
            jspec)
        _close(out_t, want_t)
        _close(out_t, want)  # the two decode forms agree
        for name in ("k", "v"):
            _close(new[name], jnew[name])
            _close(tok[f"{name}_tok"], jtok[f"{name}_tok"])
        cache, jcache = new, jnew


def test_cache_spec_and_init_match_jax():
    cfg, jcfg = _cfgs("recurrentgemma-9b")
    for seq_len in (32, 64, 100):
        for local in (False, True):
            got = attn.cache_spec(cfg, seq_len, local=local)
            want = jax_attn.cache_spec(jcfg, seq_len, local=local)
            assert (got.capacity, got.windowed) == (want.capacity,
                                                    want.windowed)
    c = attn.init_kv_cache(cfg, 3, attn.CacheSpec(64, True), device="cpu")
    assert c["k"].shape == c["v"].shape == (3, 64, cfg.num_kv_heads,
                                            cfg.head_dim)


# -- RG-LRU ---------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 37, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_scan_matches_jax(s, with_h0):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.0, 1.0, (3, s, 16)).astype(np.float32)
    b = rng.standard_normal((3, s, 16)).astype(np.float32)
    h0 = rng.standard_normal((3, 16)).astype(np.float32) if with_h0 else None
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                            None if h0 is None else torch.from_numpy(h0))
    want = jax_rglru.linear_scan(jnp.asarray(a), jnp.asarray(b),
                                 None if h0 is None else jnp.asarray(h0))
    _close(got, want, 1e-5)
    # and the recurrence itself, step by step
    h = np.zeros((3, 16), np.float32) if h0 is None else h0
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


def test_rglru_block_matches_jax():
    cfg, jcfg = _cfgs("recurrentgemma-9b")
    jp = jax_rglru.init_rglru(jcfg, jax.random.PRNGKey(5))
    p = _port(jp)
    b, s, n_dec = 2, 20, 5
    x = _x((b, s + n_dec, cfg.d_model), 2)
    out, _ = rglru.apply_rglru_full(p, torch.from_numpy(x[:, :s]), cfg,
                                    with_cache=False)
    want, _ = jax_rglru.apply_rglru_full(jp, jnp.asarray(x[:, :s]), jcfg,
                                         with_cache=False)
    _close(out, want)
    out, cache = rglru.apply_rglru_full(p, torch.from_numpy(x[:, :s]), cfg,
                                        with_cache=True)
    _, jcache = jax_rglru.apply_rglru_full(jp, jnp.asarray(x[:, :s]), jcfg,
                                           with_cache=True)
    for name in ("h", "conv"):
        _close(cache[name], jcache[name])
    empty = rglru.init_rglru_cache(cfg, b, device="cpu")
    jempty = jax_rglru.init_rglru_cache(jcfg, b)
    for name in ("h", "conv"):
        np.testing.assert_array_equal(empty[name].numpy(), jempty[name])
    for i in range(s, s + n_dec):
        out, cache = rglru.apply_rglru_decode(
            p, torch.from_numpy(x[:, i:i + 1]), cfg, cache)
        want, jcache = jax_rglru.apply_rglru_decode(
            jp, jnp.asarray(x[:, i:i + 1]), jcfg, jcache)
        _close(out, want)
        for name in ("h", "conv"):
            _close(cache[name], jcache[name])


def test_cache_inits_raise_without_a_card_unless_told_cpu(monkeypatch):
    from repro_torch.models import transformer as tf
    cfg, _ = _cfgs("recurrentgemma-9b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for init in (lambda: attn.init_kv_cache(cfg, 1, attn.CacheSpec(8, True)),
                 lambda: rglru.init_rglru_cache(cfg, 1),
                 lambda: tf.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init()
