"""deepseek-moe-16b routed as published, served by the port, against the
benchmark's plain reference (``kvbench/reference/deepseek_moe_published
.py``) on seeded random weights (``kvbench/weights.py``) at a tiny size
on the CPU, compared by logits: a full prefill, a suffix prefill over a
restored (int8 round-tripped) prefix and paged decode steps at batch 3
through the ``LiveEngine``.  And the property capacity routing broke: a
suffix prefill over a prefix's exact KV gives what a full prefill of the
same prompt gives.  Imports nothing of JAX."""
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from kvbench import weights as bench_weights  # noqa: E402
from kvbench.reference import common  # noqa: E402
from kvbench.reference import deepseek_moe_published as reference  # noqa: E402
from repro_torch.cluster.storage import KVStore  # noqa: E402
from repro_torch.configs import ModelConfig, jax_routing  # noqa: E402
from repro_torch.core.chunks import prefix_key  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import LiveEngine  # noqa: E402

#: deepseek-moe-16b's block at a tiny width: a dense first layer, then
#: 64 routed experts (top 6, unnormalised, no capacity) and 2 shared
MODEL = {"arch_type": "moe", "num_layers": 4, "d_model": 64, "num_heads": 4,
         "num_kv_heads": 4, "head_dim": 16, "d_ff": 32, "dense_d_ff": 96,
         "vocab_size": 256, "mlp_kind": "swiglu", "num_experts": 64,
         "num_shared_experts": 2, "experts_per_token": 6,
         "first_layer_dense": True, "norm_topk_prob": False,
         "moe_dropless": True, "norm_eps": 1e-6, "rope_theta": 10000.0,
         "tie_embeddings": False}
WEIGHTS = {"embed_std": 0.02, "norm_std": 0.1}
N_PRE, N_SUF, NEW = 48, 16, 6
#: of the reference's largest |logit|: float32 sums in another order
TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(name="deepseek-moe-tiny", source="test", **MODEL)
    params = bench_weights.make_weights(MODEL, WEIGHTS, 11,
                                        torch.device("cpu"))
    return cfg, params


def _close(got, want, tol=TOL):
    scale = float(want.abs().max())
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * scale


def test_full_prefill_matches_the_reference(model):
    cfg, params = model
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 256, 40))
    with torch.no_grad():
        got, _ = paged_model.prefill_collect_kv(params, cfg, toks[None])
        want = reference.logits(params, MODEL, toks, 0, None, [40], 39)
    _close(got, want)


def _serve_and_capture(cfg, params, store, submits):
    """Serve ``submits`` together (their decode steps batched) and capture
    every logits row each request was served from."""
    got = {}
    prefill, suffix = paged_model.prefill_collect_kv, \
        LiveEngine._suffix_prefill
    decode = paged_model.decode_paged
    eng = LiveEngine(params, cfg, store, device="cpu", max_running=4)
    current = []

    def cap_prefill(p, c, tokens):
        logits, kvs = prefill(p, c, tokens)
        got.setdefault(current[0], []).append(logits[0].clone())
        return logits, kvs

    def cap_suffix(self, req, tokens):
        logits = suffix(self, req, tokens)
        got.setdefault(req.rid, []).append(logits.clone())
        return logits

    def cap_decode(p, c, tokens, positions, cache, seq_ids):
        out = decode(p, c, tokens, positions, cache, seq_ids)
        for i, sid in enumerate(seq_ids):
            got.setdefault(sid, []).append(out[i].clone())
        return out

    prefill_of = eng._prefill

    def tagged(req):
        current[:] = [req.rid]
        return prefill_of(req)

    eng._prefill = tagged
    mp = pytest.MonkeyPatch()
    mp.setattr(paged_model, "prefill_collect_kv", cap_prefill)
    mp.setattr(paged_model, "decode_paged", cap_decode)
    mp.setattr(LiveEngine, "_suffix_prefill", cap_suffix)
    try:
        reqs = [eng.submit(t, **kw) for t, kw in submits]
        eng.run()
    finally:
        mp.undo()
    assert all(r.t_finished is not None for r in reqs)
    return [(r, eng.outputs[r.rid], torch.stack(got[r.rid])) for r in reqs]


def test_served_logits_match_the_reference(model):
    """Two reuse requests (a suffix prefill over the restored prefix) and a
    plain one, decoding together at batch 3: at every served position the
    engine's logits within ``TOL`` of the reference's over the same
    prompt, tokens and stored prefix, and every served token the
    reference's first choice."""
    cfg, params = model
    rng = np.random.default_rng(2)
    doc = rng.integers(0, 256, N_PRE)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, doc)
    store = KVStore()
    store.register_prefix(doc, kv_k, kv_v, tokens_per_chunk=16,
                          resolutions=("240p",))
    reuse = dict(reuse_prefix=prefix_key(doc), reuse_tokens=N_PRE,
                 max_new_tokens=NEW)
    prompts = [(np.concatenate([doc, rng.integers(0, 256, N_SUF)]), reuse),
               (rng.integers(0, 256, 30), dict(max_new_tokens=NEW)),
               (np.concatenate([doc, rng.integers(0, 256, 9)]), reuse)]
    # the prefix the store holds: the engine's donor K, V through the
    # int8 round trip, layer by layer
    stored = [(common.int8_round_trip(torch.from_numpy(kv_k[:, i])),
               common.int8_round_trip(torch.from_numpy(kv_v[:, i])))
              for i in range(cfg.num_layers)]
    served = _serve_and_capture(cfg, params, store, prompts)
    assert max(len(lg) for _, _, lg in served) == NEW
    for (req, out, logits), (prompt, kw) in zip(served, prompts):
        n_pre = kw.get("reuse_tokens", 0)
        toks = np.concatenate([prompt, np.asarray(out[:-1])])
        n_first = len(prompt) - n_pre
        with torch.no_grad():
            want = reference.logits(
                params, MODEL, torch.as_tensor(toks[n_pre:]), n_pre,
                stored if n_pre else None,
                [n_first] + [1] * (len(out) - 1), n_first - 1)
        _close(logits, want)
        assert want.argmax(-1).tolist() == list(out)


def _suffix_over_exact_prefix(cfg, params, tokens, n_pre):
    """The engine's suffix prefill of ``tokens[n_pre:]`` over the exact
    (not quantized) K, V of ``tokens[:n_pre]`` written into its pages."""
    eng = LiveEngine(params, cfg, KVStore(), device="cpu", n_pages=16)
    _, kvs = paged_model.prefill_collect_kv(
        params, cfg, torch.as_tensor(tokens[None, :n_pre]))
    eng.cache.add_seq(0, len(tokens) + 1)
    for layer, (k, v) in enumerate(kvs):
        eng.cache.write_prefill(layer, 0, k[0], v[0])
    return eng._suffix_prefill(
        types.SimpleNamespace(rid=0, reuse_tokens=n_pre), tokens)


def test_reuse_equals_a_full_recompute(model):
    """Dropless routing: the suffix prefill over the prefix's KV gives the
    full prefill's last logits up to float rounding.  The JAX package's
    capacity routing, which the port used before, routes the 16-token
    suffix as a group with room for one choice an expert and the prompt
    of 64 with room for seven, and misses by far more."""
    cfg, params = model
    tokens = np.random.default_rng(3).integers(0, 256, N_PRE + N_SUF)
    with torch.no_grad():
        for routing, ok in ((cfg, True), (jax_routing(cfg), False)):
            full, _ = paged_model.prefill_collect_kv(
                params, routing, torch.as_tensor(tokens[None]))
            reused = _suffix_over_exact_prefix(routing, params, tokens,
                                               N_PRE)
            gap = float((reused - full[0]).abs().max())
            scale = float(full.abs().max())
            if ok:
                assert gap <= 1e-5 * scale
            else:
                assert gap > 1e-2 * scale


def test_the_configuration_file_is_this_routing():
    """The benchmark's deepseek-moe-16b file routes as this test's model
    and as the registered config: published routing, published widths."""
    import json

    from repro_torch.configs import get_config
    c = json.loads((ROOT / "kvbench" / "configs" /
                    "deepseek-moe-16b.json").read_text())
    m = ModelConfig(name=c["name"], source=c["source"], **c["model"])
    reg = get_config("deepseek-moe-16b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "dense_d_ff", "vocab_size", "num_experts",
              "num_shared_experts", "experts_per_token", "first_layer_dense",
              "norm_topk_prob", "moe_dropless"):
        assert getattr(m, f) == getattr(reg, f), f
    assert (m.norm_topk_prob, m.moe_dropless) == (False, True)
