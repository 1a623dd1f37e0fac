"""The reference against the port's LiveEngine at a tiny size on the CPU:
the logits of a reuse request's suffix prefill over a restored int8
prefix and of its decode steps, and of a plain request's prefill and
decode steps, for a dense GQA and a DeepSeekMoE configuration.  (The
test imports both sides; the reference itself imports nothing of the
program.)"""
import pathlib

import numpy as np
import pytest
import torch

from kvbench import check, harness, traffic
from kvbench.reference import common, deepseek_moe
from kvbench.tests import tiny

CPU = torch.device("cpu")


def serve_and_capture(bench, specs):
    """Serve ``specs`` on the CPU and keep every logit the engine took a
    token from, per request."""
    from repro_torch.serving import paged_model
    eng = bench.engine()
    got = {}
    suffix, decode, prefill = (eng._suffix_prefill, paged_model.decode_paged,
                               paged_model.prefill_collect_kv)

    def cap_suffix(req, tokens):
        out = suffix(req, tokens)
        got.setdefault(req.rid, []).append(out.clone())
        return out

    rid_of_prefill = []

    def cap_prefill(params, cfg, tokens):
        logits, kvs = prefill(params, cfg, tokens)
        if rid_of_prefill:
            got.setdefault(rid_of_prefill.pop(), []).append(logits[0].clone())
        return logits, kvs

    def cap_decode(params, cfg, tokens, positions, cache, seq_ids):
        out = decode(params, cfg, tokens, positions, cache, seq_ids)
        for i, sid in enumerate(seq_ids):
            got.setdefault(sid, []).append(out[i].clone())
        return out

    real_prefill = eng._prefill

    def mark(req):
        if not req.needs_fetch:
            rid_of_prefill.append(req.rid)
        return real_prefill(req)

    eng._suffix_prefill, eng._prefill = cap_suffix, mark
    paged_model.decode_paged = cap_decode
    paged_model.prefill_collect_kv = cap_prefill
    try:
        reqs = []
        for s in specs:
            kw = {} if s.doc is None else dict(
                reuse_prefix=bench.keys[s.doc], reuse_tokens=s.reuse_tokens)
            reqs.append(eng.submit(s.tokens, max_new_tokens=s.max_new_tokens,
                                   **kw))
        while any(r.t_finished is None for r in reqs):
            eng.step()
    finally:
        paged_model.decode_paged = decode
        paged_model.prefill_collect_kv = prefill
    return [(r, eng.outputs[r.rid], torch.stack(got[r.rid])) for r in reqs]


@pytest.mark.parametrize("model", [tiny.DENSE, tiny.MOE],
                         ids=["dense_gqa", "deepseek_moe"])
def test_reference_logits_match_the_engine(model, tmp_path):
    mix = dict(tiny.REUSE, documents={"count": 1, "tokens": 48})
    bench_json = tiny.write(tmp_path, model, mix)
    files = harness.cell_files(bench_json, "tiny.cell", False,
                               root=pathlib.Path("/"), base=tmp_path)
    bench = harness.Bench(files, 17, CPU)
    rng = np.random.default_rng(0)
    doc = bench.docs[0]
    specs = [traffic.Spec(0, np.concatenate([doc, rng.integers(0, 256, 9)]),
                          6, doc=0, reuse_tokens=len(doc)),
             traffic.Spec(1, rng.integers(0, 256, 40), 5),
             traffic.Spec(2, rng.integers(0, 256, 17), 7)]
    ref = check.Reference(bench)
    for (req, served, logits), spec in zip(serve_and_capture(bench, specs),
                                           specs):
        assert len(served) == spec.max_new_tokens
        want = ref.logits(spec, served)
        assert logits.shape == want.shape
        scale = want.abs().max()
        assert float((logits - want).abs().max()) <= 1e-4 * scale, spec
        gap = check.gap(want, torch.as_tensor(served))
        assert gap == 0.0


def test_the_stored_prefix_is_the_int8_round_trip():
    kv = torch.randn(30, 2, 8)
    back = common.int8_round_trip(kv)
    scale = kv.abs().amax(dim=(0, 2)) / 127
    assert torch.allclose(back, torch.round(kv / scale[None, :, None])
                          * scale[None, :, None])
    from repro_torch.core.quantization import dequantize, quantize
    q, sc = quantize(kv[:, None].numpy())
    assert np.array_equal(dequantize(q, sc)[:, 0], back.numpy())


def test_moe_capacity_drops_choices_beyond_an_experts_room():
    """Every token prefers experts 0 and 1: with capacity max(1, int(s k
    cf / E)) the later tokens' choices are dropped, and a decode token
    routed alone is never dropped."""
    m = dict(tiny.MOE)
    d, E = m["d_model"], m["num_experts"]
    router = torch.zeros(d, E)
    router[:, 0], router[:, 1] = 1.0, 0.5
    x = torch.rand(16, d) + 0.1
    lp = {"moe": {"router": router, "wi": torch.randn(E, d, 2, m["d_ff"]),
                  "wo": torch.randn(E, m["d_ff"], d)}}
    cap = int(16 * 2 * 1.25 / E)  # 5
    out = deepseek_moe._routed(lp, x, m, [16])
    alone = deepseek_moe._routed(lp, x, m, [1] * 16)
    assert torch.count_nonzero(out.abs().sum(-1)) == cap
    assert torch.count_nonzero(alone.abs().sum(-1)) == 16
    assert torch.allclose(out[:cap], alone[:cap], atol=1e-5)
