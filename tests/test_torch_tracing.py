"""The serving engine's own spans (`repro_torch.serving.tracing`): how they
nest, what they cover, and what they cost outside a profiler session.
A tiny dense model serves one reuse and one plain request through a
`LiveEngine` with its own `Tracer`; imports nothing of JAX."""
import inspect
import math

import numpy as np
import pytest
import torch

from repro_torch.cluster.network import BandwidthTrace
from repro_torch.cluster.storage import KVStore
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.core.chunks import prefix_key
from repro_torch.core.codec import KVCodec
from repro_torch.params import init_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import paged_model, tracing
from repro_torch.serving.engine import LiveEngine

N_PRE, N_SUF, N_PLAIN = 48, 8, 20


@pytest.fixture(scope="module")
def model():
    cfg = reduce_config(get_config("lwm-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab_size, N_PRE)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    return cfg, params, prefix, kv_k, kv_v, rng


def serve(model, tracer, **kw):
    """One reuse and one plain request, submitted together and served to
    the end; returns (engine, reuse request, plain request)."""
    cfg, params, prefix, kv_k, kv_v, rng = model
    store = KVStore()
    store.register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=16,
                          resolutions=("240p",))
    eng = LiveEngine(params, cfg, store, device="cpu", tracer=tracer, **kw)
    reuse = eng.submit(np.concatenate(
        [prefix, rng.integers(0, cfg.vocab_size, N_SUF)]),
        reuse_prefix=prefix_key(prefix), reuse_tokens=N_PRE,
        max_new_tokens=4)
    plain = eng.submit(rng.integers(0, cfg.vocab_size, N_PLAIN),
                       max_new_tokens=4)
    eng.run()
    assert len(eng.finished) == 2
    return eng, reuse, plain


def test_spans_nest_as_the_engine_runs_them(model):
    tr = tracing.Tracer()
    eng, reuse, plain = serve(model, tr)
    (fetch,) = tr.spans("fetch")
    assert fetch.parent is None and fetch.rid == reuse.rid
    chunks = eng.store.lookup(reuse.prefix).refs
    for name in ("codec decode", "restore"):
        spans = tr.spans(name)
        assert len(spans) == len(chunks)
        assert all(s.parent is fetch and s.rid == reuse.rid for s in spans)
    assert [s.counts["tokens"] for s in tr.spans("restore")] == [
        r.token_end - r.token_start for r in chunks]
    (suffix,) = tr.spans("suffix prefill")
    (plain_span,) = tr.spans("plain prefill")
    assert (suffix.rid, suffix.counts["tokens"]) == (reuse.rid, N_SUF)
    assert (plain_span.rid, plain_span.counts["tokens"]) == (plain.rid,
                                                             N_PLAIN)
    assert suffix.parent is None and plain_span.parent is None
    decodes = tr.spans("decode step")
    assert len(decodes) == eng.stats.steps == 3  # 4 tokens, 1 prefilled
    assert all(s.parent is None and s.rid is None for s in decodes)
    for s in tr.done:
        assert s.t0 <= s.t1
        if s.parent is not None:
            assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1


def test_prefill_spans_count_the_dense_products(model):
    """Each prefill span and each decode step's carries the dense products
    its layers ran (q/k/v in one, the output projection, the MLP's two: 4
    a layer) and how many of them the 3xTF32 kernel took: none on the
    CPU."""
    cfg = model[0]
    tr = tracing.Tracer()
    serve(model, tr)
    (plain,) = tr.spans("plain prefill")
    (suffix,) = tr.spans("suffix prefill")
    steps = tr.spans("decode step")
    assert len(steps) == 3
    for span in (plain, suffix, *steps):
        assert span.counts["products"] == 4 * cfg.num_layers
        assert span.counts["tc_products"] == 0


def test_codec_time_lies_inside_its_fetch(model):
    tr = tracing.Tracer()
    serve(model, tr)
    (fetch,) = tr.spans("fetch")
    codec = tr.spans("codec decode")
    assert sum(s.seconds for s in codec) <= fetch.seconds
    for s in codec:
        assert 0.0 < s.counts["rans_s"] <= s.seconds


def test_a_codec_span_counts_only_its_own_rans_time(model, monkeypatch):
    """A codec kept across chunks sums its rANS time over all of them;
    each chunk's span still carries only its own."""
    kept = []

    def one_codec(*a, **k):
        if not kept:
            kept.append(KVCodec(*a, **k))
        return kept[0]

    monkeypatch.setattr(engine_mod, "KVCodec", one_codec)
    tr = tracing.Tracer()
    serve(model, tr)
    codec = tr.spans("codec decode")
    assert len(codec) > 1
    for s in codec:
        assert 0.0 < s.counts["rans_s"] <= s.seconds
    assert math.isclose(sum(s.counts["rans_s"] for s in codec),
                        kept[0].rans_s)


def test_prefill_span_ends_at_the_first_token(model):
    tr = tracing.Tracer()
    _, reuse, plain = serve(model, tr)
    for name, req in (("suffix prefill", reuse), ("plain prefill", plain)):
        (s,) = tr.spans(name)
        assert s.t1 == req.t_first_token
        assert req.t_admitted <= s.t0
    # queue + wait behind the step's other work + own prefill = TTFT
    (s,) = tr.spans("plain prefill")
    queue = plain.t_admitted - plain.arrival
    wait = s.t0 - plain.t_admitted
    assert math.isclose(queue + wait + s.seconds,
                        plain.t_first_token - plain.arrival, abs_tol=1e-3)


def test_virtual_clock_spans_are_host_time(model):
    tr = tracing.Tracer()
    _, reuse, _ = serve(model, tr, bandwidth=BandwidthTrace.constant(1.0))
    (s,) = tr.spans("suffix prefill")
    assert s.t1 != reuse.t_first_token  # virtual seconds, not host ones
    # the controller restores the chunks inside a step, with no fetch span
    codec = tr.spans("codec decode")
    assert codec and all(c.rid == reuse.rid for c in codec)
    assert tr.spans("fetch") == []


def test_no_record_function_outside_a_profiler_session(model, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    tr = tracing.Tracer()
    serve(model, tr)
    assert len(tr.done) > 0 and entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tr.span("inside"):
            pass
    assert entered == ["inside"]


def test_spans_are_profiler_ranges_in_a_session(model):
    tr = tracing.Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        serve(model, tr)
    ranges = {e.name for e in prof.events()}
    assert {"fetch", "codec decode", "restore", "suffix prefill",
            "plain prefill", "decode step"} <= ranges


def test_the_entry_points_the_benchmark_wraps_keep_their_names(
        model, monkeypatch):
    """The benchmark's traced run (``kvbench/profile.py``) wraps these
    three by name and passes over one it cannot find, which would give
    its idle gaps another label with no error: each keeps its name and
    signature, and the engine calls it through the attribute."""
    params = {
        (LiveEngine, "_run_fetch_wall"): ["self", "req", "plan"],
        (LiveEngine, "_prefill"): ["self", "req"],
        (paged_model, "decode_paged"): ["params", "cfg", "tokens",
                                        "positions", "cache", "seq_ids"],
    }
    calls = {}
    for (owner, attr), names in params.items():
        fn = getattr(owner, attr)
        assert list(inspect.signature(fn).parameters) == names

        def counted(*a, _fn=fn, _attr=attr, **k):
            calls[_attr] = calls.get(_attr, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(owner, attr, counted)
    eng, *_ = serve(model, tracing.Tracer())
    assert calls == {"_run_fetch_wall": 1, "_prefill": 2,
                     "decode_paged": eng.stats.steps}


def test_the_buffer_drops_its_oldest_spans_and_counts_them():
    tr = tracing.Tracer(capacity=3)
    for i in range(5):
        with tr.span("s", rid=i, i=i):
            pass
    assert tr.dropped == 2
    assert [s.rid for s in tr.done] == [2, 3, 4]
    assert [s.counts["i"] for s in tr.done] == [2, 3, 4]


def test_a_query_over_dropped_spans_returns_none():
    tr = tracing.Tracer(capacity=2)
    made = []
    for _ in range(3):
        with tr.span("s") as s:
            pass
        made.append(s)
    dropped, kept = made[0], made[1:]
    assert tr.spans("s") is None  # reaches back to the dropped span
    assert tr.spans("s", since=dropped.t1) is None
    assert tr.spans("other", since=dropped.t1) is None
    after = math.nextafter(dropped.t1, math.inf)
    assert tr.spans("s", since=after) == kept
    assert tr.spans("s", since=after, until=kept[0].t1) == kept[:1]
    assert tr.spans("other", since=after) == []


def test_a_span_nests_inside_the_open_one_and_keeps_its_counts():
    tr = tracing.Tracer()
    with tr.span("outer", rid=3) as outer:
        with tr.span("inner", rid=3, tokens=5) as inner:
            inner.counts["extra"] = 1.5
    assert inner.parent is outer and outer.parent is None
    assert tr.spans("inner")[0].counts == {"tokens": 5, "extra": 1.5}
    assert [s.name for s in tr.done] == ["inner", "outer"]
    with pytest.raises(ValueError):
        with tr.span("failed"):
            raise ValueError("recorded all the same")
    assert tr.spans("failed")[0].parent is None


def test_engine_records_into_the_process_tracer_by_default(model):
    cfg, params, *_ = model
    eng = LiveEngine(params, cfg, KVStore(), device="cpu")
    assert eng.tracer is tracing.TRACER


# -- the MoE layer's spans ------------------------------------------------------

def moe_serve(tracer, **submit):
    """A reduced deepseek-moe-16b (a dense first layer, then 3 MoE layers,
    routed as published) serving one reuse and one plain request."""
    cfg = reduce_config(get_config("deepseek-moe-16b"), num_layers=4)
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, N_PRE)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    store = KVStore()
    store.register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=16,
                          resolutions=("240p",))
    eng = LiveEngine(params, cfg, store, device="cpu", tracer=tracer)
    eng.submit(np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                    N_SUF)]),
               reuse_prefix=prefix_key(prefix), reuse_tokens=N_PRE,
               max_new_tokens=4)
    eng.submit(rng.integers(0, cfg.vocab_size, N_PLAIN), max_new_tokens=4)
    return cfg, eng


def test_a_moe_span_per_moe_layer_call_with_its_counts(monkeypatch):
    """Each prefill and decode step makes one ``moe`` span per MoE layer,
    inside the step's own span; ``tokens`` and ``choices`` are set when
    it opens, ``experts`` (distinct experts chosen) only at the step's
    readback of its tokens."""
    tr = tracing.Tracer()
    cfg, eng = moe_serve(tr)
    open_counts = []
    read_back = tr.read_back

    def checked(t):
        # before the readback the step's spans lack their expert counts
        open_counts.append(all("experts" not in s.counts
                               for s, _, _ in tr._deferred))
        return read_back(t)
    monkeypatch.setattr(tr, "read_back", checked)
    eng.run()
    assert open_counts and all(open_counts)
    n_moe = cfg.num_layers - 1
    spans = tr.spans("moe")
    parents = [s.parent.name for s in spans]
    for kind, n in (("plain prefill", N_PLAIN), ("suffix prefill", N_SUF)):
        mine = [s for s in spans if s.parent.name == kind]
        assert len(mine) == n_moe
        assert all(s.counts["tokens"] == n for s in mine)
    steps = len(tr.spans("decode step"))
    assert parents.count("decode step") == n_moe * steps
    assert len(spans) == n_moe * (2 + steps)
    E, k = cfg.num_experts, cfg.experts_per_token
    for s in spans:
        assert s.counts["choices"] == k * s.counts["tokens"]
        assert k <= s.counts["experts"] <= min(E, s.counts["choices"])
    assert not tr._deferred


HOST_READS = ("tolist", "item", "__int__", "__float__", "__bool__",
              "__index__", "numpy", "cpu")


def count_reads(monkeypatch):
    """Count the calls that bring a tensor's values to the host."""
    seen = {"n": 0}
    for name in HOST_READS:
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, **k):
            seen["n"] += 1
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return seen


def decode_step_reads(eng, monkeypatch) -> int:
    """Host reads of tensors in one decode-only step of ``eng``."""
    while any(r.t_first_token is None for r in eng.sched.running) \
            or not eng.sched.running:
        eng.step()
    with monkeypatch.context() as m:
        seen = count_reads(m)
        eng.step()
    return seen["n"]


def test_the_moe_spans_add_no_host_read(model, monkeypatch):
    """With the grouped op as on the card (no host read: here a stand-in
    that computes every expert densely and counts the chosen ones on the
    device), a decode step of the MoE engine reads tensors to the host
    exactly as often as a dense engine's step: once for the positions,
    once for the tokens with every ``moe`` span's count."""
    from repro_torch.models import moe

    def on_device(x, ids, wts, wi, wo):
        E = wi.shape[0]
        h = torch.einsum("nd,edcf->encf", x, wi)
        y = torch.einsum("enf,efd->end", torch.nn.functional.silu(
            h[:, :, 0]) * h[:, :, 1], wo)
        w = torch.zeros(x.shape[0], E).scatter(1, ids, wts)
        used = torch.zeros(E).scatter(0, ids.reshape(-1),
                                      torch.ones(ids.numel())) > 0
        return torch.einsum("ne,end->nd", w, y), used.sum().reshape(1)
    monkeypatch.setattr(moe, "moe_experts", on_device)
    tr = tracing.Tracer()
    _, eng = moe_serve(tr)
    moe_reads = decode_step_reads(eng, monkeypatch)
    cfg, params, prefix, kv_k, kv_v, rng = model
    dense = LiveEngine(params, cfg, KVStore(), device="cpu",
                       tracer=tracing.Tracer())
    for _ in range(2):
        dense.submit(rng.integers(0, cfg.vocab_size, N_PLAIN),
                     max_new_tokens=4)
    assert moe_reads == decode_step_reads(dense, monkeypatch) == 2
    assert all("experts" in s.counts for s in tr.spans("moe"))


def test_current_is_the_tracer_of_the_innermost_open_span():
    """Model code finds its tracer through ``tracing.current()``: the
    tracer whose span is open innermost, and none outside every span."""
    a, b = tracing.Tracer(), tracing.Tracer()
    assert tracing.current() is None
    with a.span("outer"):
        assert tracing.current() is a
        with b.span("inner"):
            assert tracing.current() is b
        assert tracing.current() is a
    assert tracing.current() is None
