"""What the metrics are taken over, on synthetic timestamps."""
import types

import numpy as np
import pytest

from kvbench import flops, harness, readers, stats, traffic, weights
from kvbench.tests import tiny


def rec(due, first=None, times=(), arrival=None, admitted=None,
        fetch=None, doc=None):
    req = types.SimpleNamespace(
        t_first_token=first, token_times=list(times),
        arrival=due + 5.0 if arrival is None else arrival,
        t_admitted=admitted, fetch_started=None if fetch is None
        else fetch[0], fetch_done=None if fetch is None else fetch[1])
    spec = traffic.Spec(0, np.zeros(4, np.int64), 4, doc=doc)
    return harness.Record(spec, due, req, due)


WINDOW = (10.0, 20.0)


def test_ttft_is_taken_from_the_due_time_not_the_arrival():
    r = rec(9.0, first=11.5, arrival=11.0)  # submitted late by a stall
    assert stats.ttfts([r], WINDOW) == [pytest.approx(2.5)]


def test_ttft_counts_first_tokens_inside_the_window_only():
    rs = [rec(5.0, first=9.9), rec(9.0, first=10.0), rec(19.0, first=20.0),
          rec(19.5, first=20.1)]
    assert stats.ttfts(rs, WINDOW) == pytest.approx([1.0, 1.0])


def test_ttft_splits_reuse_and_plain():
    rs = [rec(10.0, first=12.0, doc=0), rec(10.0, first=11.0)]
    assert stats.ttfts(rs, WINDOW, reuse=True) == [pytest.approx(2.0)]
    assert stats.ttfts(rs, WINDOW, reuse=False) == [pytest.approx(1.0)]


def test_plain_ttft_reader_takes_the_90th_percentile_of_plain_requests():
    reader = harness.metric_reader("ttft_plain_p90_s")
    plain = [rec(10.0, first=10.0 + 0.1 * i) for i in range(1, 11)]
    reuse = [rec(10.0, first=19.0, doc=0)]  # no plain request's time
    run = run_of([], {})
    run.records = plain + reuse
    want = float(np.percentile([0.1 * i for i in range(1, 11)], 90))
    assert reader.read(run) == pytest.approx(want)
    run.records = reuse
    assert reader.read(run) is None


def test_itl_is_over_every_gap_with_both_tokens_in_the_window():
    rs = [rec(0.0, first=9.0, times=[9.0, 10.5, 11.0, 14.0]),
          rec(0.0, first=18.0, times=[18.0, 19.0, 21.0])]
    assert sorted(stats.gaps(rs, WINDOW)) == pytest.approx([0.5, 1.0, 3.0])


def test_a_stall_shows_in_the_itl_tail():
    # one gap in ten is a 0.5 s stall (a prefill in the batch's step)
    gaps = ([0.05] * 9 + [0.5]) * 4
    times = 10.0 + np.concatenate([[0.0], np.cumsum(gaps)])
    got = stats.gaps([rec(0, first=10.0, times=times)], WINDOW)
    assert stats.percentile(got, 50) == pytest.approx(0.05)
    assert stats.percentile(got, 95) == pytest.approx(0.5)


@pytest.mark.parametrize("q", [50, 95, 99])
@pytest.mark.parametrize("n", [1, 2, 7, 40])
def test_percentile_rule_is_linear_between_closest_ranks(q, n):
    v = np.random.default_rng(n).random(n)
    assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q))
    s = np.sort(v)
    pos = (n - 1) * q / 100
    lo = int(np.floor(pos))
    want = s[lo] + (s[min(lo + 1, n - 1)] - s[lo]) * (pos - lo)
    assert stats.percentile(v, q) == pytest.approx(want)


def test_no_value_no_percentile():
    assert stats.percentile([], 95) is None
    assert readers.p([], 50) is None


def test_queue_waits_and_fetch_times():
    rs = [rec(9.0, admitted=10.5), rec(12.0, admitted=12.25, doc=1,
                                       fetch=(12.0, 15.0)),
          rec(1.0, admitted=2.0, fetch=(1.0, 9.0))]
    assert stats.queue_waits(rs, WINDOW, reuse=False) == [pytest.approx(1.5)]
    assert stats.fetch_times(rs, WINDOW) == [pytest.approx(3.0)]


def step(t0, t1, prefills=(), decodes=(), fetches=()):
    return harness.Step(t0, t1, list(prefills), list(decodes),
                        list(fetches))


def run_of(steps, model, trace=None, chunks=None):
    return harness.Run(model, {"page_size": 16}, {}, [], steps, WINDOW, 1.0,
                       chunks or {}, trace)


def test_decode_step_time_is_over_decode_only_steps():
    reader = harness.metric_reader("decode_step_ms.p50")
    steps = [step(11.0, 11.05, decodes=[100]),
             step(12.0, 12.5, prefills=[(0, 64)], decodes=[65]),
             step(13.0, 13.07, decodes=[101, 200]),
             step(14.0, 17.0, fetches=[1024], decodes=[7]),
             step(9.0, 9.01, decodes=[5])]
    assert reader.read(run_of(steps, {})) == pytest.approx(60.0)


def yi():
    return harness.load_json(harness.HERE / "configs" / "yi-9b.json")


def moe():
    return tiny.config(tiny.MOE, "tiny-moe")


@pytest.mark.parametrize("cfg", [yi, moe])
def test_token_flops_are_twice_the_active_parameters(cfg):
    c = cfg()
    m = c["model"]
    n = weights.n_params(m, c["weights"])
    d, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    norms = d * (2 * L + 1)
    outside = 2 * V * d + norms  # embedding, head, norms
    if m.get("num_experts"):
        E, k, s = m["num_experts"], m["experts_per_token"], \
            m["num_shared_experts"]
        inactive = (L - 1) * (E - k) * 3 * d * m["d_ff"]
    else:
        inactive = 0
    body = n - outside - inactive
    assert flops.token_flops(m, 0) == pytest.approx(2 * body)
    assert flops.decode_flops(m, 0) == pytest.approx(2 * body + 2 * d * V)


def test_prefill_flops_sum_the_contexts_of_its_tokens():
    m = yi()["model"]
    one = [flops.token_flops(m, 300 + i + 1) for i in range(5)]
    assert flops.prefill_flops(m, 300, 5) == pytest.approx(
        sum(one) + flops.logits_flops(m))


class FakeSlice:
    def __init__(self, steps, wall, kernels):
        self.steps, self.wall_s = steps, wall
        self.kernels = kernels  # name -> list of seconds
        self.busy_s, self.window_s = 0.25, wall

    def kernel_time(self, *names):
        hit = [t for n, ts in self.kernels.items() for t in ts
               if any(s in n for s in names)]
        return sum(hit), len(hit)


def test_mfu_is_the_slice_work_over_its_wall_time_at_peak():
    m = yi()["model"]
    steps = [step(0, 1, prefills=[(0, 100)], decodes=[101, 50]),
             step(1, 2, decodes=[102])]
    want = (flops.prefill_flops(m, 0, 100) + flops.decode_flops(m, 101)
            + flops.decode_flops(m, 50) + flops.decode_flops(m, 102))
    r = run_of(steps, m, FakeSlice(steps, 2.0, {}))
    assert readers.model_mfu(r) == pytest.approx(
        100 * want / (2.0 * flops.FP32_FLOPS_PER_S))


def test_roofline_needs_a_record_of_every_call():
    m = yi()["model"]
    steps = [step(0, 1, decodes=[100, 200]), step(1, 2, decodes=[101])]
    bound = m["num_layers"] * (
        flops.paged_attention_bound_s(m, [100, 200], 16)
        + flops.paged_attention_bound_s(m, [101], 16))
    reader = harness.metric_reader("paged_attention_roofline")
    full = {"void paged_attention_split_kernel<4, 4>(float)":
            [1e-5] * (2 * m["num_layers"]),
            "paged_attention_merge_kernel": [1e-6] * 10}
    r = run_of(steps, m, FakeSlice(steps, 2.0, full))
    dev = 2 * m["num_layers"] * 1e-5 + 10e-6
    assert reader.read(r) == pytest.approx(100 * bound / dev)
    lost = dict(full)
    lost["void paged_attention_split_kernel<4, 4>(float)"] = [1e-5] * 5
    assert reader.read(run_of(steps, m, FakeSlice(steps, 2.0, lost))) \
        is None


def test_kv_restore_roofline_counts_the_stored_chunks():
    m = yi()["model"]
    chunks = {1024: [(3, 1024)] * 32}
    steps = [step(0, 3, fetches=[1024], decodes=[])]
    reader = harness.metric_reader("kv_restore_roofline")
    r = run_of(steps, m, FakeSlice(steps, 3.0, {"kv_restore_kernel":
                                                [2e-5] * 32}), chunks)
    want = 32 * flops.kv_restore_bound_s(m, 3, 1024)
    assert reader.read(r) == pytest.approx(100 * want / (32 * 2e-5))


def test_idle_share_and_readers_without_a_trace():
    r = run_of([], {}, FakeSlice([], 1.0, {}))
    assert readers.idle_share(r) == pytest.approx(75.0)
    for name in ("model_mfu.chat", "idle_share.reuse",
                 "paged_attention_roofline", "kv_restore_roofline"):
        assert harness.metric_reader(name).read(run_of([], {})) is None


def test_union_of_device_intervals():
    from kvbench.profile import union
    assert union([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
