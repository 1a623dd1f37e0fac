"""The readers of the grouped expert kernels (``moe_experts_roofline``,
``moe_experts_share.reuse``) on a fake traced run: the program's ``moe``
spans recorded through the port's tracer and a slice of fake device
records.  What each reads, which spans count (those inside the slice),
and ``None`` where a record or a count is missing or nothing ran."""
import types

import pytest

from kvbench import harness, moe_bound
from repro_torch.serving import tracing

MODEL = {"d_model": 2048, "d_ff": 1408}
SORT = "void (anonymous namespace)::moe_sort_kernel(long const*, int)"
SKINNY_UP = "void (anonymous namespace)::moe_skinny_kernel<true>(float)"
SKINNY_DOWN = "void (anonymous namespace)::moe_skinny_kernel<false>(float)"
TILED_UP = "void (anonymous namespace)::moe_tiled_kernel<32, true>(float)"
TILED_DOWN = "void (anonymous namespace)::moe_tiled_kernel<32, false>(float)"


class FakeSlice:
    def __init__(self, host, kernels, busy_s=0.5):
        self.host, self.kernels = host, kernels  # name -> list of seconds
        self.steps, self.busy_s = [], busy_s

    def kernel_time(self, *names):
        hit = [t for n, ts in self.kernels.items() for t in ts
               if any(s in n for s in names)]
        return sum(hit), len(hit)


@pytest.fixture
def tracer(monkeypatch):
    tr = tracing.Tracer()
    monkeypatch.setattr(tracing, "TRACER", tr)
    return tr


def moe_span(tr, t0, t1, tokens, experts, k=6):
    with tr.span("moe", tokens=tokens, choices=k * tokens) as s:
        s.t0, s.t1 = t0, t1
    if experts is not None:
        s.counts["experts"] = experts
    return s


def cell(tr, experts_late=6):
    """Two decode calls and a 256-token suffix call inside the slice
    (10, 20), one call before it and one that starts before it."""
    moe_span(tr, 5.0, 5.1, 1, 6)
    moe_span(tr, 9.9, 10.1, 1, 6)
    moe_span(tr, 11.0, 11.1, 1, 6)
    moe_span(tr, 12.0, 12.2, 256, 64)
    moe_span(tr, 13.0, 13.1, 1, experts_late)
    kernels = {SORT: [1e-6] * 3, SKINNY_UP: [40e-6] * 2,
               SKINNY_DOWN: [25e-6] * 2, TILED_UP: [700e-6],
               TILED_DOWN: [400e-6], "gemvx::kernel": [5e-3]}
    return types.SimpleNamespace(model=MODEL, trace=FakeSlice((10.0, 20.0),
                                                              kernels))


def read(name, run):
    return harness.metric_reader(name).read(run)


def test_roofline_is_the_launches_bounds_over_their_device_time(tracer):
    run = cell(tracer)
    bound = (2 * moe_bound.layer_bound_s(MODEL, 1, 6, 6)
             + moe_bound.layer_bound_s(MODEL, 256, 1536, 64))
    dev = 2 * 40e-6 + 2 * 25e-6 + 700e-6 + 400e-6
    assert read("moe_experts_roofline", run) == pytest.approx(
        100 * bound / dev)


def test_a_decode_call_is_bound_by_its_six_experts_weights():
    d, ff = 2048, 1408
    weights = 6 * 3 * d * ff * 4
    assert moe_bound.layer_bound_s(MODEL, 1, 6, 6) == pytest.approx(
        (weights + 4 * (d + 6 * ff + 6 * (ff + 1) + 6 * d)) / 3.35e12)
    # a 1,024-token prefill reaching every expert is bound by operations
    assert moe_bound.layer_bound_s(MODEL, 1024, 6144, 64) == pytest.approx(
        2 * 3 * d * ff * 6144 / 67e12)


def test_share_is_the_products_device_time_over_busy_time(tracer):
    run = cell(tracer)
    dev = 2 * 40e-6 + 2 * 25e-6 + 700e-6 + 400e-6
    assert read("moe_experts_share.reuse", run) == pytest.approx(
        100 * dev / 0.5)


def test_nothing_to_read(tracer):
    run = cell(tracer)
    # a call whose kernels lost their records
    run.trace.kernels[SORT] = [1e-6] * 2
    assert read("moe_experts_roofline", run) is None
    # a count never read back
    tr = tracing.Tracer()
    tracing.TRACER = tr
    run = cell(tr, experts_late=None)
    assert read("moe_experts_roofline", run) is None
    # a program without moe spans or kernels, and a run without a trace
    tracing.TRACER = tracing.Tracer()
    empty = types.SimpleNamespace(model=MODEL, trace=FakeSlice(
        (10.0, 20.0), {"gemvx::kernel": [1e-3]}))
    for name in ("moe_experts_roofline", "moe_experts_share.reuse"):
        assert read(name, empty) is None
        assert read(name, types.SimpleNamespace(model=MODEL,
                                                trace=None)) is None
