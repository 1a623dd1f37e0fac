"""The readers of the program's own spans (``source: program_span``), on
synthetic spans recorded through the port's tracer and synthetic
requests: what each reads, at the window's edges, and ``None`` where the
tracer holds nothing for the window, dropped part of it, or the port has
no tracer."""
import sys
import types

import numpy as np
import pytest

from kvbench import harness, traffic
from repro_torch.serving import tracing

WINDOW = (10.0, 20.0)
NAMES = ["codec_s.p50", "rans_s.p50", "plain_prefill_tok_s",
         "prefill_wait_s.p95", "decode_step_span_ms.p50"]


def rec(rid, doc=None, admitted=None, fetch=None):
    req = types.SimpleNamespace(
        rid=rid, t_admitted=admitted,
        fetch_started=None if fetch is None else fetch[0],
        fetch_done=None if fetch is None else fetch[1])
    spec = traffic.Spec(0, np.zeros(4, np.int64), 4, doc=doc)
    return harness.Record(spec, 0.0, req, 0.0)


def add(tr, name, t0, t1, rid=None, **counts):
    """One span with the given times, recorded through the tracer."""
    with tr.span(name, rid, **counts) as s:
        s.t0, s.t1 = t0, t1


def run_of(records):
    return types.SimpleNamespace(records=records, window=WINDOW)


@pytest.fixture
def tracer(monkeypatch):
    tr = tracing.Tracer()
    monkeypatch.setattr(tracing, "TRACER", tr)
    return tr


def read(name, run):
    return harness.metric_reader(name).read(run)


def fetch_cell(tr):
    """Three fetches: two done in the window (one started before it),
    one done after it; and an older fetch of rid 1 outside its span."""
    recs = [rec(1, doc=0, fetch=(9.0, 12.0)),
            rec(2, doc=1, fetch=(15.0, 20.0)),
            rec(3, doc=0, fetch=(19.0, 20.5))]
    add(tr, "codec decode", 2.0, 3.0, rid=1, rans_s=0.9)  # an earlier run
    for rid, t, secs, rans in ((1, 9.1, 0.5, 0.3), (1, 10.5, 1.0, 0.6),
                               (2, 15.5, 2.0, 1.5), (3, 19.1, 0.2, 0.1)):
        add(tr, "codec decode", t, t + secs, rid=rid, rans_s=rans)
    add(tr, "fetch", 15.0, 20.0, rid=2, chunks=1)  # another name
    return run_of(recs)


def test_codec_and_rans_are_summed_per_fetch_done_in_the_window(tracer):
    run = fetch_cell(tracer)
    assert read("codec_s.p50", run) == pytest.approx(np.median([1.5, 2.0]))
    assert read("rans_s.p50", run) == pytest.approx(np.median([0.9, 1.5]))


def plain_cell(tr):
    recs = [rec(1, admitted=10.0), rec(2, admitted=12.0),
            rec(3, admitted=19.9), rec(4, admitted=9.5),
            rec(5, doc=0, admitted=11.0)]
    add(tr, "plain prefill", 10.0, 10.5, rid=1, tokens=100)  # starts on lo
    add(tr, "plain prefill", 12.25, 13.25, rid=2, tokens=300)
    add(tr, "plain prefill", 19.95, 20.0, rid=3, tokens=10)  # ends on hi
    add(tr, "plain prefill", 9.6, 9.8, rid=4, tokens=50)  # before the window
    add(tr, "suffix prefill", 11.5, 12.0, rid=5, tokens=32)
    add(tr, "plain prefill", 21.0, 22.0, rid=6, tokens=999)  # after it
    return run_of(recs)


def test_plain_prefill_rate_is_over_the_spans_ending_in_the_window(tracer):
    run = plain_cell(tracer)
    assert read("plain_prefill_tok_s", run) == pytest.approx(
        410 / (0.5 + 1.0 + 0.05))


def test_prefill_wait_is_admission_to_the_prefill_span(tracer):
    run = plain_cell(tracer)
    assert read("prefill_wait_s.p95", run) == pytest.approx(
        np.percentile([0.0, 0.25, 0.05], 95))


def test_decode_step_span_is_over_spans_inside_the_window(tracer):
    for t0, t1 in ((9.99, 10.05), (10.0, 10.06), (12.0, 12.07),
                   (19.92, 20.0), (19.99, 20.01)):
        add(tracer, "decode step", t0, t1, batch=4)
    assert read("decode_step_span_ms.p50", run_of([])) == pytest.approx(
        np.median([60.0, 70.0, 80.0]))


def full_run(tr):
    run = fetch_cell(tr)
    run.records += plain_cell(tr).records
    add(tr, "decode step", 12.0, 12.07, batch=4)
    return run


@pytest.mark.parametrize("name", NAMES)
def test_nothing_recorded_reads_none(tracer, name):
    assert read(name, run_of([rec(1, doc=0, fetch=(9.0, 12.0)),
                              rec(2, admitted=10.0)])) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_window_the_tracer_dropped_part_of_reads_none(monkeypatch, name):
    tr = tracing.Tracer(capacity=4)
    monkeypatch.setattr(tracing, "TRACER", tr)
    run = full_run(tr)
    assert tr.dropped and read(name, run) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_full_run_reads_every_metric(tracer, name):
    assert read(name, full_run(tracer)) is not None


@pytest.mark.parametrize("name", NAMES)
def test_a_port_without_the_tracer_reads_none(tracer, monkeypatch, name):
    import repro_torch.serving
    run = full_run(tracer)
    monkeypatch.delattr(repro_torch.serving, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.serving.tracing", None)
    assert read(name, run) is None
