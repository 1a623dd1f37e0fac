"""The generator: deterministic per seed, the same sizes for every seed,
and what each mix file asks for."""
import json
import math

import numpy as np
import pytest

from kvbench import harness, traffic

MIXES = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))


def load(name):
    return json.loads((harness.HERE / "traffic" / f"{name}.json").read_text())


def key(specs):
    return [(s.tokens.tobytes(), s.max_new_tokens, s.doc, s.due, s.client)
            for s in specs]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    m = load(mix)
    assert key(traffic.requests(m, 2**31 + 7, 1000)) == key(
        traffic.requests(m, 2**31 + 7, 1000))
    assert traffic.documents(m, 5, 1000) == [] or all(
        np.array_equal(a, b) for a, b in zip(traffic.documents(m, 5, 1000),
                                             traffic.documents(m, 5, 1000)))


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_gets_the_same_sizes_in_another_order(mix):
    m = load(mix)
    m.pop("schedule_seed", None)  # the seed orders the schedule
    a, b = traffic.requests(m, 1, 1000), traffic.requests(m, 2, 1000)
    for size in (lambda s: len(s.tokens), lambda s: s.max_new_tokens):
        assert sorted(map(size, a)) == sorted(map(size, b))
    assert [len(s.tokens) for s in a] != [len(s.tokens) for s in b]
    if m["loop"] == "open":
        gaps = lambda ss: sorted(np.diff([s.due for s in ss]).round(9))
        # the same gaps but one, since the schedule starts at 0
        assert len(set(gaps(a)) ^ set(gaps(b))) <= 2


@pytest.mark.parametrize("mix", MIXES)
def test_a_schedule_seed_gives_every_seed_the_same_schedule(mix):
    m = dict(load(mix), schedule_seed=load(mix).get("schedule_seed", 5))
    a, b = traffic.requests(m, 1, 1000), traffic.requests(m, 2, 1000)
    sched = lambda ss: [(len(s.tokens), s.max_new_tokens, s.doc, s.due,
                         s.client) for s in ss]
    assert sched(a) == sched(b)
    assert not any(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))
    c = traffic.requests(dict(m, schedule_seed=m["schedule_seed"] + 1), 1,
                         1000)
    assert sched(c) != sched(a)


@pytest.mark.parametrize("mix", MIXES)
def test_requests_follow_the_mix_file(mix):
    m = load(mix)
    specs = traffic.requests(m, 99, 500)
    lo, hi = m["output_tokens"]
    assert all(lo <= s.max_new_tokens <= hi for s in specs)
    assert all(0 <= int(s.tokens.min()) and int(s.tokens.max()) < 500
               for s in specs)
    if "documents" in m:
        docs = traffic.documents(m, 99, 500)
        assert len(docs) == m["documents"]["count"]
        qlo, qhi = m["question_tokens"]
        for s in specs:
            d = docs[s.doc]
            assert s.reuse_tokens == len(d) == m["documents"]["tokens"]
            assert np.array_equal(s.tokens[:len(d)], d)
            assert qlo <= len(s.tokens) - len(d) <= qhi
    else:
        plo, phi = m["prompt_tokens"]
        assert all(plo <= len(s.tokens) <= phi and s.doc is None
                   for s in specs)
    if m["loop"] == "open":
        due = np.array([s.due for s in specs])
        assert due[0] == 0 and np.all(np.diff(due) > 0)
        rate = (len(due) - 1) / due[-1]
        assert rate == pytest.approx(m["rate_per_s"], rel=0.15)
    else:
        assert len(specs) == m["pool"] * m["clients"]
        assert {s.client for s in specs} == set(range(m["clients"]))


def test_loguniform_quantiles_cover_the_range():
    q = traffic.loguniform_quantiles(32, 256, 1000)
    assert q.min() == 32 and q.max() == 256 and np.all(np.diff(q) >= 0)
    # log-uniform: as many below the geometric mean as above it
    assert abs(np.mean(q < np.sqrt(32 * 257)) - 0.5) < 0.01


def test_rate_override_for_the_sweep():
    m = load("chat_plain")
    fast = traffic.requests(m, 1, 100, rate_per_s=4 * m["rate_per_s"])
    slow = traffic.requests(m, 1, 100)
    rate = lambda ss: (len(ss) - 1) / ss[-1].due
    assert rate(fast) == pytest.approx(4 * rate(slow), rel=0.15)
    ramp = lambda r: math.ceil(r * m["ramp_s"])
    assert len(fast) - len(slow) == ramp(4 * m["rate_per_s"]) \
        - ramp(m["rate_per_s"])


@pytest.mark.parametrize("mix", [m for m in MIXES
                                 if load(m)["loop"] == "open"])
def test_an_open_window_opens_on_the_same_requests_for_every_seed(mix):
    m = load(mix)
    a, b = traffic.requests(m, 1, 1000), traffic.requests(m, 2, 1000)
    k = math.ceil(m["rate_per_s"] * m["ramp_s"])
    assert len(a) == len(b) == k + m["pool"]
    for size in (lambda s: len(s.tokens), lambda s: s.max_new_tokens):
        assert sorted(map(size, a[k:])) == sorted(map(size, b[k:]))
    # the ramp spans the same time, so the window part starts together
    assert a[k].due == pytest.approx(b[k].due)
