"""The port's cluster simulator and traces on the CPU, held against the
JAX package's.

``repro_torch.data.workload`` and ``repro_torch.cluster.simulator`` are
copies of the JAX modules with only the imports renamed.  Every workload
generator, given the same seed, must return the same requests field by
field; the six method specs must be equal; and every scenario of
``tests/test_simulator.py``, with one storage, one WAN-loss and one
fairness scenario of ``tests/test_storage.py``, ``tests/test_wan.py`` and
``tests/test_fairness.py``, must give equal ``SimResult``s (every field
of every ``Request`` included) and equal event logs when run once with
each package's classes.
"""
import dataclasses
import enum
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.cluster.fairness as j_fairness  # noqa: E402
import repro.cluster.network as j_network  # noqa: E402
import repro.cluster.simulator as j_sim  # noqa: E402
import repro.cluster.storage as j_storage  # noqa: E402
import repro.core.adaptive as j_adaptive  # noqa: E402
import repro.core.scheduler as j_scheduler  # noqa: E402
import repro.data.workload as j_workload  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402

import repro_torch.cluster.fairness as t_fairness  # noqa: E402
import repro_torch.cluster.network as t_network  # noqa: E402
import repro_torch.cluster.simulator as t_sim  # noqa: E402
import repro_torch.cluster.storage as t_storage  # noqa: E402
import repro_torch.core.adaptive as t_adaptive  # noqa: E402
import repro_torch.core.scheduler as t_scheduler  # noqa: E402
import repro_torch.data.workload as t_workload  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402

JAX = types.SimpleNamespace(
    sim=j_sim, wl=j_workload, net=j_network, adaptive=j_adaptive,
    storage=j_storage, fairness=j_fairness, scheduler=j_scheduler,
    get_config=j_get_config)
PORT = types.SimpleNamespace(
    sim=t_sim, wl=t_workload, net=t_network, adaptive=t_adaptive,
    storage=t_storage, fairness=t_fairness, scheduler=t_scheduler,
    get_config=t_get_config)
RATIOS = {"240p": 9.0, "480p": 8.5, "640p": 8.0, "1080p": 7.0}


def plain(x):
    """``x`` with every dataclass as a dict of its fields, every enum as
    its value and every ``Request``'s ``ttft``/``tpot`` added, so results
    of the two packages' classes compare with ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = {f.name: plain(getattr(x, f.name))
               for f in dataclasses.fields(x)}
        if hasattr(x, "ttft"):
            out.update(ttft=x.ttft, tpot=x.tpot)
        return out
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def _both(fn):
    """``fn(ns)`` for the JAX package and for the port, made plain."""
    return plain(fn(JAX)), plain(fn(PORT))


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def _specs(ns):
    return ns.wl.prefix_trie_specs(3, 3, base_tokens=30_000,
                                   ext_tokens=10_000)


GENERATORS = {
    "poisson_trace": lambda ns, rng: ns.wl.poisson_trace(
        rng, n_requests=30, rate=0.5, prompt_lens=(2_000, 90_000),
        reuse_threshold=40_000),
    "fixed_context_trace": lambda ns, rng: ns.wl.fixed_context_trace(
        60_000, n_requests=5, gap=12.5),
    "wan_burst_trace": lambda ns, rng: ns.wl.wan_burst_trace(
        rng, 50_000, n_requests=6, window=1.5,
        weights=[1.0, 2.0, 1.0, 4.0, 1.0, 2.0]),
    "prefix_trie_specs": lambda ns, rng: _specs(ns),
    "zipf_prefix_trace": lambda ns, rng: ns.wl.zipf_prefix_trace(
        rng, _specs(ns), n_requests=40, alpha=1.1, gap=7.0),
    "session_trace": lambda ns, rng: ns.wl.session_trace(
        rng, _specs(ns), n_sessions=8, continue_p=0.7),
    "zipf_user_population": lambda ns, rng: ns.wl.zipf_user_population(
        rng, _specs(ns), n_users=9, n_requests=30, n_abusers=2,
        abuse_burst=5),
    "churn_schedule": lambda ns, rng: ns.wl.churn_schedule(
        rng, ["n0", "n1", "n2", "n3"], n_failures=5, gap=150.0,
        downtime=400.0),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_workload_generator_matches_jax(name):
    gen = GENERATORS[name]
    a, b = _both(lambda ns: gen(ns, np.random.default_rng(2026)))
    assert a == b and len(a) > 1


def test_method_specs_match_jax():
    def specs(ns):
        s = ns.sim
        return [s.kvfetcher_spec(RATIOS), s.llm265_spec(5.0),
                s.cachegen_spec(3.5), s.raw_spec(), s.lmcache_raw_spec(),
                s.full_prefill_spec(), s.MethodSpec("plain")]
    a, b = _both(specs)
    assert a == b
    assert [s["name"] for s in b] == ["kvfetcher", "llm265", "cachegen",
                                      "raw", "lmcache_raw", "full_prefill",
                                      "plain"]
    assert t_sim.RESOLUTIONS == j_sim.RESOLUTIONS


# ---------------------------------------------------------------------------
# the scenarios of tests/test_simulator.py
# ---------------------------------------------------------------------------

def _run(ns, method, *, gbps=16.0, ctx=100_000, n=3, trace=None, **kw):
    bw = trace or ns.net.BandwidthTrace.constant(gbps)
    sim = ns.sim.ServingSimulator(ns.get_config("yi-34b"), method,
                                  chip="h20", n_chips=2, bandwidth=bw,
                                  table=ns.adaptive.H20_TABLE, **kw)
    reqs = ns.wl.fixed_context_trace(ctx, n_requests=n, gap=60.0)
    return sim.run(reqs, max_new_tokens=8)


def _nonreuse(ns):
    out = []
    for spec in (ns.sim.kvfetcher_spec(RATIOS), ns.sim.cachegen_spec(3.5)):
        reqs = ns.wl.poisson_trace(np.random.default_rng(0), n_requests=12,
                                   rate=0.5, prompt_lens=(2_000, 90_000),
                                   reuse_threshold=40_000)
        sim = ns.sim.ServingSimulator(
            ns.get_config("yi-34b"), spec,
            bandwidth=ns.net.BandwidthTrace.constant(4.0),
            table=ns.adaptive.H20_TABLE)
        out.append(sim.run(reqs, max_new_tokens=8))
    return out


def _jitter(ns):
    trace = ns.net.BandwidthTrace.steps(
        [(0, 6), (5, 3), (15, 4), (25, 2), (35, 6), (45, 3)])
    fixed = dataclasses.replace(ns.sim.kvfetcher_spec(RATIOS),
                                adaptive=False, fixed_resolution="1080p",
                                name="fixed")
    return [_run(ns, ns.sim.kvfetcher_spec(RATIOS), trace=trace, n=2),
            _run(ns, fixed, trace=trace, n=2)]


#: test_simulator.py's scenarios: name -> the SimResults its test reads
SIM_SCENARIOS = {
    "kvfetcher_beats_raw_and_full_prefill_on_slow_network": lambda ns: [
        _run(ns, ns.sim.kvfetcher_spec(RATIOS), gbps=16),
        _run(ns, ns.sim.raw_spec(), gbps=16),
        _run(ns, ns.sim.full_prefill_spec(), gbps=16)],
    "kvfetcher_beats_cachegen_at_low_bandwidth": lambda ns: [
        _run(ns, ns.sim.kvfetcher_spec(RATIOS), gbps=8),
        _run(ns, ns.sim.cachegen_spec(ratio=3.5), gbps=8)],
    "blocking_fetch_is_worse_than_pipelined": lambda ns: [
        _run(ns, ns.sim.kvfetcher_spec(RATIOS), gbps=8),
        _run(ns, ns.sim.lmcache_raw_spec(), gbps=8)],
    "nonreuse_requests_not_blocked_by_fetches": _nonreuse,
    "adaptive_resolution_helps_under_jitter": _jitter,
    "framewise_restoration_memory": lambda ns: [
        _run(ns, ns.sim.kvfetcher_spec(RATIOS), gbps=16, n=1),
        _run(ns, ns.sim.llm265_spec(5.0), gbps=16, n=1)],
    "decode_pool_utilized": lambda ns: [
        _run(ns, ns.sim.kvfetcher_spec(RATIOS), gbps=16, n=2)],
    "ttft_grows_with_context": lambda ns: [
        _run(ns, ns.sim.kvfetcher_spec(RATIOS), ctx=50_000, n=2),
        _run(ns, ns.sim.kvfetcher_spec(RATIOS), ctx=150_000, n=2)],
}


@pytest.mark.parametrize("name", list(SIM_SCENARIOS))
def test_simulator_scenario_matches_jax(name):
    a, b = _both(SIM_SCENARIOS[name])
    assert a == b
    for res in b:
        assert res["requests"] and res["sim_time"] > 0
        assert all(r["t_first_token"] is not None for r in res["requests"])


# ---------------------------------------------------------------------------
# one storage, one WAN-loss and one fairness scenario
# ---------------------------------------------------------------------------

def test_storage_failure_scenario_matches_jax():
    """test_storage.py::test_sim_scripted_failure_unreplicated_pays_full_
    prefill: the only holder fails mid-trace, the next ask misses, the
    link heal lands after it, a later ask hits again."""
    def run(ns):
        cfg = ns.get_config("yi-34b")
        specs = ns.wl.prefix_trie_specs(2, 1, base_tokens=40_000)
        nodes = [ns.storage.StorageNode(
            f"n{i}", link=ns.net.BandwidthTrace.constant(8.0))
            for i in range(3)]
        cluster = ns.storage.StorageCluster(nodes, replication=1,
                                            heal="link")
        for s in specs:
            cluster.register(ns.storage.synthetic_stored_prefix(
                s.key, s.n_tokens,
                raw_bytes_per_token=cfg.kv_bytes_per_token(),
                ratios=RATIOS, parent=s.parent), 0.0)
        victim = cluster.primary_node(specs[0].key).node_id
        reqs = [ns.scheduler.Request(rid=i, arrival=t, prompt_len=41_000,
                                     reuse_tokens=40_000,
                                     prefix=specs[0].key)
                for i, t in enumerate((10.0, 301.0, 900.0))]
        sim = ns.sim.ServingSimulator(
            cfg, ns.sim.kvfetcher_spec(RATIOS), chip="h20", n_chips=2,
            bandwidth=ns.net.BandwidthTrace.constant(8.0), storage=cluster,
            table=ns.adaptive.H20_TABLE, fail_at=[(300.0, victim)])
        return sim.run(reqs, max_new_tokens=4), list(cluster.events)

    (res_a, ev_a), (res_b, ev_b) = _both(run)
    assert ev_a == ev_b and res_a == res_b
    assert [r["storage_hit"] for r in res_b["requests"]] == \
        ["full", "miss", "full"]
    assert {"fail", "heal", "miss"} <= {e[0] for e in ev_b}


def test_wan_loss_scenario_matches_jax():
    """test_wan.py::test_max_attempts_exhaustion_falls_back_to_full_
    prefill: chunk 0 lost on every allowed attempt aborts the fetch into
    a full prefill; beside it the clean run and a seeded Bernoulli loss
    on a DRR link over a burst of weighted fetches."""
    def run(ns):
        cfg = ns.get_config("yi-34b")
        spec = ns.sim.MethodSpec("kvfetcher", ratios={"stream": 8.0},
                                 adaptive=False, fixed_resolution="1080p",
                                 uses_decode_pool=False,
                                 layerwise_admission=True, max_attempts=3)
        out = []
        for loss in (ns.net.LossModel.scripted({(0, 0, 1), (0, 0, 2),
                                                (0, 0, 3)}), None):
            req = ns.scheduler.Request(rid=0, arrival=0.0,
                                       prompt_len=22_000,
                                       reuse_tokens=20_000, prefix="p",
                                       max_new_tokens=4)
            sim = ns.sim.ServingSimulator(
                cfg, spec, chip="h20", n_chips=2,
                bandwidth=ns.net.BandwidthTrace.constant(8.0), loss=loss)
            out.append((sim.run([req], max_new_tokens=4),
                        None if loss is None else list(loss.drops)))
        loss = ns.net.LossModel.bernoulli(0.2, seed=5)
        burst = ns.wl.wan_burst_trace(np.random.default_rng(3), 20_000,
                                      n_requests=4, weights=[1, 2, 1, 3],
                                      max_new_tokens=4)
        sim = ns.sim.ServingSimulator(
            cfg, ns.sim.kvfetcher_spec(RATIOS), chip="h20", n_chips=2,
            bandwidth=ns.net.BandwidthTrace.constant(2.0), loss=loss,
            link_policy="drr", link_ramp="slowstart",
            table=ns.adaptive.H20_TABLE)
        out.append((sim.run(burst, max_new_tokens=4), list(loss.drops)))
        return out

    a, b = _both(run)
    assert a == b
    (lost, drops), (clean, _), (burst, burst_drops) = b
    assert lost["requests"][0]["storage_hit"] == "miss"
    assert lost["retransmits"] == 2 and len(drops) == 3
    assert lost["requests"][0]["ttft"] > clean["requests"][0]["ttft"]
    assert burst["retransmits"] > 0 and burst_drops


def test_fairness_scenario_matches_jax():
    """test_fairness.py::test_fair_dispatch_beats_fcfs_under_abusive_
    flood, FCFS and fair dispatch: equal results and fairness logs."""
    def run(ns):
        cfg = ns.get_config("yi-34b")
        specs = ns.wl.prefix_trie_specs(2, 1, base_tokens=40_000)
        out = []
        for fair in (False, True):
            reqs = ns.wl.zipf_user_population(
                np.random.default_rng(7), specs, n_users=6, n_requests=12,
                abuse_burst=10, gap=6.0)
            sim = ns.sim.ServingSimulator(
                cfg, ns.sim.kvfetcher_spec(RATIOS),
                bandwidth=ns.net.BandwidthTrace.constant(8.0),
                table=ns.adaptive.H20_TABLE,
                fairness=(ns.fairness.FairScheduler(max_inflight=2)
                          if fair else None))
            out.append(sim.run(reqs, max_new_tokens=8))
        return out

    a, b = _both(run)
    assert a == b
    fcfs, fair = b
    assert not fcfs["fairness_events"]
    kinds = {e[2] for e in fair["fairness_events"]}
    assert {"arrive", "dispatch", "fetched", "serve"} <= kinds
