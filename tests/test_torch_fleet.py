"""The port's fleet on the CPU, held against the JAX package's.

``repro_torch.cluster.fleet`` copies the router, the node-local KV model,
``FleetSimulator`` and ``LiveFleet`` of the JAX module; its ``LiveFleet``
builds the port's ``LiveEngine``s.  The router scenarios of
``tests/test_fleet.py`` must give equal placement logs, ``_LocalKV`` must
evict in the same order, the analytic ``FleetSimulator`` must give an
equal ``FleetResult`` under ``affinity`` and ``random``, and on the
cross-environment replay scenario of ``tests/test_fleet.py`` the port's
``LiveFleet`` (CPU, weights bridged from the JAX init) must give router,
fairness and cluster-lookup events, placements, local hits and tokens
equal to the JAX ``LiveFleet``'s, and events equal to the port's own
``FleetSimulator``'s.
"""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.costmodel as j_cost  # noqa: E402
import repro.cluster.fairness as j_fairness  # noqa: E402
import repro.cluster.fleet as j_fleet  # noqa: E402
import repro.cluster.network as j_network  # noqa: E402
import repro.cluster.simulator as j_sim  # noqa: E402
import repro.cluster.storage as j_storage  # noqa: E402
import repro.core.adaptive as j_adaptive  # noqa: E402
import repro.core.scheduler as j_scheduler  # noqa: E402
import repro.data.workload as j_workload  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402

import repro_torch.cluster.costmodel as t_cost  # noqa: E402
import repro_torch.cluster.fairness as t_fairness  # noqa: E402
import repro_torch.cluster.fleet as t_fleet  # noqa: E402
import repro_torch.cluster.network as t_network  # noqa: E402
import repro_torch.cluster.simulator as t_sim  # noqa: E402
import repro_torch.cluster.storage as t_storage  # noqa: E402
import repro_torch.core.adaptive as t_adaptive  # noqa: E402
import repro_torch.core.scheduler as t_scheduler  # noqa: E402
import repro_torch.data.workload as t_workload  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402

from test_torch_simulator import plain  # noqa: E402

JAX = types.SimpleNamespace(
    fleet=j_fleet, sim=j_sim, wl=j_workload, net=j_network,
    storage=j_storage, fairness=j_fairness, adaptive=j_adaptive,
    cost=j_cost, scheduler=j_scheduler, get_config=j_get_config)
PORT = types.SimpleNamespace(
    fleet=t_fleet, sim=t_sim, wl=t_workload, net=t_network,
    storage=t_storage, fairness=t_fairness, adaptive=t_adaptive,
    cost=t_cost, scheduler=t_scheduler, get_config=t_get_config)
RATIOS = {"240p": 9.0, "480p": 8.5, "640p": 8.0, "1080p": 7.0}


def _both(fn):
    return plain(fn(JAX)), plain(fn(PORT))


def _req(ns, rid, prefix=None, reuse=1_000):
    return ns.scheduler.Request(rid=rid, arrival=0.0, prompt_len=reuse + 100,
                                reuse_tokens=reuse, prefix=prefix,
                                max_new_tokens=4)


# ---------------------------------------------------------------------------
# the router scenarios of tests/test_fleet.py
# ---------------------------------------------------------------------------

def _sticky(ns):
    r = ns.fleet.FleetRouter(8, policy="affinity")
    return r, [r.place(_req(ns, rid, "p.hot")) for rid in range(5)]


def _replay(ns):
    r = ns.fleet.FleetRouter(8, policy="affinity")
    return r, [r.place(_req(ns, rid, key, 1_000 if key else 0))
               for rid, key in enumerate(["a", "b", "a", "c", "a", None,
                                          "b"])]


def _chains(ns):
    parents = {"root": None, "root.c": "root", "root.c.g": "root.c"}
    r = ns.fleet.FleetRouter(8, policy="affinity", parent_of=parents.get)
    return r, [r.place(_req(ns, rid, key))
               for rid, key in enumerate(["root", "root.c", "root.c.g"])]


def _fallback(ns):
    r = ns.fleet.FleetRouter(4, policy="affinity")
    return r, [r.place(_req(ns, 0, "p")), r.place(_req(ns, 1, None, 0))]


def _spill(ns):
    r = ns.fleet.FleetRouter(4, policy="affinity", spill_factor=1.0,
                             spill_slack=2)
    return r, [r.place(_req(ns, rid, "p.hot")) for rid in range(12)]


def _least_loaded(ns):
    r = ns.fleet.FleetRouter(4, policy="least_loaded")
    return r, [r.place(_req(ns, rid, "p.hot")) for rid in range(8)]


def _random(ns):
    r = ns.fleet.FleetRouter(8, policy="random")
    return r, [r.place(_req(ns, rid)) for rid in reversed(range(16))]


ROUTER_SCENARIOS = {"sticky": _sticky, "replays": _replay,
                    "ancestor_chains": _chains, "no_prefix": _fallback,
                    "spill": _spill, "least_loaded": _least_loaded,
                    "random": _random}


@pytest.mark.parametrize("name", list(ROUTER_SCENARIOS))
def test_router_scenario_matches_jax(name):
    def run(ns):
        r, placed = ROUTER_SCENARIOS[name](ns)
        return placed, r.events, r.assigned, r.sticky
    a, b = _both(run)
    assert a == b and b[1]
    if name == "spill":
        assert "spill" in {e[3] for e in b[1]}


def test_router_policies_and_refusal_match_jax():
    assert t_fleet.FLEET_POLICIES == j_fleet.FLEET_POLICIES
    with pytest.raises(AssertionError):
        t_fleet.FleetRouter(4, policy="round_robin")


def test_local_kv_evicts_in_jax_order():
    """A seeded sequence of puts and hits, larger than the capacity: the
    same hits and the same resident entries, in LRU order, after every
    operation."""
    rng = np.random.default_rng(5)
    ops = [(("put" if rng.random() < 0.5 else "hit"),
            f"k{int(rng.integers(8))}", int(rng.integers(10, 60)))
           for _ in range(200)] + [("put", "huge", 1_000)]

    def run(ns):
        kv = ns.fleet._LocalKV(150)
        out = []
        for op, key, n in ops:
            got = kv.put(key, n) if op == "put" else kv.hit(key, n)
            out.append((got, list(kv._entries.items()),
                        kv.resident_tokens))
        return out
    a, b = _both(run)
    assert a == b
    assert any(r[0] for r in b) and not any(k == "huge" for k, _ in b[-1][1])


# ---------------------------------------------------------------------------
# the analytic fleet of tests/test_fleet.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["affinity", "random"])
def test_fleet_simulator_matches_jax(policy):
    def run(ns):
        cfg = ns.get_config("yi-34b")
        specs = ns.wl.prefix_trie_specs(4, 2)
        nodes = [ns.storage.StorageNode(
            f"n{i}", link=ns.net.BandwidthTrace.constant(4.0))
            for i in range(3)]
        cluster = ns.storage.StorageCluster(nodes, replication=2)
        for sp in specs:
            cluster.register(ns.storage.synthetic_stored_prefix(
                sp.key, sp.n_tokens,
                raw_bytes_per_token=cfg.kv_bytes_per_token(),
                ratios=RATIOS, parent=sp.parent), 0.0)
        reqs = ns.wl.zipf_prefix_trace(np.random.default_rng(42), specs,
                                       n_requests=24, alpha=1.1, gap=5.0,
                                       max_new_tokens=4)
        fleet = ns.fleet.FleetSimulator(
            cfg, ns.sim.kvfetcher_spec(RATIOS), n_nodes=8,
            bandwidth=ns.net.BandwidthTrace.constant(8.0), storage=cluster,
            policy=policy, local_kv_tokens=150_000)
        res = fleet.run(reqs, max_new_tokens=4)
        return res, res.local_hits, list(cluster.events)
    a, b = _both(run)
    assert a == b
    res, local_hits, _ = b
    assert len(res["router_events"]) == 24
    assert all(r["ttft"] is not None for r in res["requests"])
    if policy == "affinity":
        assert local_hits > 0


# ---------------------------------------------------------------------------
# the live replay of tests/test_fleet.py
# ---------------------------------------------------------------------------

TABLE_KW = dict(name="fleet-toy", n_decoders=1, latency={"240p": (0.06,)},
                penalty={"240p": 0.0}, chunk_size_mb={"240p": 0.002})
N_NODES = 8
LOCAL_TOKENS = 128
#: the dispatch-ordered kinds of cluster event (admission rides on a
#: recompute's first token, a clock)
LOOKUP_KINDS = ("full", "partial", "miss", "fail", "recover", "replicate")
#: (user, tier, prefix name) in submit order, skewed toward "a"; "d"
#: shares a's storage node, is asked once and misses
SCRIPT = [("alice", "premium", "a"), ("bob", "standard", "b"),
          ("alice", "premium", "a"), ("mallory", "free", "c"),
          ("bob", "standard", "a"), ("alice", "premium", "b"),
          ("mallory", "free", "a"), ("bob", "standard", "c"),
          ("alice", "premium", "a"), ("mallory", "free", "d")]


@pytest.fixture(scope="module")
def torch_params(tiny_cfg, tiny_params):
    return from_numpy(jax.tree.map(np.asarray, tiny_params), tiny_cfg,
                      device="cpu")


def _tokens(cfg):
    rng = np.random.default_rng(12)
    tok = {n: rng.integers(0, cfg.vocab_size, k)
           for n, k in (("a", 48), ("b", 48), ("c", 64))}
    suffix = rng.integers(0, cfg.vocab_size, 8)
    tok["d"] = rng.integers(0, cfg.vocab_size, 48)
    return tok, suffix


def _cluster(ns, tok=None, kv=None):
    c = ns.storage.StorageCluster(
        [ns.storage.StorageNode("n0"), ns.storage.StorageNode("n1")],
        replication=1, heal="manual")
    for name in tok or ():
        c.register_prefix(tok[name], *kv[name], tokens_per_chunk=16,
                          resolutions=("240p",))
    return c


def _live(ns, params, cfg, tok, suffix, kv, **fleet_kw):
    """The replay script through ``ns``'s LiveFleet; returns the fleet,
    its cluster, its fair scheduler, the prefix keys by name and the
    storage node that fails."""
    cluster = _cluster(ns, tok, kv)
    by_name = dict(zip(tok, cluster.catalog))
    doomed = cluster.primary_node(by_name["a"]).node_id
    assert cluster.primary_node(by_name["d"]).node_id == doomed
    fair = ns.fairness.FairScheduler(max_inflight=1)
    fleet = ns.fleet.LiveFleet(
        params, cfg, cluster, n_nodes=N_NODES,
        bandwidth=ns.net.BandwidthTrace.constant(0.0006), policy="affinity",
        fairness=fair, local_kv_tokens=LOCAL_TOKENS,
        churn_at_dispatch=[(1, "fail", doomed)],
        engine_kw=dict(policy="kvfetcher", max_running=16,
                       decode_table=ns.adaptive.DecodeTable(**TABLE_KW),
                       use_table_sizes=True, adaptive=False,
                       resolution="240p", resolutions=("240p",),
                       cost=ns.cost.EngineCostModel(
                           cfg, ns.cost.CHIPS["h20"], 2)), **fleet_kw)
    for user, tier, name in SCRIPT:
        fleet.submit(np.concatenate([tok[name], suffix]),
                     prefix_key=by_name[name],
                     reuse_tokens=len(tok[name]), max_new_tokens=2,
                     user=user, slo_tier=tier)
    fleet.run()
    return fleet, cluster, fair, by_name, doomed


def _simulated(ns, cfg, live_cluster, by_name, doomed, tok, suffix):
    """The same script through ``ns``'s FleetSimulator, over synthetic
    twins of the live cluster's prefixes."""
    cluster = _cluster(ns)
    for key in by_name.values():
        src = live_cluster.catalog[key]
        cluster.register(ns.storage.StoredPrefix(
            key=key, n_tokens=src.n_tokens,
            bytes_by_resolution={"240p": src.stored_bytes},
            raw_kv_bytes=src.raw_kv_bytes, parent=src.parent), 0.0)
    fair = ns.fairness.FairScheduler(max_inflight=1)
    spec = ns.sim.MethodSpec(
        "kvfetcher", ratios={"stream": 8.0}, adaptive=False,
        fixed_resolution="240p", uses_decode_pool=True,
        use_table_sizes=True, pipelined=False, layerwise_admission=False,
        resolutions=("240p",))
    fleet = ns.fleet.FleetSimulator(
        cfg, spec, n_nodes=N_NODES,
        bandwidth=ns.net.BandwidthTrace.constant(0.0006), storage=cluster,
        table=ns.adaptive.DecodeTable(**TABLE_KW), fairness=fair,
        policy="affinity", local_kv_tokens=LOCAL_TOKENS,
        churn_at_dispatch=[(1, "fail", doomed)], chunk_tokens=16,
        max_running=16)
    reqs = [ns.scheduler.Request(rid=i, arrival=0.0,
                                 prompt_len=len(tok[name]) + len(suffix),
                                 reuse_tokens=len(tok[name]),
                                 prefix=by_name[name], max_new_tokens=2,
                                 user=user, slo_tier=tier)
            for i, (user, tier, name) in enumerate(SCRIPT)]
    return fleet, fleet.run(reqs, max_new_tokens=2), cluster


def _lookups(cluster):
    return [e for e in cluster.events if e[0] in LOOKUP_KINDS]


def _view(fleet, cluster, fair):
    done = [r for e in fleet.engines for r in e.finished]
    outputs = {r.rid: fleet.engines[fleet.placement[r.rid]].outputs[r.rid]
               for r in done}
    return dict(router=list(fleet.router.events),
                placement=dict(fleet.placement),
                fairness=list(fair.events), lookups=_lookups(cluster),
                dispatches=dict(fleet.dispatches_by_node),
                local=sorted(r.rid for r in done
                             if r.storage_hit == "local"),
                hits={r.rid: (r.storage_hit, r.storage_node) for r in done},
                outputs=outputs)


def test_live_fleet_replays_jax_live_fleet_and_simulator(tiny_cfg,
                                                         tiny_params,
                                                         torch_params):
    """Twin of test_fleet.py::test_fleet_replay_identical_in_simulator_
    and_live_fleet: an 8-node fleet over a Zipf-skewed script whose hot
    key's storage node dies after the first dispatch.  Both packages'
    clusters hold the same encoded prefixes (the port's donor KV)."""
    tok, suffix = _tokens(tiny_cfg)
    kv = {n: paged_model.donor_prefix_kv(torch_params, tiny_cfg, t)
          for n, t in tok.items()}
    runs = {}
    for name, ns, params, kw in (
            ("jax", JAX, tiny_params, {}),
            ("port", PORT, torch_params, {"device": "cpu"})):
        fleet, cluster, fair, by_name, doomed = _live(
            ns, params, tiny_cfg, tok, suffix, kv, **kw)
        runs[name] = _view(fleet, cluster, fair)
        if name == "port":
            assert all(e.device.type == "cpu" for e in fleet.engines)
            assert all(e.params is torch_params for e in fleet.engines)
            sim_fleet, res, sim_cluster = _simulated(
                ns, tiny_cfg, cluster, by_name, doomed, tok, suffix)
    port, ref = runs["port"], runs["jax"]
    for what in ref:
        assert port[what] == ref[what], what
    # the port's LiveFleet against the port's FleetSimulator
    assert port["router"] == res.router_events == sim_fleet.router.events
    assert port["placement"] == sim_fleet.placement == res.placements
    assert port["fairness"] == res.fairness_events
    assert port["lookups"] == _lookups(sim_cluster)
    assert port["dispatches"] == res.dispatches_by_node
    assert len(port["local"]) == res.local_hits > 0
    # the script's shape: the failure, a local hit of the hot key, the one
    # miss of "d", every request served once with its tokens
    assert ("fail", "", doomed) in port["lookups"]
    assert any(SCRIPT[rid][2] == "a" for rid in port["local"])
    assert {rid for _, rid, k, _ in port["fairness"] if k == "miss"} == {9}
    assert sorted(rid for _, rid, k, _ in port["fairness"]
                  if k == "serve") == list(range(len(SCRIPT)))
    assert all(len(out) == 2 for out in port["outputs"].values())
    assert len(port["outputs"]) == len(SCRIPT)
