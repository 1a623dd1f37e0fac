"""The port's storage tier, host staging, fair scheduling and serving
metrics on the CPU, held against the JAX package's.

The copied modules (``cluster/storage.py``, ``cluster/staging.py``,
``cluster/fairness.py``, ``serving/metrics.py``) run the node, ring,
lookup, fail/heal, TTL, admission, prefetch and fairness scenarios of
``tests/test_storage.py``, ``tests/test_prefetch.py`` and
``tests/test_fairness.py`` once with each package's classes; every
scenario must give equal event logs and observables.  Then the port's
``LiveEngine`` serves the live scenarios of those files beside the JAX
``LiveEngine`` (weights bridged from the JAX init, the same encoded
prefixes in both clusters): equal tokens, equal ``store.events``,
prefetcher events and ``fairness.events``, restored pages bit-equal.
"""
import heapq
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.fairness as j_fairness  # noqa: E402
import repro.cluster.network as j_network  # noqa: E402
import repro.cluster.staging as j_staging  # noqa: E402
import repro.cluster.storage as j_storage  # noqa: E402
import repro.core.adaptive as j_adaptive  # noqa: E402
import repro.core.fetch as j_fetch  # noqa: E402
import repro.core.fetch_controller as j_fc  # noqa: E402
import repro.core.scheduler as j_scheduler  # noqa: E402
import repro.serving.metrics as j_metrics  # noqa: E402
from repro.data.workload import (prefix_trie_specs,  # noqa: E402
                                 zipf_prefix_trace)
from repro.serving.engine import LiveEngine as JaxLiveEngine  # noqa: E402

import repro_torch.cluster.fairness as t_fairness  # noqa: E402
import repro_torch.cluster.network as t_network  # noqa: E402
import repro_torch.cluster.staging as t_staging  # noqa: E402
import repro_torch.cluster.storage as t_storage  # noqa: E402
import repro_torch.core.adaptive as t_adaptive  # noqa: E402
import repro_torch.core.fetch as t_fetch  # noqa: E402
import repro_torch.core.fetch_controller as t_fc  # noqa: E402
import repro_torch.core.scheduler as t_scheduler  # noqa: E402
import repro_torch.serving.metrics as t_metrics  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import LiveEngine  # noqa: E402

MB = 1_000_000


def _mods(storage, staging, fairness, network, scheduler, fc, fetch,
          adaptive, metrics, engine):
    return types.SimpleNamespace(
        StorageNode=storage.StorageNode,
        StorageCluster=storage.StorageCluster,
        StoredPrefix=storage.StoredPrefix, KVStore=storage.KVStore,
        HostStagingTier=staging.HostStagingTier,
        PrefetchManager=staging.PrefetchManager,
        FairScheduler=fairness.FairScheduler,
        BandwidthTrace=network.BandwidthTrace, SharedLink=network.SharedLink,
        make_link=network.make_link,
        FetchingAwareScheduler=scheduler.FetchingAwareScheduler,
        Request=scheduler.Request, FetchController=fc.FetchController,
        PipelineConfig=fc.PipelineConfig, synthetic_plan=fetch.synthetic_plan,
        DecodeTable=adaptive.DecodeTable, metrics=metrics,
        LiveEngine=engine)


JAX = _mods(j_storage, j_staging, j_fairness, j_network, j_scheduler, j_fc,
            j_fetch, j_adaptive, j_metrics, JaxLiveEngine)
TORCH = _mods(t_storage, t_staging, t_fairness, t_network, t_scheduler,
              t_fc, t_fetch, t_adaptive, t_metrics, LiveEngine)


def _entry(m, key, n_tokens=1000, size=10 * MB, parent=None, **kw):
    return m.StoredPrefix(key=key, n_tokens=n_tokens,
                          bytes_by_resolution={"240p": size},
                          raw_kv_bytes=8 * size, parent=parent, **kw)


def _cluster(m, n_nodes=3, cap=35 * MB, policy="lru", **kw):
    return m.StorageCluster([m.StorageNode(f"n{i}", capacity_bytes=cap,
                                           policy=policy)
                             for i in range(n_nodes)], **kw)


def _hit(h):
    return (h.kind, h.entry.key if h.entry is not None else None,
            h.node.node_id if h.node is not None else None,
            h.covered_tokens, h.requested_tokens, h.missed_key,
            h.resolutions)


def _state(c):
    """What a cluster scenario is compared on."""
    return dict(events=list(c.events),
                resident={n.node_id: sorted(n.residents) for n in c.nodes},
                alive=[n.alive for n in c.nodes],
                counts=(c.lookups, c.full_hits, c.partial_hits, c.misses,
                        c.heals_completed, c.rebalances_completed),
                used=[n.used_bytes for n in c.nodes])


# ---------------------------------------------------------------------------
# storage scenarios (tests/test_storage.py), run with each package
# ---------------------------------------------------------------------------

def sc_node_capacity_and_policies(m):
    out = []
    n = m.StorageNode("n0", capacity_bytes=100 * MB)
    out.append(n.put(m.StoredPrefix("a", 100, {"240p": 10 * MB,
                                               "1080p": 30 * MB}), 0.0))
    out.append(n.put(m.StoredPrefix("b", 100, {"240p": 70 * MB}), 1.0))
    out.append((n.used_bytes, dict(n.bytes_by_resolution)))
    small = m.StorageNode("s", capacity_bytes=10 * MB)
    small.put(_entry(m, "a", size=8 * MB), 0.0)
    out.append(small.put(_entry(m, "huge", size=20 * MB), 1.0))
    for policy in ("lru", "lfu", "cost"):
        n = m.StorageNode("n0", capacity_bytes=30 * MB, policy=policy)
        for i, k in enumerate(("a", "b", "c")):
            n.put(_entry(m, k), float(i))
        for t in range(3):
            n.get("a", 10.0 + t)
        n.get("c", 20.0)
        out.append((policy, n.put(_entry(m, "d"), 21.0)))
    n = m.StorageNode("n0", capacity_bytes=100 * MB)
    n.put(_entry(m, "a"), 0.0)
    n.get("a", 1.0)
    v2 = m.StoredPrefix("a", 1000, {"240p": 10 * MB, "480p": 15 * MB})
    out.append((n.put(v2, 2.0), n.residents["a"].hits, n.used_bytes,
                n.stats.admissions, repr(n)))
    return out


def sc_placement_and_lookup(m):
    c = _cluster(m, cap=None)
    out = [[c.primary_node(f"k{i}").node_id for i in range(60)]]
    c = _cluster(m, n_nodes=1, cap=25 * MB)
    c.register(_entry(m, "root", n_tokens=400), 0.0)
    c.register(_entry(m, "child", n_tokens=600, parent="root"), 1.0)
    out.append(_hit(c.lookup("child", 2.0)))
    c.lookup("root", 2.5)
    c.register(_entry(m, "x", n_tokens=100), 3.0)
    out.append(_hit(c.lookup("child", 5.0)))
    out.append(_hit(c.lookup("never-registered", 6.0)))
    return out, _state(c)


def sc_write_on_miss_and_replication(m):
    c = _cluster(m, n_nodes=1, cap=25 * MB)
    for i, k in enumerate("abc"):
        c.register(_entry(m, k), float(i))
    out = [_hit(c.lookup("a", 3.0))]
    c.notify_recompute_done("a", 5.0)
    out.append(_hit(c.lookup("a", 6.0)))
    c.notify_recompute_done("a", 7.0)
    p = _cluster(m, cap=None, placement="popular", replicate_threshold=2)
    p.register(_entry(m, "hot"), 0.0)
    p.register(_entry(m, "cold"), 0.0)
    out += [_hit(p.lookup("hot", 1.0 + t)) for t in range(3)]
    return out, _state(c), _state(p)


def sc_lookup_tokens(m):
    c = _cluster(m, cap=None)
    toks = np.arange(64)
    c.register(m.StoredPrefix("root", 32, {"240p": MB},
                              token_ids=toks[:32]), 0.0)
    c.register(m.StoredPrefix("child", 48, {"240p": MB}, parent="root",
                              token_ids=toks[:48]), 0.0)
    out = [_hit(c.lookup_tokens(toks[:48], 1.0)),
           _hit(c.lookup_tokens(toks[:64], 2.0)),
           _hit(c.lookup_tokens(np.arange(100, 140), 3.0))]
    return out, _state(c)


def sc_seeded_zipf(m):
    specs = prefix_trie_specs(3, 2, base_tokens=400, ext_tokens=200)
    c = _cluster(m, n_nodes=2, cap=25 * MB, policy="cost")
    for s in specs:
        c.register(_entry(m, s.key, n_tokens=s.n_tokens, parent=s.parent),
                   0.0)
    reqs = zipf_prefix_trace(np.random.default_rng(42), specs,
                             n_requests=30, alpha=1.2, gap=1.0)
    hits = [_hit(c.lookup(r.prefix, r.arrival + 1.0,
                          requested_tokens=r.reuse_tokens)) for r in reqs]
    assert any(e[0] == "evict" for e in c.events)
    return hits, _state(c)


def sc_fail_recover_and_heal(m):
    out = []
    n = m.StorageNode("n0", capacity_bytes=100 * MB)
    n.put(_entry(m, "a"), 0.0)
    n.put(_entry(m, "b"), 1.0)
    out.append((n.fail(), repr(n)))
    n.recover()
    out.append(n.put(_entry(m, "c"), 2.0))
    c = _cluster(m, cap=None)
    keys = [f"k{i}" for i in range(40)]
    c.fail_node("n0", 0.0)
    out.append([c.primary_node(k).node_id for k in keys])
    c.recover_node("n0", 1.0)
    out.append([c.primary_node(k).node_id for k in keys])
    states = [_state(c)]
    for replication in (2, 1):
        c = _cluster(m, cap=None, replication=replication)
        c.register(_entry(m, "k"), 0.0)
        holder = next(n.node_id for n in c.nodes if n.contains("k"))
        c.fail_node(holder, 1.0)
        out.append(_hit(c.lookup("k", 2.0)))
        states.append(_state(c))
    return out, states


def sc_expired_rejected_manual_heal(m):
    c = _cluster(m, cap=None, replication=2)
    c.register(m.StoredPrefix("k", 1000, {"240p": MB}, raw_kv_bytes=8 * MB,
                              ttl=5.0), 0.0)
    holders = [n.node_id for n in c.nodes if n.contains("k")]
    c.fail_node(holders[0], 100.0)
    out = [_hit(c.lookup("k", 101.0))]
    states = [_state(c)]
    c = _cluster(m, n_nodes=2, cap=15 * MB, replication=1)
    c.register(_entry(m, "k"), 0.0)
    holder = next(n for n in c.nodes if n.contains("k"))
    other = next(n for n in c.nodes if n is not holder)
    other.put(m.StoredPrefix("pin", 100, {"240p": 10 * MB}, pinned=True),
              0.5)
    c.fail_node(holder.node_id, 1.0)
    states.append(_state(c))
    c = _cluster(m, cap=None, replication=1, heal="manual")
    c.register(_entry(m, "k"), 0.0)
    holder = next(n.node_id for n in c.nodes if n.contains("k"))
    c.fail_node(holder, 1.0)
    out.append(_hit(c.lookup("k", 2.0)))
    out.append(c.pump_heal(3.0))
    out.append(_hit(c.lookup("k", 4.0)))
    states.append(_state(c))
    return out, states


def sc_ttl_and_pinning(m):
    c = _cluster(m, n_nodes=1, cap=None)
    c.register(m.StoredPrefix("short", 1000, {"240p": MB}, ttl=10.0), 0.0)
    out = [_hit(c.lookup("short", 5.0)), _hit(c.lookup("short", 20.0))]
    n = m.StorageNode("n0", capacity_bytes=30 * MB)
    n.put(m.StoredPrefix("stale", 1000, {"240p": 20 * MB}, ttl=5.0), 0.0)
    n.put(_entry(m, "live"), 1.0)
    out.append((n.put(_entry(m, "new"), 10.0), sorted(n.residents),
                n.stats.expirations, n.stats.evictions))
    n = m.StorageNode("n0", capacity_bytes=None)
    e = m.StoredPrefix("k", 1000, {"240p": MB}, ttl=10.0)
    n.put(e, 0.0)
    n.put(e, 8.0)
    out.append((n.is_expired("k", 15.0), n.is_expired("k", 19.0)))
    n = m.StorageNode("n0", capacity_bytes=30 * MB, policy="lru")
    n.put(m.StoredPrefix("pin", 1000, {"240p": 10 * MB}, pinned=True,
                         ttl=1.0), 0.0)
    out += [n.put(_entry(m, f"scan{i}"), 100.0 + i) for i in range(4)]
    n = m.StorageNode("n0", capacity_bytes=30 * MB)
    n.put(m.StoredPrefix("p1", 1000, {"240p": 15 * MB}, pinned=True), 0.0)
    n.put(m.StoredPrefix("p2", 1000, {"240p": 10 * MB}, pinned=True), 1.0)
    out.append((n.put(_entry(m, "x"), 2.0), n.stats.rejections))
    return out, _state(c)


def sc_admission(m):
    c = _cluster(m, n_nodes=1, cap=None, admission="second_hit",
                 admission_min_asks=2)
    c.register(_entry(m, "a"), 0.0)
    out = [_hit(c.lookup("a", 1.0))]
    c.notify_recompute_done("a", 2.0)
    out.append(_hit(c.lookup("a", 3.0)))
    c.notify_recompute_done("a", 4.0)
    out.append(_hit(c.lookup("a", 5.0)))
    states = [_state(c)]
    c = _cluster(m, n_nodes=1, cap=None, admission="cost",
                 admission_min_score=4.0)
    c.register(_entry(m, "dense"), 0.0)
    c.register(m.StoredPrefix("cheap", 1000, {"240p": 10 * MB},
                              raw_kv_bytes=10 * MB), 0.0)
    for t in range(2):
        c.lookup("dense", 1.0 + t)
        c.lookup("cheap", 1.5 + t)
    c.notify_recompute_done("dense", 4.0)
    c.notify_recompute_done("cheap", 4.0)
    states.append(_state(c))
    c = _cluster(m, cap=None, replication=1, admission="second_hit",
                 admission_min_asks=2)
    c.register(_entry(m, "k"), 0.0)
    for t in range(2):
        c.lookup("k", 1.0 + t)
    c.notify_recompute_done("k", 3.0)
    holder = next(n.node_id for n in c.nodes if n.contains("k"))
    c.fail_node(holder, 4.0)
    states.append(_state(c))
    return out, states


def sc_rebalance_and_rtt(m):
    c = _cluster(m, n_nodes=2, cap=None, replication=1, heal="sync")
    c.register(_entry(m, "k", n_tokens=40_000), 0.0)
    home = c.primary_node("k")
    c.fail_node(home.node_id, 10.0)
    c.recover_node(home.node_id, 20.0)
    states = [_state(c)]
    c = _cluster(m, cap=None, replication=3)
    c.register(_entry(m, "k"), 0.0)
    served = [_hit(c.lookup("k", 0.0)) for _ in range(3)]
    c.observe_rtt("n0", 0.010)
    c.observe_rtt("n1", 0.010)
    c.observe_rtt("n2", 0.200)
    served += [_hit(c.lookup("k", 0.0)) for _ in range(4)]
    states.append(_state(c))
    c = _cluster(m, n_nodes=4, cap=None, replication=3, heal="manual")
    c.register(_entry(m, "k"), 0.0)
    ring = c._ring_nodes("k")
    c.observe_rtt(ring[1].node_id, 0.300)
    c.observe_rtt(ring[2].node_id, 0.020)
    c.fail_node(ring[0].node_id, 10.0)
    queued = [(e.key, s, t, k) for e, s, t, k in c.heal_queue]
    return served, queued, states, dict(c.node_rtt)


def sc_resolution_granularity(m):
    def ladder(key, rungs):
        return m.StoredPrefix(key=key, n_tokens=1000,
                              bytes_by_resolution=rungs,
                              raw_kv_bytes=8 * sum(rungs.values()))
    out = []
    n = m.StorageNode("n0", capacity_bytes=40 * MB, policy="lfu",
                      evict_granularity="resolution")
    n.put(ladder("a", {"240p": 10 * MB, "1080p": 20 * MB}), 0.0)
    for _ in range(3):
        n.note_resolution_use("a", "240p")
    n.note_resolution_use("a", "1080p")
    out.append((n.put(ladder("b", {"240p": 15 * MB}), 1.0),
                n.resident_resolutions("a")))
    node = m.StorageNode("n0", capacity_bytes=50 * MB, policy="lru",
                         evict_granularity="resolution")
    c = m.StorageCluster([node])
    c.register(ladder("a", {"240p": 10 * MB, "1080p": 30 * MB}), 0.0)
    out.append(_hit(c.lookup("a", 1.0)))
    c.note_resolution_use("n0", "a", "1080p")
    c.register(ladder("b", {"240p": 15 * MB}), 2.0)
    out.append(_hit(c.lookup("a", 3.0)))
    return out, _state(c)


def _queue():
    """A virtual event queue shaped like the controller's ``push_event``:
    (push, pump)."""
    ev, seq = [], iter(range(1 << 20))

    def push(t, fn):
        heapq.heappush(ev, (t, next(seq), fn))

    def pump(until):
        while ev and ev[0][0] <= until:
            t, _, fn = heapq.heappop(ev)
            fn(t)

    return push, pump


def sc_link_heal(m):
    """heal="link": re-replication streams over the nodes' links on a
    virtual clock."""
    nodes = [m.StorageNode(f"n{i}", link=m.BandwidthTrace.constant(0.08))
             for i in range(3)]
    c = m.StorageCluster(nodes, replication=2, heal="link")
    push, pump = _queue()
    c.bind(push)
    for k in ("a", "b", "c"):
        c.register(_entry(m, k, size=2 * MB), 0.0)
    c.fail_node("n0", 1.0)
    pump(2.0)
    mid = _state(c)
    pump(1e6)
    return mid, _state(c), [_hit(c.lookup(k, 1e6)) for k in "abc"]


STORAGE_SCENARIOS = [sc_node_capacity_and_policies, sc_placement_and_lookup,
                     sc_write_on_miss_and_replication, sc_lookup_tokens,
                     sc_seeded_zipf, sc_fail_recover_and_heal,
                     sc_expired_rejected_manual_heal, sc_ttl_and_pinning,
                     sc_admission, sc_rebalance_and_rtt,
                     sc_resolution_granularity, sc_link_heal]


@pytest.mark.parametrize("scenario", STORAGE_SCENARIOS,
                         ids=lambda f: f.__name__[3:])
def test_storage_copy_matches_jax(scenario):
    want = scenario(JAX)
    got = scenario(TORCH)
    assert got == want and want


def test_kvstore_facade_matches_jax(synthetic_kv):
    kv_k, kv_v, toks = synthetic_kv(8, 3, 2, 4)
    logs = []
    for m in (JAX, TORCH):
        store = m.KVStore()
        man = store.register_prefix(toks, kv_k, kv_v, tokens_per_chunk=4,
                                    resolutions=("240p",))
        assert store.lookup(man.prefix) is man
        ref = man.refs[0]
        logs.append((store.lookup("nope"), store.stored_bytes(),
                     list(store.manifests),
                     store.get_chunk(man.prefix, ref.chunk_id, "240p")))
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# PrefetchManager (tests/test_prefetch.py) and FairScheduler
# (tests/test_fairness.py), run with each package
# ---------------------------------------------------------------------------

def _pf_cluster(m, entries, gbps=None):
    link = None if gbps is None else m.BandwidthTrace.constant(gbps)
    c = m.StorageCluster([m.StorageNode("n0", link=link)])
    for e in entries:
        c.register(e, 0.0)
    return c


def _pf_state(pf):
    return dict(events=list(pf.events), wasted=pf.wasted_bytes,
                counts=(pf.prefetches_started, pf.prefetches_committed,
                        pf.prefetches_cancelled, pf.host_hits),
                staged=sorted(pf.staging.node.residents),
                heat=dict(pf.heat))


def pf_predictor(m):
    c = _pf_cluster(m, [_entry(m, "p"), _entry(m, "p.c", parent="p")])
    pf = m.PrefetchManager(c, m.HostStagingTier(None), transport="sync")
    out = [pf.predictions()]
    pf.observe("nonexistent", 0.0)
    pf.observe("p", 0.0)
    out.append(pf.predictions())
    pf.observe("p", 1.0)
    out.append(pf.predictions())
    pf.tick(1.0)
    out.append(pf.predictions())
    return out, _pf_state(pf)


def pf_budget_and_host_tier(m):
    out, states = [], []
    entries = [_entry(m, k) for k in "abcd"]
    pf = m.PrefetchManager(_pf_cluster(m, entries),
                           m.HostStagingTier(10 * MB), transport="sync",
                           mispredict_budget_bytes=15 * MB)
    out += [pf.request_prefetch(k, float(t)) for t, k in enumerate("abcd")]
    states.append(_pf_state(pf))
    pf = m.PrefetchManager(_pf_cluster(m, entries[:3]),
                           m.HostStagingTier(10 * MB), transport="sync",
                           mispredict_budget_bytes=5 * MB)
    out.append(pf.request_prefetch("a", 0.0))
    out.append(pf.host_lookup("a", 1000, 1.0).key)
    out += [pf.request_prefetch(k, t) for k, t in (("b", 2.0), ("c", 3.0),
                                                   ("a", 4.0))]
    out.append(pf.host_lookup("b", 2000, 5.0))
    states.append(_pf_state(pf))
    pf = m.PrefetchManager(_pf_cluster(m, entries[:3]),
                           m.HostStagingTier(20 * MB), transport="sync")
    for t, k in enumerate("ab"):
        pf.request_prefetch(k, float(t))
    pf.host_lookup("a", 1000, 5.0)
    pf.request_prefetch("c", 6.0)
    states.append(_pf_state(pf))
    pf = m.PrefetchManager(_pf_cluster(m, [_entry(m, "big", size=30 * MB)]),
                           m.HostStagingTier(20 * MB), transport="sync")
    out.append(pf.request_prefetch("big", 0.0))
    states.append(_pf_state(pf))
    return out, states


def pf_link_transport(m):
    c = _pf_cluster(m, [_entry(m, "a")], gbps=0.008)
    push, pump = _queue()
    pf = m.PrefetchManager(c, m.HostStagingTier(None), transport="link")
    pf.bind(push)
    link = c.nodes[0].link
    link.bind(push)
    link.open_flow(7, t=0.0)
    out = [pf.request_prefetch("a", 0.0)]
    link.close_flow(7)
    out.append(pf.request_prefetch("a", 1.0))
    pump(4.0)
    req = m.Request(rid=0, arrival=4.0, prompt_len=1000, reuse_tokens=0)
    other = m.SharedLink(m.BandwidthTrace.constant(1.0))
    pf.demand_started(req, other, 4.0)
    pf.demand_started(req, pf.staging.link, 4.0)
    pf.demand_started(req, link, 5.0)
    pump(20.0)
    first = _pf_state(pf)
    out.append(pf.request_prefetch("a", 21.0))
    pump(100.0)
    return out, first, _pf_state(pf)


def _fair_req(m, rid, user, tier, chunks=2, max_new=4):
    reuse = chunks * 1_000
    return m.Request(rid=rid, arrival=0.0, prompt_len=reuse + 100,
                     reuse_tokens=reuse, prefix=f"pfx.{rid}",
                     max_new_tokens=max_new, user=user, slo_tier=tier)


def fair_drain(m):
    """The controller-level fetch drain of tests/test_fairness.py over a
    seeded mix of users, tiers and fetch sizes."""
    rng = np.random.default_rng(3)
    tiers = ("free", "standard", "premium")
    fair = m.FairScheduler(max_inflight=1)
    reqs = [_fair_req(m, i, f"u{o}", tiers[o], chunks=int(c))
            for i, (o, c) in enumerate(zip(rng.integers(0, 3, 10),
                                           rng.integers(1, 5, 10)))]
    sched = m.FetchingAwareScheduler("kvfetcher", max_running=64,
                                     fairness=fair)
    table = m.DecodeTable(name="fair-toy", n_decoders=1,
                          latency={"240p": (0.06,)}, penalty={"240p": 0.0},
                          chunk_size_mb={"240p": 0.002})
    ctrl = m.FetchController(
        sched, m.make_link(m.BandwidthTrace.constant(0.0006)), table=table,
        pool=None, config=m.PipelineConfig(
            adaptive=False, fixed_resolution="240p", pipelined=False,
            layerwise_admission=False, use_table_sizes=True,
            resolutions=("240p",)))
    plans = {r.rid: m.synthetic_plan(r.rid, r.reuse_tokens, 3, 1_000)
             for r in reqs}
    for r in reqs:
        sched.submit(r, 0.0)
    now = 0.0
    for _ in range(100_000):
        sched.schedule(now)
        started = sched.take_fetches()
        for r in started:
            ctrl.start(r, plans[r.rid], now)
        if started:
            continue
        t = ctrl.pump_next()
        if t is None:
            break
        now = max(now, t)
    return list(fair.events), [r.fetch_done for r in reqs], \
        dict(fair.counters)


def fair_units(m):
    out = []
    fair = m.FairScheduler(max_inflight=1, byte_unit=1.0,
                           tiers={"flat": 1.0})
    r0, r1 = _fair_req(m, 0, "busy", "flat"), _fair_req(m, 1, "busy", "flat")
    for r in (r0, r1):
        fair.on_arrival(r)
        fair.enqueue(r)
    (d0,) = fair.take()
    fair.on_fetch_done(d0, 5.0)
    r2 = _fair_req(m, 2, "joiner", "flat")
    fair.on_arrival(r2)
    fair.enqueue(r2)
    out.append([fair.user_of(r) for r in fair.take()])
    out.append(list(fair.events))
    fair = m.FairScheduler(max_inflight=None, byte_unit=1.0)
    for r in (_fair_req(m, 0, "zed", "standard"),
              _fair_req(m, 1, "amy", "standard"),
              _fair_req(m, 2, "pri", "premium")):
        fair.on_arrival(r)
        fair.enqueue(r)
    out.append([fair.user_of(r) for r in fair.take()])
    fair = m.FairScheduler(max_inflight=1, byte_unit=1.0, token_unit=1.0,
                           output_token_weight=2.0)
    r = _fair_req(m, 0, "u", "standard", chunks=1)
    fair.on_arrival(r)
    fair.enqueue(r)
    fair.take()
    fair.on_fetch_done(r, 3.0)
    fair.on_fetch_done(r, 3.0)
    fair.on_fetch_miss(r)
    fair.on_admit(r)
    fair.on_admit(r)
    out.append((list(fair.events), dict(fair.counters)))
    return out


def fair_storage_and_prefetch_shares(m):
    cluster = m.StorageCluster([m.StorageNode("n0"), m.StorageNode("n1")],
                               admission="second_hit", admission_min_asks=2)
    for key in ("k.p", "k.s", "k.f"):
        cluster.register(m.StoredPrefix(key=key, n_tokens=1_000,
                                        bytes_by_resolution={"240p": 1_000},
                                        raw_kv_bytes=64_000), 0.0)
    fair = m.FairScheduler()
    for user, tier in (("prem", "premium"), ("std", "standard"),
                       ("free", "free")):
        fair.register(user, tier)
    out = [fair.apply_storage_priority(cluster, u, k)
           for u, k in (("prem", "k.p"), ("std", "k.s"), ("free", "k.f"),
                        ("prem", "k.none"))]
    out.append(({k: e.pinned for k, e in cluster.catalog.items()},
                dict(cluster.asks_by_key)))
    fair = m.FairScheduler()
    fair.on_arrival(m.Request(rid=0, arrival=0.0, prompt_len=1_100,
                              reuse_tokens=1_000, prefix="k.p",
                              user="alice", slo_tier="premium"))
    fair.on_arrival(m.Request(rid=1, arrival=0.0, prompt_len=1_100,
                              reuse_tokens=1_000, prefix="k.s",
                              user="bob", slo_tier="free"))
    pm = m.PrefetchManager(cluster, m.HostStagingTier(1e9),
                           mispredict_budget_bytes=1_000.0,
                           transport="sync", fairness=fair)
    pm._account_waste("k.s", 250.0)
    out.append(pm.request_prefetch("k.s", 0.0))
    pm._account_waste("k.p", 900.0)
    out.append((pm._over_budget("k.p"), dict(pm.wasted_by_user),
                list(pm.events), list(fair.events)))
    return out


@pytest.mark.parametrize("scenario", [
    pf_predictor, pf_budget_and_host_tier, pf_link_transport, fair_drain,
    fair_units, fair_storage_and_prefetch_shares],
    ids=lambda f: f.__name__)
def test_prefetch_and_fairness_copies_match_jax(scenario):
    want = scenario(JAX)
    assert scenario(TORCH) == want


def test_metrics_match_jax():
    """summarize and split_summary on the same finished requests."""
    rng = np.random.default_rng(5)
    logs = []
    for m in (JAX, TORCH):
        rng = np.random.default_rng(5)
        reqs = []
        for rid in range(12):
            r = m.Request(rid=rid, arrival=float(rng.uniform(0, 5)),
                          prompt_len=100, max_new_tokens=6,
                          reuse_tokens=int(rng.integers(0, 2)) * 64,
                          prefix="p")
            if rid != 7:  # one request never produced a token
                r.t_first_token = r.arrival + float(rng.uniform(0.1, 3))
                n = int(rng.integers(1, 6))
                r.token_times = list(r.t_first_token + np.cumsum(
                    np.r_[0.0, rng.uniform(0.01, 0.1, n - 1)]))
                r.tokens_out = n
                r.t_finished = r.token_times[-1]
            reqs.append(r)
        logs.append((m.metrics.summarize(reqs),
                     m.metrics.split_summary(reqs)))
    assert logs[1] == logs[0]
    assert logs[0][1]["fetching"]["n"] > 0 and logs[0][1]["non_reuse"]["n"]


# ---------------------------------------------------------------------------
# live engines: the port's against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def torch_params(tiny_cfg, tiny_params):
    return from_numpy(jax.tree.map(np.asarray, tiny_params), tiny_cfg,
                      device="cpu")


@pytest.fixture(scope="module")
def donor(tiny_cfg, torch_params):
    """Factory: the port's donor KV for ``tokens`` (memoized), fed to both
    packages' clusters."""
    memo = {}

    def _donor(tokens):
        key = tuple(int(t) for t in tokens)
        if key not in memo:
            memo[key] = paged_model.donor_prefix_kv(torch_params, tiny_cfg,
                                                    np.asarray(tokens))
        return memo[key]
    return _donor


@pytest.fixture
def sides(tiny_params, torch_params):
    """(modules, params, engine kwargs) of the JAX side, then the port's."""
    return ((JAX, tiny_params, {}), (TORCH, torch_params, {"device": "cpu"}))


def _live_cluster(m, donor, token_sets, *, n_nodes=1, links=None,
                  **cluster_kw):
    nodes = [m.StorageNode(f"n{i}", link=None if links is None
                           else m.BandwidthTrace.constant(links[i]))
             for i in range(n_nodes)]
    cluster = m.StorageCluster(nodes, **cluster_kw)
    for toks in token_sets:
        kv_k, kv_v = donor(toks)
        cluster.register_prefix(toks, kv_k, kv_v, tokens_per_chunk=16,
                                resolutions=("240p",))
    return cluster


def _restored(eng, req):
    """The rows a fetch restored, k and v, read at the first token."""
    idx = np.arange(req.reuse_tokens)
    ps = eng.cache.page_size
    bt = np.asarray(eng.cache.seqs[req.rid].block_table)
    rows = bt[idx // ps] * ps + idx % ps
    out = []
    for pages in (eng.cache.k_pages, eng.cache.v_pages):
        a = np.asarray(pages)
        out.append(a.reshape(a.shape[0], -1, *a.shape[3:])[:, rows])
    return out


def _watch(snap):
    """on_token callback: the restored rows of each fetching request at
    its first token."""
    def on_token(req, tok, t):
        if len(req.token_times) == 1 and req.reuse_tokens \
                and req.storage_hit != "miss":
            snap[req.rid] = _restored(on_token.eng, req)
    return on_token


def _engine(m, params, cfg, store, kw, snap, **knobs):
    cb = _watch(snap)
    eng = m.LiveEngine(params, cfg, store, resolution="240p", on_token=cb,
                       **knobs, **kw)
    cb.eng = eng
    return eng


def _req_view(r):
    return (r.rid, r.storage_hit, r.storage_node, r.reuse_tokens,
            r.requested_reuse_tokens, r.prefix)


def _same_pages(snaps):
    (a, b) = snaps
    assert sorted(a) == sorted(b) and a
    for rid in a:
        for x, y in zip(a[rid], b[rid]):
            assert np.array_equal(x, y), f"rid {rid}: restored rows differ"


def test_live_partial_hit_matches_jax(tiny_cfg, sides, donor):
    """Twin of test_storage.py::test_live_partial_hit_matches_full_recompute,
    held against the JAX engine's partial-hit tokens (the JAX engine's own
    check against a full recompute fails on the seed)."""
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, tiny_cfg.vocab_size, 72)
    logs, snaps = [], []
    for m, params, kw in sides:
        cluster = _live_cluster(m, donor, [prompt[:48]])
        snaps.append({})
        eng = _engine(m, params, tiny_cfg, cluster, kw, snaps[-1])
        req = eng.submit(prompt, reuse_prefix="by-tokens", reuse_tokens=64,
                         max_new_tokens=4)
        eng.run()
        logs.append((eng.outputs[req.rid], _req_view(req),
                     list(cluster.events), cluster.partial_hits,
                     eng.stats.restored_tokens, eng.stats.fetched_bytes))
    assert logs[1] == logs[0]
    assert logs[1][1][1] == "partial" and logs[1][1][3:5] == (48, 64)
    _same_pages(snaps)


def test_live_miss_falls_back_to_plain_prefill_as_jax(tiny_cfg, sides,
                                                      donor):
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, tiny_cfg.vocab_size, 40)
    other = rng.integers(0, tiny_cfg.vocab_size, 32)
    logs = []
    for m, params, kw in sides:
        cluster = _live_cluster(m, donor, [other])
        eng = _engine(m, params, tiny_cfg, cluster, kw, {})
        req = eng.submit(prompt, reuse_prefix="by-tokens", reuse_tokens=32,
                         max_new_tokens=4)
        plain = eng.submit(prompt, max_new_tokens=4)
        eng.run()
        logs.append((eng.outputs[req.rid], eng.outputs[plain.rid],
                     _req_view(req), list(cluster.events)))
    assert logs[1] == logs[0]
    assert logs[1][0] == logs[1][1]  # the miss is a plain prefill
    assert logs[1][2][1] == "miss" and logs[1][2][3] == 0


def test_live_fail_node_miss_heal_cycle_as_jax(tiny_cfg, sides, donor):
    """Twin of test_storage.py::test_live_engine_fail_node_miss_heal_cycle:
    full hit, the holder fails, a miss served by a plain prefill, the
    delayed write-on-miss, a full hit on the other node."""
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, tiny_cfg.vocab_size, 48)
    prompt = np.concatenate([prefix, rng.integers(0, tiny_cfg.vocab_size,
                                                  8)])
    logs, snaps = [], []
    for m, params, kw in sides:
        cluster = _live_cluster(m, donor, [prefix], n_nodes=2,
                                heal="manual")
        snaps.append({})
        eng = _engine(m, params, tiny_cfg, cluster, kw, snaps[-1])
        reqs, queued = [], []
        for i in range(3):
            if i == 1:
                eng.fail_node(reqs[0].storage_node)
                queued = [(e.key, s, t, k)
                          for e, s, t, k in cluster.heal_queue]
            reqs.append(eng.submit(prompt, reuse_prefix="by-tokens",
                                   reuse_tokens=48, max_new_tokens=4))
            eng.run()
        plain = eng.submit(prompt, max_new_tokens=4)
        eng.run()
        cluster.pump_heal(eng.now())
        logs.append(([eng.outputs[r.rid] for r in reqs + [plain]],
                     [_req_view(r) for r in reqs], queued,
                     _state(cluster)))
    assert logs[1] == logs[0]
    views = logs[1][1]
    assert [v[1] for v in views] == ["full", "miss", "full"]
    assert views[2][2] != views[0][2] and logs[1][2]
    outs = logs[1][0]
    assert outs[1] == outs[3]  # the miss gives a plain prefill's tokens
    _same_pages(snaps)


def test_live_prefetch_then_host_hit_as_jax(tiny_cfg, sides, donor):
    """Twin of test_prefetch.py::test_cross_env_prefetch_then_hit_
    sequences_agree, held against the JAX engine: the parent's hit heats
    the child, the sync speculation stages it, the child's ask resolves
    host-first."""
    rng = np.random.default_rng(7)
    tok_p = rng.integers(0, tiny_cfg.vocab_size, 32)
    tok_c = np.concatenate([tok_p, rng.integers(0, tiny_cfg.vocab_size,
                                                16)])
    suffix = rng.integers(0, tiny_cfg.vocab_size, 8)
    logs, snaps = [], []
    for m, params, kw in sides:
        cluster = _live_cluster(m, donor, [tok_p, tok_c])
        pf = m.PrefetchManager(cluster, m.HostStagingTier(None),
                               transport="sync")
        snaps.append({})
        eng = _engine(m, params, tiny_cfg, cluster, kw, snaps[-1],
                      prefetch=pf)
        reqs = []
        for toks in (tok_p, tok_c):
            reqs.append(eng.submit(np.concatenate([toks, suffix]),
                                   reuse_prefix="by-tokens",
                                   reuse_tokens=len(toks), max_new_tokens=2))
            eng.run()
        logs.append(([eng.outputs[r.rid] for r in reqs],
                     [_req_view(r) for r in reqs], list(cluster.events),
                     _pf_state(pf)))
    assert logs[1] == logs[0]
    assert [v[1] for v in logs[1][1]] == ["full", "host"]
    assert ("host_hit", logs[1][1][1][5]) in logs[1][3]["events"]
    _same_pages(snaps)


FAIR_TABLE_KW = dict(name="fair-toy", n_decoders=1,
                     latency={"240p": (0.06,)}, penalty={"240p": 0.0},
                     chunk_size_mb={"240p": 0.002})


def test_live_fairness_virtual_clock_as_jax(tiny_cfg, sides, donor):
    """Twin of test_fairness.py::test_fairness_event_log_identical_in_
    simulator_and_live_engine, held against the JAX engine: an abusive
    flood with a storage-node failure mid-trace on the virtual clock."""
    import repro.cluster.costmodel as j_cost
    import repro_torch.cluster.costmodel as t_cost
    rng = np.random.default_rng(12)
    tok_a = rng.integers(0, tiny_cfg.vocab_size, 48)
    tok_b = [rng.integers(0, tiny_cfg.vocab_size, 48) for _ in range(4)]
    suffix = rng.integers(0, tiny_cfg.vocab_size, 8)
    logs, snaps = [], []
    for (m, params, kw), cost in zip(sides, (j_cost, t_cost)):
        cluster = _live_cluster(m, donor, [tok_a] + tok_b, n_nodes=2,
                                replication=1, heal="manual")
        keys = list(cluster.catalog)
        doomed = next(n.node_id for n in cluster.nodes if n.node_id
                      != cluster.primary_node(keys[0]).node_id)
        fair = m.FairScheduler(max_inflight=1)
        snaps.append({})
        eng = _engine(m, params, tiny_cfg, cluster, kw, snaps[-1],
                      policy="kvfetcher", max_running=16, fetch_mode="sync",
                      bandwidth=m.BandwidthTrace.constant(0.0006),
                      decode_table=m.DecodeTable(**FAIR_TABLE_KW),
                      use_table_sizes=True, adaptive=False,
                      resolutions=("240p",),
                      cost=cost.EngineCostModel(tiny_cfg,
                                                cost.CHIPS["h20"], 2),
                      fairness=fair)
        eng.ctrl.push_event(0.05, lambda t, c=cluster, d=doomed:
                            c.fail_node(d, t))
        script = ([("alice", "premium", tok_a), ("bob", "standard", tok_a)]
                  * 2 + [("mallory", "free", t) for t in tok_b])
        reqs = [eng.submit(np.concatenate([toks, suffix]),
                           reuse_prefix="by-tokens", reuse_tokens=48,
                           max_new_tokens=2, user=user, slo_tier=tier)
                for user, tier, toks in script]
        eng.run()
        logs.append(dict(
            outputs=[eng.outputs[r.rid] for r in reqs],
            times=[list(r.token_times) for r in reqs],
            views=[_req_view(r) for r in reqs],
            fair=list(fair.events), cluster=_state(cluster)))
    assert logs[1] == logs[0]
    kinds = {k for _, _, k, _ in logs[1]["fair"]}
    assert {"arrive", "dispatch", "fetched", "serve", "miss"} <= kinds
    _same_pages(snaps)


def test_live_per_node_links_virtual_clock_as_jax(tiny_cfg, sides, donor):
    """A virtual-clock StorageCluster whose nodes carry their own links:
    async fetches over the serving node's link, the controller's
    ``rtt_sink`` feeding the cluster's RTT table, a partial hit, and a
    node failure mid-run healed over the links (heal="link")."""
    rng = np.random.default_rng(31)
    base = rng.integers(0, tiny_cfg.vocab_size, 64)
    suffix = rng.integers(0, tiny_cfg.vocab_size, 8)
    logs, snaps = [], []
    for m, params, kw in sides:
        cluster = _live_cluster(m, donor, [base[:32], base[:48]], n_nodes=3,
                                links=(0.002, 0.0008, 0.004),
                                replication=2, heal="link")
        snaps.append({})
        eng = _engine(m, params, tiny_cfg, cluster, kw, snaps[-1],
                      fetch_mode="async",
                      bandwidth=m.BandwidthTrace.constant(0.002))
        victim = cluster.primary_node(list(cluster.catalog)[1]).node_id
        eng.ctrl.push_event(0.2, lambda t, c=cluster, v=victim:
                            c.fail_node(v, t))
        asks = (48, 64, 32, 48)
        reqs = [eng.submit(np.concatenate([base[:n], suffix]),
                           reuse_prefix="by-tokens", reuse_tokens=n,
                           max_new_tokens=3) for n in asks]
        eng.run()
        while eng.ctrl.next_event_time() is not None:
            eng.ctrl.pump(eng.ctrl.next_event_time())
        logs.append(dict(
            outputs=[eng.outputs[r.rid] for r in reqs],
            times=[list(r.token_times) for r in reqs],
            views=[_req_view(r) for r in reqs],
            rtt=dict(cluster.node_rtt), cluster=_state(cluster),
            stall=eng.stats.prefill_stall_time))
    assert logs[1] == logs[0]
    kinds = [e[0] for e in logs[1]["cluster"]["events"]]
    assert "fail" in kinds and "heal" in kinds and "partial" in kinds
    assert logs[1]["rtt"]
    _same_pages(snaps)
