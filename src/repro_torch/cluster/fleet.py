"""Fleet-scale serving: a prefix-affinity router over N serving nodes.

The per-GPU pipeline (docs/fetch_pipeline.md) scales out here to the
ROADMAP north star's first fleet slice: **N serving nodes**, each with
its own `SharedLink`, decode pool, and `FetchController` plan stream,
fronted by a :class:`FleetRouter` that places every request by policy:

  * ``affinity`` — consistent-hash / longest-prefix-locality: a request
    whose prefix (or any trie ancestor of it) was routed before goes to
    the same serving node, where the node-local KV working set
    (:class:`_LocalKV`), host-staged prefetch, and link warmth already
    live, turning remote fetches into local hits (the LMCache
    cache-aware-routing idiom, PAPERS.md).  New prefixes land on a
    vnode consistent-hash ring; a load-pressure escape hatch spills a
    hot key to the least-loaded node when its sticky target runs too
    far above the fair share.
  * ``least_loaded`` — minimum cumulative assigned requests (the
    classic load balancer baseline: great spread, zero locality).
  * ``random`` — seeded hash of the rid (the null baseline).

The shared tiers stay shared: ONE `StorageCluster` serves every node's
fetches over its own node links, ONE `PrefetchManager` speculates for
the whole fleet (its mispredict budget splits per node — see
``PrefetchManager(n_nodes=)``), and ONE `FairScheduler` keeps per-user
virtual counters global, with the fleet draining its backlog centrally
so a lagging user on node 3 still beats an abusive flood bound for
node 0.

Determinism contract (docs/fleet.md): every placement appends
``("place", rid, node_id, reason)`` to :attr:`FleetRouter.events`, and
all router/local-KV state advances only on the request sequence (never
on clocks), so :class:`FleetSimulator` (analytic) and
:class:`LiveFleet` (virtual-clock real engines) replay byte-identical
placement, fairness, and storage logs for the same trace
(``tests/test_fleet.py``).  Storage-node churn is therefore scripted by
*dispatch index* (``churn_at_dispatch``), not wall time — per-engine
clocks drift across environments, dispatch counts cannot.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cluster.simulator import (  # noqa: F401
    MethodSpec, ServingSimulator, SimResult)
from repro_torch.core.scheduler import Request

FLEET_POLICIES = ("affinity", "least_loaded", "random")


class FleetRouter:
    """Deterministic request placer over ``n_nodes`` serving nodes.

    All load state is the cumulative per-node assignment count — a pure
    function of the placement sequence, so both environments replay the
    identical decision stream.  ``parent_of`` (optional) maps a prefix
    key to its trie parent (usually the storage catalog), letting the
    affinity policy route every extension of one session chain to the
    chain root's node.
    """

    def __init__(self, n_nodes: int, *, policy: str = "affinity",
                 vnodes: int = 64, spill_factor: float = 2.0,
                 spill_slack: int = 4,
                 parent_of: Optional[Callable[[str],
                                              Optional[str]]] = None):
        assert policy in FLEET_POLICIES, \
            f"unknown policy {policy!r} (have {FLEET_POLICIES})"
        assert n_nodes >= 1
        self.n_nodes = n_nodes
        self.policy = policy
        self.parent_of = parent_of
        self.spill_factor = float(spill_factor)
        self.spill_slack = int(spill_slack)
        #: cumulative requests assigned per node (the only load signal)
        self.assigned = [0] * n_nodes
        #: affinity-root key -> node index (updated on spill)
        self.sticky: Dict[str, int] = {}
        #: deterministic placement log: ("place", rid, node_id, reason)
        self.events: List[Tuple[str, int, str, str]] = []
        # consistent-hash ring: vnodes points per node, sha256 like the
        # storage tier's ring so placements survive future node churn
        self._ring = sorted((self._point(f"s{k}#{v}"), k)
                            for k in range(n_nodes) for v in range(vnodes))

    @staticmethod
    def _point(s: str) -> int:
        return int.from_bytes(
            hashlib.sha256(s.encode()).digest()[:8], "big")

    def _ring_node(self, key: str) -> int:
        pts = [p for p, _ in self._ring]
        i = bisect.bisect_right(pts, self._point(key)) % len(self._ring)
        return self._ring[i][1]

    def _least_loaded(self) -> int:
        return min(range(self.n_nodes),
                   key=lambda k: (self.assigned[k], k))

    def _affinity_key(self, req: Request) -> Optional[str]:
        """Root of the request's prefix chain: walk trie parents so the
        whole session chain shares one sticky entry (longest-prefix
        locality — an extension lands where its ancestors' KV lives)."""
        if req.prefix is None or req.reuse_tokens <= 0:
            return None
        key = req.prefix
        if self.parent_of is not None:
            seen = {key}
            while True:
                parent = self.parent_of(key)
                if parent is None or parent in seen:
                    break
                seen.add(parent)
                key = parent
        return key

    def _overloaded(self, k: int) -> bool:
        fair = (sum(self.assigned) + 1) / self.n_nodes
        return self.assigned[k] + 1 > (self.spill_factor * fair
                                       + self.spill_slack)

    def place(self, req: Request) -> int:
        """Pick the serving node for ``req`` and log the decision."""
        if self.policy == "random":
            k = self._point(f"rid:{req.rid}") % self.n_nodes
            reason = "random"
        elif self.policy == "least_loaded":
            k = self._least_loaded()
            reason = "least_loaded"
        else:  # affinity
            key = self._affinity_key(req)
            if key is None:
                # nothing to be sticky to: fall back to load balancing
                k = self._least_loaded()
                reason = "least_loaded"
            else:
                k = self.sticky.get(key)
                reason = "sticky"
                if k is None:
                    k = self._ring_node(key)
                    reason = "hash"
                if self._overloaded(k):
                    # escape hatch: the sticky target runs too hot —
                    # spill this chain to the least-loaded node and
                    # re-stick there (locality follows the spill)
                    k = self._least_loaded()
                    reason = "spill"
                self.sticky[key] = k
        self.assigned[k] += 1
        self.events.append(("place", req.rid, f"s{k}", reason))
        return k


class _LocalKV:
    """Token-capacity LRU model of one serving node's resident prefix
    KV (paged cache + node-local reuse).  Entries are inserted at
    *dispatch* time — not completion — so residency is a pure function
    of the placement/dispatch sequence and replays identically in both
    environments."""

    def __init__(self, capacity_tokens: int):
        self.capacity = int(capacity_tokens)
        self._entries: "OrderedDict[str, int]" = OrderedDict()

    @property
    def resident_tokens(self) -> int:
        return sum(self._entries.values())

    def hit(self, key: str, need_tokens: int) -> bool:
        n = self._entries.get(key)
        if n is None or n < need_tokens:
            return False
        self._entries.move_to_end(key)
        return True

    def put(self, key: str, n_tokens: int) -> None:
        if n_tokens > self.capacity:
            return
        self._entries[key] = max(self._entries.get(key, 0), n_tokens)
        self._entries.move_to_end(key)
        while self.resident_tokens > self.capacity:
            self._entries.popitem(last=False)  # evict LRU


@dataclasses.dataclass
class FleetResult:
    requests: List[Request]
    #: rid -> serving node index
    placements: Dict[int, int]
    #: the router's ("place", rid, node_id, reason) log
    router_events: List[Tuple[str, int, str, str]]
    fairness_events: List[Tuple[str, int, str, int]]
    sim_time: float
    #: requests dispatched per node (fetch dispatches, incl. local hits)
    dispatches_by_node: Dict[int, int]

    def fetching(self) -> List[Request]:
        return [r for r in self.requests if r.needs_fetch
                or r.requested_reuse_tokens]

    @property
    def local_hits(self) -> int:
        return sum(1 for r in self.requests if r.storage_hit == "local")


class _FleetMixin:
    """Placement / local-KV / dispatch-churn logic shared verbatim by
    the analytic and live fleet harnesses — written once so the two
    environments cannot drift (the no-second-pipeline rule)."""

    def _init_fleet(self, n_nodes: int, *, policy: str, router, storage,
                    local_kv_tokens: Optional[int],
                    churn_at_dispatch) -> None:
        self.n_nodes = n_nodes
        self.storage = storage
        parent_of = None
        if storage is not None:
            parent_of = lambda k: (  # noqa: E731
                storage.catalog[k].parent if k in storage.catalog
                else None)
        self.router = router if router is not None else FleetRouter(
            n_nodes, policy=policy, parent_of=parent_of)
        self.local: Optional[List[_LocalKV]] = None
        if local_kv_tokens:
            self.local = [_LocalKV(local_kv_tokens)
                          for _ in range(n_nodes)]
        self.placement: Dict[int, int] = {}
        self.dispatched = 0
        self.dispatches_by_node: Dict[int, int] = {}
        # storage churn keyed by GLOBAL dispatch index (deterministic
        # across environments, unlike per-engine clocks):
        # [(dispatch_idx, "fail" | "recover", node_id)]
        self._churn_dispatch = sorted(churn_at_dispatch or [])
        assert not self._churn_dispatch or storage is not None, \
            "churn_at_dispatch needs a storage cluster"

    def _local_hit(self, k: int, req: Request) -> bool:
        """Node-local residency check at dispatch: serve from the
        serving node's own KV working set iff the exact prefix is
        resident there AND the catalog still knows it (the live engine
        restores from the cataloged manifest)."""
        if self.local is None or not req.needs_fetch:
            return False
        if req.prefix is None or self.storage is None \
                or req.prefix not in self.storage.catalog:
            return False
        return self.local[k].hit(req.prefix, req.reuse_tokens)

    def _note_local(self, k: int, req: Request) -> None:
        """A full remote hit just dispatched to node ``k``: its prefix
        becomes node-local from now on (dispatch-time insertion)."""
        if self.local is not None and req.storage_hit == "full" \
                and req.prefix is not None:
            self.local[k].put(req.prefix, req.reuse_tokens)

    def _churn_tick(self, now: float) -> None:
        """Apply storage churn scheduled for the current dispatch
        index (called once immediately before every dispatch)."""
        while self._churn_dispatch \
                and self._churn_dispatch[0][0] <= self.dispatched:
            _, kind, nid = self._churn_dispatch.pop(0)
            if kind == "fail":
                self.storage.fail_node(nid, now)
            else:
                self.storage.recover_node(nid, now)

    def _count_dispatch(self, k: int) -> None:
        self.dispatched += 1
        self.dispatches_by_node[k] = self.dispatches_by_node.get(k, 0) + 1


class FleetSimulator(_FleetMixin):
    """N `ServingSimulator` nodes behind one `FleetRouter`, on one
    unified virtual clock.

    Each node keeps its own link, decode pool, scheduler, and
    `FetchController` (built by its `ServingSimulator`); this class
    only adds what single-node runs don't have: placement, the shared
    storage/prefetch/fairness wiring, central fair dispatch, and
    per-node engine stepping (a node busy with a prefill chunk does not
    block its siblings' pipeline events).
    """

    def __init__(self, cfg, method: MethodSpec, *, n_nodes: int,
                 bandwidth, policy: str = "affinity",
                 # per-node ServingSimulator knobs: the analytic cost
                 # model (chip/n_chips/.../mfu) is simulator-only, and
                 # the link/table shaping reaches LiveFleet engines
                 # through its engine_kw= pass-through instead
                 # repro-lint: allow(cross-env-parity)
                 chip: str = "h20", n_chips: int = 2,
                 # repro-lint: allow(cross-env-parity)
                 loss=None, link_policy=None, link_ramp=None,
                 storage=None, prefetch=None, fairness=None,
                 # repro-lint: allow(cross-env-parity) -- engine_kw
                 table=None,
                 router: Optional[FleetRouter] = None,
                 local_kv_tokens: Optional[int] = None,
                 # clock-scripted churn is sim-only; LiveFleet scripts
                 # the shared churn_at_dispatch= (dispatch-indexed) or
                 # calls engine fail_node()/recover_node() imperatively
                 # repro-lint: allow(cross-env-parity)
                 fail_at: Optional[List[Tuple[float, str]]] = None,
                 # repro-lint: allow(cross-env-parity)
                 recover_at: Optional[List[Tuple[float, str]]] = None,
                 churn_at_dispatch: Optional[
                     List[Tuple[int, str, str]]] = None,
                 # repro-lint: allow(cross-env-parity) -- analytic knobs
                 chunk_tokens: int = 10_000, prefill_chunk: int = 2048,
                 # repro-lint: allow(cross-env-parity) -- engine_kw/mfu
                 max_running: int = 8, mfu: float = 0.45):
        self.cfg = cfg
        self.method = method
        self.fairness = fairness
        self.prefetch = prefetch
        # per-node bundles: own link/pool/scheduler/controller each;
        # storage and prefetch are attached AFTER construction so the
        # shared tier is wired once (heal + speculation events pump on
        # node 0's controller, whose queue the fleet loop always drains)
        self.nodes = [ServingSimulator(
            cfg, method, chip=chip, n_chips=n_chips, bandwidth=bandwidth,
            loss=loss, link_policy=link_policy, link_ramp=link_ramp,
            storage=None, table=table, fairness=fairness,
            chunk_tokens=chunk_tokens, prefill_chunk=prefill_chunk,
            max_running=max_running, mfu=mfu) for _ in range(n_nodes)]
        for nd in self.nodes:
            nd.storage = storage
            nd.prefetch = prefetch
            nd.ctrl.prefetcher = prefetch
            if storage is not None:
                nd.ctrl.rtt_sink = storage.observe_rtt
                nd.ctrl.res_sink = storage.note_resolution_use
        if storage is not None:
            storage.bind(self.nodes[0].ctrl.push_event)
        if prefetch is not None:
            assert storage is not None, "prefetch= needs a storage cluster"
            prefetch.bind(self.nodes[0].ctrl.push_event)
            if prefetch.n_nodes == 1:
                prefetch.n_nodes = n_nodes  # split the budget per node
        self._init_fleet(n_nodes, policy=policy, router=router,
                         storage=storage, local_kv_tokens=local_kv_tokens,
                         churn_at_dispatch=churn_at_dispatch)
        assert not (fail_at or recover_at) or storage is not None, \
            "fail_at/recover_at need a storage cluster"
        self._churn: List[Tuple[float, str, str]] = sorted(
            [(t, "fail", nid) for t, nid in (fail_at or [])]
            + [(t, "recover", nid) for t, nid in (recover_at or [])])

    def _admit(self, nd: ServingSimulator,
               admitted: List[Request]) -> None:
        for req in admitted:
            if req.needs_fetch and self.method.reuse:
                # reused prefix KV is restored: prefill the suffix only
                nd.prefill_remaining[req.rid] = max(
                    req.prompt_len - req.reuse_tokens, 0)
                nd.context_done[req.rid] = req.reuse_tokens

    def run(self, requests: List[Request], max_new_tokens: int = 32,
            horizon: float = 200_000.0) -> FleetResult:
        arrivals = sorted(requests, key=lambda r: r.arrival)
        ai = 0
        now = 0.0
        busy = [0.0] * self.n_nodes
        pending: List[Optional[Tuple[List[Request], List[Request]]]] = \
            [None] * self.n_nodes
        stall = 0
        while now < horizon:
            progressed = False
            while self._churn and self._churn[0][0] <= now:
                t, kind, nid = self._churn.pop(0)
                if kind == "fail":
                    self.storage.fail_node(nid, t)
                else:
                    self.storage.recover_node(nid, t)
                progressed = True
            # route + submit arrivals due by `now`
            while ai < len(arrivals) and arrivals[ai].arrival <= now:
                r = arrivals[ai]
                ai += 1
                if not self.method.reuse:
                    r.reuse_tokens = 0
                k = self.router.place(r)
                self.placement[r.rid] = k
                nd = self.nodes[k]
                nd.prefill_remaining[r.rid] = r.prompt_len
                nd.context_done[r.rid] = 0
                nd.sched.submit(r, r.arrival)
                progressed = True
            for nd in self.nodes:
                nd.ctrl.pump(now)
            for nd in self.nodes:
                self._admit(nd, nd.sched.schedule(now))
            # central fetch dispatch: with fairness the ONE global
            # backlog is drained here (a per-node take_fetches() would
            # steal other nodes' requests); each ready fetch goes to
            # its placed node's controller
            if self.fairness is not None:
                ready = self.fairness.take()
            else:
                ready = [r for nd in self.nodes
                         for r in nd.sched.take_fetches()]
            # insertion-ordered dict, not a set: the drain below feeds
            # admission (which appends fairness/serve events), so its
            # order must never depend on per-process hashing; sorted()
            # keeps the historical node-index drain order
            reschedule: Dict[int, None] = {}
            for req in ready:
                k = self.placement[req.rid]
                self._churn_tick(now)
                nd = self.nodes[k]
                if self._local_hit(k, req):
                    # the prefix already lives on this serving node:
                    # no wire transfer, the fetch completes instantly
                    # (a 0-byte "fetched" in the fairness log)
                    req.storage_hit = "local"
                    req.storage_node = f"s{k}"
                    nd.sched.notify_fetch_done(req, now)
                    reschedule[k] = None
                else:
                    if nd._dispatch_fetch(req, now):
                        reschedule[k] = None  # miss: re-run admission
                    else:
                        self._note_local(k, req)
                    if self.prefetch is not None:
                        self.prefetch.note_node(req.prefix, f"s{k}")
                self._count_dispatch(k)
                progressed = True
            if self.prefetch is not None:
                self.prefetch.tick(now)
            for k in sorted(reschedule):
                self._admit(self.nodes[k],
                            self.nodes[k].sched.schedule(now))
            # start engine steps on idle nodes
            for k, nd in enumerate(self.nodes):
                if pending[k] is not None or busy[k] > now:
                    continue
                prefills = [r for r in nd.sched.running
                            if nd.prefill_remaining[r.rid] > 0]
                decodes = [r for r in nd.sched.running
                           if nd.prefill_remaining[r.rid] == 0
                           and r.tokens_out < max_new_tokens]
                step = 0.0
                if prefills:
                    head = prefills[0]
                    chunk = min(nd.prefill_chunk,
                                max(nd.prefill_remaining[head.rid], 1))
                    step += nd.cost.prefill_time(
                        chunk, ctx=nd.context_done[head.rid])
                    nd.prefill_remaining[head.rid] -= chunk
                    nd.context_done[head.rid] += chunk
                    if nd.prefill_remaining[head.rid] <= 0:
                        nd.prefill_remaining[head.rid] = 0
                if decodes:
                    ctx = float(np.mean([r.prompt_len + r.tokens_out
                                         for r in decodes]))
                    step += nd.cost.decode_step_time(len(decodes), ctx)
                if step > 0.0:
                    if any(f.gpu_decomp_until > now
                           for f in nd.ctrl.active.values()):
                        step *= (self.method.prefill_slowdown if prefills
                                 else self.method.decode_slowdown)
                    busy[k] = now + step
                    pending[k] = (prefills, decodes)
                    progressed = True
            # advance the unified clock to the next instant anything
            # happens anywhere in the fleet
            nxt = [busy[k] for k in range(self.n_nodes)
                   if pending[k] is not None]
            for nd in self.nodes:
                t = nd.ctrl.next_event_time()
                if t is not None:
                    nxt.append(t)
            if ai < len(arrivals):
                nxt.append(arrivals[ai].arrival)
            if self._churn:
                nxt.append(self._churn[0][0])
            if not nxt:
                break
            new_now = max(now, min(nxt))
            stall = stall + 1 if (new_now == now and not progressed) else 0
            if stall > 1000:
                break  # safety valve: nothing can make progress
            now = new_now
            # finalize engine steps that completed by `now`
            for k, nd in enumerate(self.nodes):
                if pending[k] is None or busy[k] > now:
                    continue
                prefills, decodes = pending[k]
                pending[k] = None
                tnow = busy[k]
                for req in prefills:
                    if nd.prefill_remaining[req.rid] == 0 \
                            and req.t_first_token is None:
                        req.t_first_token = tnow
                        req.tokens_out = 1
                        req.token_times.append(tnow)
                        if (req.storage_hit == "miss" and self.storage
                                and req.storage_miss_key):
                            self.storage.notify_recompute_done(
                                req.storage_miss_key, tnow)
                for req in decodes:
                    if req.t_first_token is None:
                        req.t_first_token = tnow
                    req.tokens_out += 1
                    req.token_times.append(tnow)
                    if req.tokens_out >= max_new_tokens:
                        nd.sched.finish(req, tnow)
        return FleetResult(
            requests=arrivals, placements=dict(self.placement),
            router_events=list(self.router.events),
            fairness_events=(list(self.fairness.events)
                             if self.fairness is not None else []),
            sim_time=now,
            dispatches_by_node=dict(self.dispatches_by_node))


class LiveFleet(_FleetMixin):
    """N virtual-clock `LiveEngine` nodes behind one `FleetRouter`: the
    replay twin of :class:`FleetSimulator` for the cross-environment
    determinism tests (real model, real codec, real paged memory on
    every node; the network and placement are the shared models).

    Engines run ``fetch_mode="sync"`` with ``external_dispatch=True``:
    the fleet drains the ONE fair backlog centrally and hands each
    ready fetch to its placed engine, mirroring the simulator's loop
    phase order (pump/serve per node in index order, then central
    dispatch).  Every engine serves on ``device`` (default: the CUDA
    card; without one the constructor raises) from the one ``params``
    given, so the weights are held once however many nodes there are.
    """

    def __init__(self, params, cfg, cluster, *, n_nodes: int, bandwidth,
                 policy: str = "affinity",
                 router: Optional[FleetRouter] = None,
                 fairness=None, prefetch=None,
                 local_kv_tokens: Optional[int] = None,
                 churn_at_dispatch: Optional[
                     List[Tuple[int, str, str]]] = None,
                 engine_kw: Optional[dict] = None,
                 device=None):
        # lazy: the engine needs torch, the simulators do not
        from repro_torch.serving.engine import LiveEngine

        self.fairness = fairness
        self.prefetch = prefetch
        kw = dict(engine_kw or {})
        kw.setdefault("fetch_mode", "sync")
        if kw["fetch_mode"] != "sync":
            raise ValueError(
                "LiveFleet replays the serialized baseline (sync engines)")
        self.engines = [LiveEngine(params, cfg, cluster,
                                   bandwidth=bandwidth, fairness=fairness,
                                   prefetch=prefetch,
                                   external_dispatch=True, device=device,
                                   **kw)
                        for _ in range(n_nodes)]
        # every engine ctor re-bound the shared cluster to its own
        # event queue; pin it to node 0's like the simulator does
        if self.engines[0].ctrl is not None:
            cluster.bind(self.engines[0].ctrl.push_event)
            if prefetch is not None:
                prefetch.bind(self.engines[0].ctrl.push_event)
        if prefetch is not None and prefetch.n_nodes == 1:
            prefetch.n_nodes = n_nodes
        self._init_fleet(n_nodes, policy=policy, router=router,
                         storage=cluster, local_kv_tokens=local_kv_tokens,
                         churn_at_dispatch=churn_at_dispatch)
        self._next_rid = 0

    def submit(self, tokens, prefix_key: Optional[str] = None,
               reuse_tokens: int = 0, max_new_tokens: int = 8,
               user: Optional[str] = None,
               slo_tier: Optional[str] = None) -> Request:
        """Route one request and submit it to its serving node.  Rids
        are fleet-global (engines receive them explicitly), so the
        placement/fairness logs line up with the simulator's."""
        rid = self._next_rid
        self._next_rid += 1
        probe = Request(rid=rid, arrival=0.0, prompt_len=len(tokens),
                        reuse_tokens=reuse_tokens, prefix=prefix_key,
                        max_new_tokens=max_new_tokens, user=user,
                        slo_tier=slo_tier)
        k = self.router.place(probe)
        self.placement[rid] = k
        return self.engines[k].submit(
            tokens, reuse_prefix=prefix_key, reuse_tokens=reuse_tokens,
            max_new_tokens=max_new_tokens, user=user, slo_tier=slo_tier,
            rid=rid)

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            work = False
            for eng in self.engines:  # index order, like the simulator
                work = eng.step() or work
            if self.fairness is not None:
                ready = self.fairness.take()
            else:
                ready = [r for eng in self.engines
                         for r in eng.sched.take_fetches()]
            for req in ready:
                k = self.placement[req.rid]
                eng = self.engines[k]
                self._churn_tick(eng.now())
                if self._local_hit(k, req):
                    req.storage_hit = "local"
                    req.storage_node = f"s{k}"
                    eng.local_restore(req)
                    eng.sched.schedule(eng.now())
                else:
                    eng.dispatch_fetch(req)
                    self._note_local(k, req)
                    if self.prefetch is not None:
                        self.prefetch.note_node(req.prefix, f"s{k}")
                self._count_dispatch(k)
            if not work and not ready:
                break

    @property
    def finished(self) -> List[Request]:
        return [r for eng in self.engines for r in eng.finished]
