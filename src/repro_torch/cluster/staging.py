"""Speculative prefix prefetch + host-memory staging tier.

The fetch pipeline so far is purely *reactive*: every fetch pays the
WAN transfer on the TTFT critical path, even for a prefix the workload
was guaranteed to ask for.  This module moves the WAN off that path for
predicted traffic, following sglang's ``PrefetchManager`` tick/commit
loop (SNIPPETS.md #1) and the KV-offloading host<->GPU bandwidth
analysis (PAPERS.md):

  * :class:`HostStagingTier` — a capacity-bounded host-DRAM cache
    between the remote :class:`~repro_torch.cluster.storage.StorageCluster`
    and GPU paged memory.  It reuses :class:`StorageNode`'s byte-
    accurate admission/eviction, and its ``link`` is a PCIe-like
    host->GPU :class:`~repro_torch.cluster.network.BandwidthTrace`
    (:data:`PCIE_H2D_GBPS`) — a staged hit still pays the h2d copy,
    just not the WAN.
  * :class:`PrefetchManager` — the predictor + speculation loop.
    The predictor runs over the prefix trie: every demand lookup heats
    the resolved key (popularity) and, more strongly, its cataloged
    children (*session continuation*: a session that just reused P
    tends to come back asking for P extended).  :meth:`tick` — called
    once per environment scheduling loop — turns heat above
    ``heat_threshold`` into speculative transfers; completions
    *commit* into the staging tier.

Link-weight contract
--------------------
Speculative transfers join the source node's `SharedLink` at
:data:`PREFETCH_WEIGHT` (mirroring ``network.HEAL_WEIGHT``) under a
**negative flow id**, so speculation never starves demand fetches.  Two
further protections: :meth:`PrefetchManager.request_prefetch` defers
while the source link carries any demand flow, and
:meth:`PrefetchManager.demand_started` (hooked from
``FetchController.start``) cancels in-flight speculation the moment a
demand fetch needs the same link.

Budget semantics
----------------
``mispredict_budget_bytes`` is a hard cap on *wasted* speculative
bytes: bytes already on the wire when a speculation is cancelled, plus
the stored bytes of staged entries evicted without ever serving a host
hit.  An entry that serves a hit is *earned* and its later eviction is
free.  Once ``wasted_bytes`` reaches the budget, new speculation is
declined (``budget_reject`` events) — prediction quality bounds cost.

Like the storage cluster, the manager keeps a deterministic
:attr:`PrefetchManager.events` log of ``(kind, key)`` tuples —
``prefetch_start`` / ``prefetch_done`` / ``prefetch_cancel`` /
``stage_evict`` / ``stage_reject`` / ``host_hit`` / ``budget_reject``
— a pure function of the access sequence with ``transport="sync"``, so
the analytic simulator and the live engine replay identical sequences
for a prefetch-then-hit trace (``tests/test_prefetch.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .network import HEAL_WEIGHT, BandwidthTrace
from .storage import StorageCluster, StorageNode, StoredPrefix

#: speculative transfers join the WAN link at the heal weight — the
#: same "background traffic never starves demand" contract heals use
PREFETCH_WEIGHT = HEAL_WEIGHT

#: host->GPU staging bandwidth (Gbps): ~16 GB/s, a PCIe gen4 x16 lane
#: at realistic efficiency (KV-offloading bottleneck analysis)
PCIE_H2D_GBPS = 128.0

#: base for speculative flow ids: negative (never collides with a rid)
#: and far below the heal-flow range (heals count down from -1)
_PREFETCH_FLOW_BASE = -1_000_000


class HostStagingTier:
    """Capacity-bounded host-DRAM staging cache in front of GPU memory.

    Internally one :class:`StorageNode` (same byte accounting, same
    deterministic eviction policies) whose ``link`` models the
    host->GPU copy path: a `BandwidthTrace` at :data:`PCIE_H2D_GBPS`
    by default.  Fetches resolved here ride that link through the
    ordinary ``FetchController`` machinery — no second pipeline.
    """

    def __init__(self, capacity_bytes: Optional[float], *,
                 h2d=None, policy: str = "lru"):
        self.node = StorageNode(
            "host", capacity_bytes, policy=policy,
            link=(h2d if h2d is not None
                  else BandwidthTrace.constant(PCIE_H2D_GBPS)))

    @property
    def link(self):
        return self.node.link

    @property
    def used_bytes(self) -> int:
        return self.node.used_bytes

    def contains(self, key: str) -> bool:
        return self.node.contains(key)

    def __repr__(self) -> str:
        return f"HostStagingTier({self.node!r})"


@dataclass
class _Speculation:
    """One in-flight speculative transfer (cancellable)."""
    key: str
    flow: int
    link: object
    handle: object
    nbytes: float
    source_id: str
    t_start: float


class PrefetchManager:
    """Predictor + speculation loop over a :class:`StorageCluster`.

    ``transport="link"`` streams each speculation over the source
    node's `SharedLink` (needs :meth:`bind`-ing to a virtual event
    queue); ``"sync"`` commits instantly — clock-free, for wall-clock
    engines and cross-environment replay tests, exactly like the
    cluster's ``heal="sync"``.
    """

    def __init__(self, cluster: StorageCluster, staging: HostStagingTier,
                 *, weight: float = PREFETCH_WEIGHT,
                 mispredict_budget_bytes: Optional[float] = None,
                 transport: str = "link", max_inflight: int = 2,
                 heat_threshold: float = 2.0,
                 continuation_boost: float = 2.0,
                 # user-level budget shares: with a
                 # repro_torch.cluster.fairness.FairScheduler attached, waste
                 # is attributed to the prefix's demanding user and each
                 # user may only burn budget * prefetch_share(user) —
                 # one tenant's mispredictions cannot exhaust the
                 # shared budget (docs/fairness.md)
                 fairness=None,
                 # fleet mode (docs/fleet.md): with N serving nodes the
                 # mispredict budget additionally splits per node —
                 # each node may burn at most budget / n_nodes, so one
                 # node's cold working set cannot exhaust speculation
                 # for the whole fleet.  Harnesses attribute keys to
                 # nodes via note_node() at dispatch time.
                 n_nodes: int = 1):
        assert transport in ("link", "sync"), transport
        self.cluster = cluster
        self.staging = staging
        self.weight = weight
        self.budget = (float("inf") if mispredict_budget_bytes is None
                       else float(mispredict_budget_bytes))
        self.transport = transport
        self.max_inflight = max_inflight
        self.heat_threshold = heat_threshold
        self.continuation_boost = continuation_boost
        self.fairness = fairness
        self.heat: Dict[str, float] = {}
        self.events: List[Tuple[str, str]] = []
        self.wasted_bytes = 0.0
        self.wasted_by_user: Dict[str, float] = {}
        self.n_nodes = max(1, int(n_nodes))
        self.wasted_by_node: Dict[str, float] = {}
        self._node_of_prefix: Dict[str, str] = {}
        self.prefetches_started = 0
        self.prefetches_committed = 0
        self.prefetches_cancelled = 0
        self.host_hits = 0
        # staged keys that earned a host hit; insertion-ordered dict,
        # not a set, so any drain replays in hit order (repro-lint
        # ordered-iteration)
        self._earned: Dict[str, None] = {}
        self._inflight: Dict[str, _Speculation] = {}
        self._flow = _PREFETCH_FLOW_BASE
        self._push = None

    def __repr__(self) -> str:
        return (f"PrefetchManager({len(self.staging.node.residents)} "
                f"staged, {len(self._inflight)} in flight, "
                f"{self.wasted_bytes / 1e6:.1f} MB wasted)")

    def bind(self, push) -> None:
        """Wire the environment's virtual event queue (the fetch
        controller's ``push_event``) so ``transport="link"``
        speculations can schedule completions; also binds the staging
        tier's h2d link for host-resolved demand fetches."""
        self._push = push
        if self.staging.link is not None:
            self.staging.link.bind(push)

    # -- predictor ----------------------------------------------------------
    def _children(self, key: str) -> List[str]:
        return [e.key for e in self.cluster.catalog.values()
                if e.parent == key]

    def observe(self, key: Optional[str], now: float) -> None:
        """Fold one demand lookup into the heat map: the resolved key
        gains popularity heat, its cataloged children gain the (larger)
        session-continuation heat.  Environments call this on every
        demand resolution — host hit, remote hit, or miss alike."""
        if key is None:
            return
        self.heat[key] = self.heat.get(key, 0.0) + 1.0
        for child in self._children(key):
            self.heat[child] = (self.heat.get(child, 0.0)
                                + self.continuation_boost)

    def predictions(self) -> List[str]:
        """Cataloged keys hot enough to warm, hottest first (catalog
        insertion order breaks ties — deterministic)."""
        cand = [k for k in self.cluster.catalog
                if self.heat.get(k, 0.0) >= self.heat_threshold
                and not self.staging.contains(k)
                and k not in self._inflight]
        cand.sort(key=lambda k: -self.heat[k])
        return cand

    # -- host-first resolution ----------------------------------------------
    def host_lookup(self, key: str, requested_tokens: int,
                    now: float) -> Optional[StoredPrefix]:
        """Resolve a demand fetch host-first: a staged entry covering
        the full ask serves from host DRAM (and is marked *earned*);
        anything less falls back to the remote/miss paths."""
        e = self.staging.node.get(key, now)
        if e is None or e.n_tokens < requested_tokens:
            return None
        self._earned[key] = None
        self.host_hits += 1
        self.events.append(("host_hit", key))
        return e

    def host_lookup_tokens(self, token_ids,
                           now: float) -> Optional[StoredPrefix]:
        """Token-id variant (live-engine path): a staged entry whose
        token ids equal the requested reuse region serves host-first."""
        token_ids = np.asarray(token_ids)
        for key in list(self.staging.node.residents):
            e = self.cluster.catalog.get(key)
            if e is None or e.token_ids is None:
                continue
            if e.n_tokens == len(token_ids) \
                    and np.array_equal(e.token_ids, token_ids):
                return self.host_lookup(key, len(token_ids), now)
        return None

    # -- tick / commit loop (sglang PrefetchManager idiom) -------------------
    def tick(self, now: float) -> None:
        """Once per scheduling loop: turn predictions into speculative
        transfers, bounded by ``max_inflight``.  ``transport="link"``
        completions commit asynchronously from the event queue."""
        for key in self.predictions():
            if len(self._inflight) >= self.max_inflight:
                return
            self.request_prefetch(key, now)

    def request_prefetch(self, key: str, now: float) -> bool:
        """Validate and start one speculation (the sglang shape:
        already-staged / already-busy / nothing-to-fetch-from all
        decline safely; so does an exhausted mispredict budget)."""
        if self.staging.contains(key) or key in self._inflight:
            return False
        entry = self.cluster.catalog.get(key)
        if entry is None:
            return False
        if self._over_budget(key):
            self.events.append(("budget_reject", key))
            return False
        holders = self.cluster._resident_nodes(key, now)
        if not holders:
            return False  # not resident remotely: nothing to warm from
        source = self.cluster._pick_heal_source(holders)
        if self.transport == "sync" or source.link is None:
            self.prefetches_started += 1
            self.events.append(("prefetch_start", key))
            self._commit(key, entry, now)
            return True
        if source.link.demand_flows():
            return False  # demand traffic holds the link: defer
        assert self._push is not None, \
            "transport='link' needs bind() — pass the manager to a " \
            "simulator/virtual-clock engine, or use transport='sync'"
        self._flow -= 1
        flow = self._flow
        source.link.bind(self._push)
        source.link.open_flow(flow, weight=self.weight, t=now)
        self.prefetches_started += 1
        self.events.append(("prefetch_start", key))

        def done(t: float, key=key, entry=entry, link=source.link,
                 flow=flow) -> None:
            link.close_flow(flow)
            self._inflight.pop(key, None)
            self._commit(key, entry, t)

        handle = source.link.submit(flow, entry.stored_bytes, now, done)
        self._inflight[key] = _Speculation(
            key, flow, source.link, handle, float(entry.stored_bytes),
            source.node_id, now)
        return True

    def _commit(self, key: str, entry: StoredPrefix, now: float) -> None:
        ok, evicted = self.staging.node.put(entry, now)
        for k in evicted:
            self.events.append(("stage_evict", k))
            self._charge_waste(k)
        if ok:
            self.prefetches_committed += 1
            self.events.append(("prefetch_done", key))
        else:
            self.events.append(("stage_reject", key))

    def note_node(self, key: Optional[str], node_id: str) -> None:
        """Attribute ``key`` to the serving node that last demanded it.
        Fleet harnesses call this at dispatch time, so the per-node
        budget split is a pure function of the placement sequence
        (cross-environment deterministic, like every other log)."""
        if key is not None:
            self._node_of_prefix[key] = node_id

    def _over_budget(self, key: str) -> bool:
        """Budget check for one more speculation on ``key``: global cap
        without fairness; with a FairScheduler, the cap is the key's
        demanding user's share of the budget (an unattributed key —
        never demanded — falls back to the global check).  In fleet
        mode (``n_nodes > 1``) the demanding *node*'s even share
        ``budget / n_nodes`` is checked as well — whichever cap trips
        first declines the speculation."""
        if self.n_nodes > 1:
            node = self._node_of_prefix.get(key)
            if node is not None and self.wasted_by_node.get(node, 0.0) \
                    >= self.budget / self.n_nodes:
                return True
        if self.fairness is not None:
            user = self.fairness.prefix_user(key)
            if user is not None:
                cap = self.budget * self.fairness.prefetch_share(user)
                return self.wasted_by_user.get(user, 0.0) >= cap
        return self.wasted_bytes >= self.budget

    def _account_waste(self, key: str, nbytes: float) -> None:
        self.wasted_bytes += nbytes
        if self.fairness is not None:
            user = self.fairness.prefix_user(key)
            if user is not None:
                self.wasted_by_user[user] = \
                    self.wasted_by_user.get(user, 0.0) + nbytes
        node = self._node_of_prefix.get(key)
        if node is not None:
            self.wasted_by_node[node] = \
                self.wasted_by_node.get(node, 0.0) + nbytes

    def _charge_waste(self, key: str) -> None:
        """A staged entry left the tier: free if it earned a host hit,
        otherwise its stored bytes count against the budget."""
        if key in self._earned:
            self._earned.pop(key, None)
            return
        e = self.cluster.catalog.get(key)
        if e is not None:
            self._account_waste(key, float(e.stored_bytes))

    # -- demand pressure ------------------------------------------------------
    def demand_started(self, req, link, now: float) -> None:
        """Hooked from ``FetchController.start``: a demand fetch just
        opened on ``link``, so in-flight speculation riding the same
        link is cancelled — bytes already on the wire are charged to
        the mispredict budget.  Speculation on other links, and demand
        fetches resolved from the host tier, cancel nothing."""
        if link is self.staging.link:
            return
        for key, spec in list(self._inflight.items()):
            if spec.link is not link:
                continue
            link.cancel(spec.handle, now)
            link.close_flow(spec.flow)
            sent = spec.nbytes - max(
                getattr(spec.handle, "left", spec.nbytes), 0.0)
            self._account_waste(key, sent)
            self.prefetches_cancelled += 1
            self.events.append(("prefetch_cancel", key))
            del self._inflight[key]
