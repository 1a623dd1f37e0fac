"""Multi-node prefix storage tier: capacity-bounded placement, eviction,
and longest-prefix-match lookup for encoded KV manifests.

The paper's remote-reuse wins assume the encoded prefix is actually
*resident* somewhere fetchable.  In production that residency is managed
by a dedicated storage layer (LMCache-style pools, Mooncake-style
disaggregated stores); this module models that layer as a first-class
subsystem with three pieces:

  * :class:`StoredPrefix` — the unit of placement: one reusable prefix's
    encoded artifacts (multi-resolution blob sizes, optional real
    `KVManifest`, optional token ids) plus its ancestry link for
    longest-prefix matching.
  * :class:`StorageNode` — one capacity-bounded server: byte-accurate
    admission with pluggable eviction (``lru``, ``lfu``, or the
    cost-aware ``cost`` policy scoring bytes-saved-per-byte-stored), and
    optionally its *own* `repro_torch.cluster.network.SharedLink`, so where a
    prefix lives changes the observed fetch path (and therefore TTFT).
  * :class:`StorageCluster` — places prefixes across nodes (consistent
    hashing, or popularity-aware replication on top of it), serves
    lookups that may be **full** hits, **partial** hits (a stored
    *ancestor* prefix: fetch the ancestor, recompute the tail), or
    misses (recompute everything; the prefix is re-admitted from the
    durable catalog — a pull-through cache).

The tier is **fault-tolerant and admission-controlled**:

  * :meth:`StorageNode.fail` / :meth:`StorageNode.recover` model node
    churn — a failed node loses its residents (the catalog is the
    durable origin) and leaves the ring until it recovers.
  * **Ring heal**: :meth:`StorageCluster.fail_node` re-routes the failed
    node's keys to their ring successors and enqueues re-replication
    tasks that restore the replication factor from surviving replicas
    (or the durable catalog when none survive).  With ``heal="link"``
    each heal transfer rides the source node's own `SharedLink` at
    :data:`repro_torch.cluster.network.HEAL_WEIGHT`, so heal traffic contends
    with live fetches; ``heal="sync"`` (default) completes heals
    immediately — clock-free, for cross-environment replay tests.
  * **TTL + pinning**: a :class:`StoredPrefix` may carry ``ttl`` seconds
    (enforced lazily at lookup and eagerly at the eviction scan) and a
    ``pinned`` flag (never evicted, never expired).
  * **Delayed write-on-miss**: a miss no longer re-admits immediately —
    the environment calls :meth:`StorageCluster.notify_recompute_done`
    when the fallback full prefill actually completes (hooked from the
    `FetchingAwareScheduler.notify_fetch_miss` resolution), modeling the
    donor re-uploading only after the KV exists again.
  * **Admission control** decides what gets stored at all:
    ``admission="second_hit"`` admits a prefix only once it has been
    asked for ``admission_min_asks`` times; ``admission="cost"`` gates
    on the projected bytes-saved-per-byte-stored score.  Declined
    writes log ``reject`` events.

The cluster's :attr:`StorageCluster.events` log records every admit /
evict / hit / partial / miss / replicate / fail / heal / recover /
expire / reject decision in order.  All decisions are pure functions of
the access sequence, entry sizes, and the churn schedule (no internal
RNG), so the analytic simulator and the live engine replay the
*identical* event sequence for the same workload — tested in
``tests/test_storage.py``, including a node failure mid-trace.

Units
-----
All capacities and sizes are **bytes** internally (``stored_bytes``,
``capacity_bytes``, per-resolution accounting); timestamps are
**seconds** on the caller's clock.  ``__repr__`` renders GB/MB (like
`SharedLink` renders Gbps) so printed nodes are readable.

See ``docs/storage_tier.md`` for the data model, eviction semantics,
placement policies, and the partial-hit timeline.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.chunks import KVManifest, encode_prefix, prefix_key
from repro_torch.core.layout import RESOLUTION_ORDER
from repro_torch.cluster.network import HEAL_WEIGHT, make_link

#: bytes per gigabyte, for constructors/repr (internal unit is bytes).
GB = 1e9


# ---------------------------------------------------------------------------
# The unit of placement
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StoredPrefix:
    """One reusable prefix's encoded artifacts, as the storage tier sees
    them.

    ``bytes_by_resolution`` is the encoded footprint per resolution (all
    resolutions of a prefix are stored together — the adaptive fetcher
    picks among them at fetch time, so a node must hold the full ladder).
    ``raw_kv_bytes`` is the uncompressed KV footprint a hit avoids
    recomputing/transferring; the cost-aware eviction score uses it.
    ``parent`` links to the longest registered ancestor prefix (or None),
    forming the trie that longest-prefix-match lookups walk.
    ``manifest``/``token_ids`` are present on the live path and absent
    for the simulator's synthetic entries.

    ``ttl`` (seconds, None = immortal) bounds residency measured from
    the entry's ``stored_at`` time: a stale copy is dropped lazily at
    the next lookup that touches it and eagerly by the eviction scan
    (re-admission refreshes the clock).  ``ttl=0`` means "expire on the
    next access after storage" — a clock-scale-free idiom the
    cross-environment tests rely on.  ``pinned`` entries are never
    evicted and never expire (operator-protected residency).
    """

    key: str
    n_tokens: int
    bytes_by_resolution: Dict[str, int]
    raw_kv_bytes: int = 0
    parent: Optional[str] = None
    manifest: Optional[KVManifest] = None
    token_ids: Optional[np.ndarray] = None
    ttl: Optional[float] = None
    pinned: bool = False

    @property
    def stored_bytes(self) -> int:
        """Total encoded footprint (bytes) — the admission/eviction unit."""
        return sum(self.bytes_by_resolution.values())

    @staticmethod
    def from_manifest(manifest: KVManifest, *,
                      raw_kv_bytes: int = 0,
                      parent: Optional[str] = None,
                      token_ids: Optional[np.ndarray] = None,
                      ttl: Optional[float] = None,
                      pinned: bool = False) -> "StoredPrefix":
        by_res: Dict[str, int] = {}
        for (_, res), blob in manifest.blobs.items():
            by_res[res] = by_res.get(res, 0) + len(blob)
        return StoredPrefix(key=manifest.prefix, n_tokens=manifest.n_tokens,
                            bytes_by_resolution=by_res,
                            raw_kv_bytes=raw_kv_bytes, parent=parent,
                            manifest=manifest, token_ids=token_ids,
                            ttl=ttl, pinned=pinned)

    def __repr__(self) -> str:
        mb = self.stored_bytes / 1e6
        par = f", parent={self.parent}" if self.parent else ""
        return (f"StoredPrefix({self.key}, {self.n_tokens} tok, "
                f"{mb:.2f} MB{par})")


def synthetic_stored_prefix(key: str, n_tokens: int, *,
                            raw_bytes_per_token: float,
                            ratios: Dict[str, float],
                            parent: Optional[str] = None,
                            ttl: Optional[float] = None,
                            pinned: bool = False) -> "StoredPrefix":
    """Manifest-less entry for the simulator: encoded sizes are derived
    from the raw KV footprint and per-resolution compression ratios, the
    same model `ServingSimulator._chunk_bytes` uses for wire sizes."""
    raw = int(raw_bytes_per_token * n_tokens)
    by_res = {res: int(raw / ratio) for res, ratio in ratios.items()}
    return StoredPrefix(key=key, n_tokens=n_tokens,
                        bytes_by_resolution=by_res, raw_kv_bytes=raw,
                        parent=parent, ttl=ttl, pinned=pinned)


# ---------------------------------------------------------------------------
# One capacity-bounded node
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Resident:
    """Node-local accounting for one resident prefix.

    ``res_bytes`` is the *resident* subset of the entry's resolution
    ladder (per-resolution eviction shrinks it; the catalog entry keeps
    the full ladder).  ``res_hits``/``res_used`` record which rungs the
    adaptive fetcher actually delivered (fed by
    :meth:`StorageNode.note_resolution_use`); ``res_used`` is a
    node-global use sequence number, not a clock, so recency compares
    identically in both environments.
    """
    entry: StoredPrefix
    stored_at: float
    last_used: float
    hits: int = 0
    seq: int = 0  # admission order, the deterministic tie-breaker
    res_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    res_hits: Dict[str, int] = dataclasses.field(default_factory=dict)
    res_used: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class NodeStats:
    hits: int = 0
    evictions: int = 0
    admissions: int = 0
    rejections: int = 0  # entry alone exceeds capacity / pinned-full node
    bytes_served: int = 0  # encoded bytes of served (full-hit) lookups
    expirations: int = 0  # TTL-expired entries dropped (lazy or eager)
    failures: int = 0  # times this node failed (residents lost)


class StorageNode:
    """One storage server: capacity in bytes, pluggable eviction, and an
    optional dedicated network link.

    Eviction policies (who goes first when over capacity):

    ``lru``   least-recently-used entry (oldest ``last_used``).
    ``lfu``   least-frequently-used (fewest hits; LRU among ties).
    ``cost``  lowest bytes-saved-per-byte-stored score
              ``hits * raw_kv_bytes / stored_bytes`` — an entry earns its
              residency by the raw KV bytes its hits avoided, normalized
              by the encoded bytes it occupies.  Never-hit entries score
              0 and churn among themselves (LRU order) while proven-hot
              prefixes survive scan pressure that would flush an LRU.

    ``capacity_bytes=None`` means unbounded (the legacy flat-store
    behaviour `KVStore` keeps).  ``link`` is the node's own
    `SharedLink`; fetches for prefixes resident here are routed over it,
    so placement decisions change observed TTFT.

    Eviction granularity:

    ``evict_granularity="prefix"`` (default) evicts whole prefixes —
    the legacy behaviour every existing baseline assumes.
    ``"resolution"`` evicts one *resolution rung* at a time: the victim
    is the coldest ``(prefix, resolution)`` pair under the node's
    policy (per-rung hits/recency fed by :meth:`note_resolution_use`,
    same tie-breakers), so capacity pressure sheds the ladder rungs the
    adaptive fetcher never picks while the prefix itself stays
    fetchable.  Only when a prefix's *last* rung is the victim does the
    whole prefix go.  The resident subset is visible via
    :meth:`resident_resolutions` and travels on `StorageHit.resolutions`
    so the fetch controller only selects among rungs that still exist.
    """

    POLICIES = ("lru", "lfu", "cost")

    def __init__(self, node_id: str, capacity_bytes: Optional[float] = None,
                 *, policy: str = "lru", link=None,
                 evict_granularity: str = "prefix"):
        assert policy in self.POLICIES, policy
        assert evict_granularity in ("prefix", "resolution"), \
            evict_granularity
        self.node_id = node_id
        self.capacity_bytes = (None if capacity_bytes is None
                               else int(capacity_bytes))
        self.policy = policy
        self.evict_granularity = evict_granularity
        # one persistent SharedLink per node (a bare BandwidthTrace is
        # wrapped once here, NOT per fetch, so concurrent fetches from
        # this node contend on the same arbiter)
        self.link = None if link is None else make_link(link)
        self.residents: Dict[str, _Resident] = {}
        self.used_bytes = 0
        self.bytes_by_resolution: Dict[str, int] = {}
        self.stats = NodeStats()
        self.failed = False
        self._seq = 0
        self._use_seq = 0  # per-resolution recency counter (clock-free)

    def __repr__(self) -> str:
        cap = ("unbounded" if self.capacity_bytes is None else
               f"{self.used_bytes / GB:.2f}/{self.capacity_bytes / GB:.2f} GB")
        state = ", FAILED" if self.failed else ""
        return (f"StorageNode({self.node_id}, {cap}, policy={self.policy}, "
                f"{len(self.residents)} prefixes{state})")

    # -- failure ------------------------------------------------------------
    @property
    def alive(self) -> bool:
        return not self.failed

    def fail(self) -> List[str]:
        """Take this node down: every resident prefix is lost (residency
        is volatile; the cluster catalog is the durable copy).  Returns
        the lost keys in admission order so the cluster can plan heals
        deterministically."""
        lost = list(self.residents)
        self.residents.clear()
        self.used_bytes = 0
        self.bytes_by_resolution = {}
        self.failed = True
        self.stats.failures += 1
        return lost

    def recover(self) -> None:
        """Bring the node back, empty: it rejoins the ring and refills
        organically (placement, heals, write-on-miss)."""
        self.failed = False

    # -- TTL ----------------------------------------------------------------
    def is_expired(self, key: str, now: float) -> bool:
        r = self.residents.get(key)
        if r is None or r.entry.pinned or r.entry.ttl is None:
            return False
        return now - r.stored_at > r.entry.ttl

    def expire_key(self, key: str) -> None:
        self._remove(key)
        self.stats.expirations += 1

    def sweep_expired(self, now: float) -> List[str]:
        """Eager TTL scan (runs before any eviction decision): drop every
        expired entry so a stale copy never wins residency over a live
        admission.  Returns the dropped keys in admission order."""
        stale = [k for k, r in self.residents.items()
                 if self.is_expired(k, now)]
        for k in stale:
            self.expire_key(k)
        return stale

    # -- residency ----------------------------------------------------------
    def contains(self, key: str) -> bool:
        return key in self.residents

    def get(self, key: str, now: float) -> Optional[StoredPrefix]:
        """Serve a lookup: touches recency/frequency accounting.  A
        TTL-expired entry is dropped lazily here and misses."""
        r = self.residents.get(key)
        if r is None:
            return None
        if self.is_expired(key, now):
            self.expire_key(key)
            return None
        r.last_used = now
        r.hits += 1
        self.stats.hits += 1
        self.stats.bytes_served += sum(r.res_bytes.values())
        return r.entry

    def put(self, entry: StoredPrefix, now: float
            ) -> Tuple[bool, List[str]]:
        """Admit ``entry``, evicting by policy until it fits.

        Returns ``(admitted, evicted_keys)``.  An entry larger than the
        whole node is rejected (never admitted by flushing everything);
        so is one that cannot fit beside the node's *pinned* residents
        (pins are never evicted to make room).  Expired entries are
        swept eagerly before any victim is chosen.  Re-admitting a
        resident key replaces the stored artifact in place — byte
        accounting follows the new version, hit history is kept (it is
        the same prefix) — and refreshes its TTL clock.
        """
        assert self.alive, f"put() on failed node {self.node_id}"
        self.sweep_expired(now)
        size = entry.stored_bytes
        old = self.residents.get(entry.key)
        if old is not None:
            self._remove(entry.key)
        if self.capacity_bytes is not None:
            pinned_bytes = sum(r.entry.stored_bytes
                               for r in self.residents.values()
                               if r.entry.pinned)
            if size > self.capacity_bytes - pinned_bytes:
                if old is not None:  # keep the previous version resident
                    self.residents[entry.key] = old
                    self._account(old.res_bytes, +1)
                self.stats.rejections += 1
                return False, []
        evicted: List[str] = []
        while (self.capacity_bytes is not None
               and self.used_bytes + size > self.capacity_bytes):
            if self.evict_granularity == "resolution":
                vkey, vres = self._pick_victim_res()
                if vres is None:  # last rung: the whole prefix goes
                    self._drop(vkey)
                    evicted.append(vkey)
                else:
                    self._drop_res(vkey, vres)
                    evicted.append(f"{vkey}/{vres}")
            else:
                victim = self._pick_victim()
                self._drop(victim)
                evicted.append(victim)
        if old is not None:
            seq, hits = old.seq, old.hits
            res_hits, res_used = old.res_hits, old.res_used
        else:
            self._seq += 1
            seq, hits = self._seq, 0
            self.stats.admissions += 1
            res_hits, res_used = {}, {}
        # re-admission restores the full ladder (evicted rungs return)
        self.residents[entry.key] = _Resident(
            entry, stored_at=now, last_used=now, seq=seq, hits=hits,
            res_bytes=dict(entry.bytes_by_resolution),
            res_hits=res_hits, res_used=res_used)
        self._account(entry.bytes_by_resolution, +1)
        return True, evicted

    def _account(self, by_res: Dict[str, int], sign: int) -> None:
        for res, b in by_res.items():
            self.used_bytes += sign * b
            self.bytes_by_resolution[res] = \
                self.bytes_by_resolution.get(res, 0) + sign * b

    def _remove(self, key: str) -> None:
        """Drop residency + byte accounting (no eviction stat)."""
        r = self.residents.pop(key)
        self._account(r.res_bytes, -1)

    def _drop(self, key: str) -> None:
        self._remove(key)
        self.stats.evictions += 1

    def _drop_res(self, key: str, res: str) -> None:
        """Evict one resolution rung of a resident prefix."""
        r = self.residents[key]
        b = r.res_bytes.pop(res)
        self._account({res: b}, -1)
        self.stats.evictions += 1

    def _pick_victim(self) -> str:
        """Deterministic victim selection: policy score, then LRU order,
        then admission order (``seq``) so equal entries break ties the
        same way in every environment.  Pinned entries are never
        candidates (``put`` rejects up front when pins alone leave no
        room, so a victim always exists here)."""
        def lru_key(r: _Resident):
            return (r.last_used, r.seq)

        rs = [r for r in self.residents.values() if not r.entry.pinned]
        if self.policy == "lru":
            victim = min(rs, key=lru_key)
        elif self.policy == "lfu":
            victim = min(rs, key=lambda r: (r.hits,) + lru_key(r))
        else:  # cost: bytes saved per byte stored
            def score(r: _Resident) -> float:
                saved = r.hits * max(r.entry.raw_kv_bytes,
                                     r.entry.stored_bytes)
                return saved / max(r.entry.stored_bytes, 1)
            victim = min(rs, key=lambda r: (score(r),) + lru_key(r))
        return victim.entry.key

    def _pick_victim_res(self) -> Tuple[str, Optional[str]]:
        """Per-resolution victim: the coldest resident ``(prefix,
        rung)`` pair under the node's policy.  Recency is the clock-free
        ``res_used`` sequence; ties break on the prefix's LRU order,
        admission order, then ladder position — deterministic in every
        environment.  Returns ``(key, None)`` when the victim is the
        prefix's last resident rung (caller drops the whole prefix)."""
        res_idx = {r: i for i, r in enumerate(RESOLUTION_ORDER)}

        def cand_key(r: _Resident, res: str):
            recency = (r.res_used.get(res, 0), r.last_used, r.seq,
                       res_idx.get(res, -1))
            if self.policy == "lru":
                return recency
            hits = r.res_hits.get(res, 0)
            if self.policy == "lfu":
                return (hits,) + recency
            # cost: bytes saved per byte stored, per rung
            saved = hits * max(r.entry.raw_kv_bytes, r.res_bytes[res])
            return (saved / max(r.res_bytes[res], 1),) + recency

        best = None
        best_key = None
        for r in self.residents.values():
            if r.entry.pinned:
                continue
            for res in r.res_bytes:
                k = cand_key(r, res)
                if best_key is None or k < best_key:
                    best_key, best = k, (r, res)
        assert best is not None, "no evictable rung (all pinned?)"
        r, res = best
        if len(r.res_bytes) == 1:
            return r.entry.key, None
        return r.entry.key, res

    def note_resolution_use(self, key: str, res: str) -> None:
        """Record that the fetch path actually delivered ``res`` of
        ``key`` from this node (fed by the controller's ``res_sink``
        at fetch completion).  Bumps the rung's hit count and recency
        sequence so per-resolution eviction keeps the rungs the
        adaptive selector really uses."""
        r = self.residents.get(key)
        if r is None or res not in r.res_bytes:
            return
        self._use_seq += 1
        r.res_hits[res] = r.res_hits.get(res, 0) + 1
        r.res_used[res] = self._use_seq

    def resident_resolutions(self, key: str) -> Optional[Tuple[str, ...]]:
        """The resolutions of ``key`` still resident here (ladder order),
        or None when the prefix is not resident at all."""
        r = self.residents.get(key)
        if r is None:
            return None
        res_idx = {res: i for i, res in enumerate(RESOLUTION_ORDER)}
        return tuple(sorted(r.res_bytes, key=lambda s: res_idx.get(s, -1)))

    def stored_bytes(self) -> int:
        """Total encoded bytes resident on this node."""
        return self.used_bytes


# ---------------------------------------------------------------------------
# The cluster: placement, replication, longest-prefix-match lookup
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StorageHit:
    """Result of a cluster lookup.

    ``kind``: ``"full"`` (the requested prefix is resident — fetch it
    all), ``"partial"`` (only an *ancestor* is resident: fetch
    ``entry`` and recompute the ``requested_tokens - covered_tokens``
    tail), or ``"miss"`` (recompute everything; ``entry``/``node`` are
    None).  On a miss of a *cataloged* prefix, ``missed_key`` names it
    so the environment can call
    :meth:`StorageCluster.notify_recompute_done` once the fallback
    prefill finishes (delayed write-on-miss).

    ``resolutions`` is the serving node's *resident* rung set for
    ``entry`` (ladder order) — per-resolution eviction may have shed
    rungs, and the adaptive fetcher must only select among blobs that
    still exist.  None means unrestricted (miss, or caller that does
    not track residency).
    """

    kind: str  # "full" | "partial" | "miss"
    requested_tokens: int
    covered_tokens: int = 0
    entry: Optional[StoredPrefix] = None
    node: Optional[StorageNode] = None
    missed_key: Optional[str] = None
    resolutions: Optional[Tuple[str, ...]] = None


class StorageCluster:
    """Places prefixes across :class:`StorageNode`\\ s and resolves
    lookups to full / partial / miss outcomes.

    Placement
    ---------
    ``hash``     consistent hashing: each node projects ``vnodes``
                 points onto a hash ring; a prefix lives on the
                 successor of its own point.  Node membership changes
                 move only ~1/N of the keys.
    ``popular``  consistent hashing **plus** popularity-aware
                 replication: once a prefix's cluster-wide hits reach
                 ``replicate_threshold`` it is copied to the next
                 distinct node on the ring, and lookups rotate
                 round-robin across the resident replicas' links — hot
                 prefixes stop queueing behind each other.

    The **catalog** is the durable origin (donor-side artifact
    registry): it survives node evictions *and failures*, so a miss
    re-admits the prefix after the recompute finishes (pull-through
    semantics; see :meth:`notify_recompute_done`) and heals re-seed
    from it when no replica survives.  Only node *residency* is
    capacity-bounded.

    Fault tolerance
    ---------------
    ``replication`` is the target copy count at registration (and heal)
    time: an entry is placed on the first ``replication`` distinct
    alive ring nodes.  :meth:`fail_node` drops a node from the ring
    (its keys re-route to their successors), loses its residents, and
    enqueues re-replication tasks; ``heal="sync"`` completes them
    immediately (clock-free — replay tests), ``heal="link"`` streams
    each heal over the source node's own `SharedLink` at
    ``heal_weight`` so heal traffic contends with live fetches (the
    environments wire the event queue via :meth:`bind`).

    Admission control
    -----------------
    ``admission="always"`` stores everything (legacy).
    ``"second_hit"`` stores a prefix only once it has been *asked for*
    ``admission_min_asks`` times (one-shot prefixes never earn bytes).
    ``"cost"`` stores only when the projected
    bytes-saved-per-byte-stored score ``asks * raw_kv_bytes /
    stored_bytes`` reaches ``admission_min_score`` (default 1.0 —
    break-even: the store must expect to save at least the bytes it
    spends; a score of 0 would admit everything).  Heals bypass
    admission (they restore residency the controller already granted).

    Recovery re-balance
    ------------------
    :meth:`recover_node` does not leave the recovered node empty: keys
    whose preferred replica set (first ``replication`` ring nodes) now
    includes it, but whose copies sit on later ring successors, are
    streamed back through the heal machinery (``rebalance`` events) and
    the surplus successor copies are trimmed (``rebalance_drop``) —
    otherwise primary lookups pay the successor hop forever and
    occupancy stays skewed on the ring.

    RTT-aware source selection
    --------------------------
    The fetch controller reports each completed fetch's smoothed RTT
    via :meth:`observe_rtt`; replica picks and heal sources then avoid
    nodes whose observed RTT is more than ``RTT_SLACK`` above the best
    known node.  Nodes within the slack band (and nodes with no samples
    yet) stay in the legacy round-robin rotation, so behaviour — and
    the event log's determinism as a pure function of the access
    sequence — is unchanged until the RTT signal actually diverges.

    Every decision is appended to :attr:`events` as ``(kind, key,
    node_id)`` tuples — ``admit``/``evict``/``hit``/``partial``/
    ``miss``/``replicate``/``reject``/``fail``/``heal``/``recover``/
    ``rebalance``/``rebalance_drop``/``expire`` — deterministically for
    a given access sequence and churn schedule.
    """

    #: EWMA gain for per-node smoothed-RTT observations.
    RTT_GAIN = 0.3
    #: relative band around the best known node RTT inside which
    #: replicas are considered equivalent and rotation applies
    RTT_SLACK = 0.25

    def __init__(self, nodes: Sequence[StorageNode], *,
                 placement: str = "hash", replicate_threshold: int = 3,
                 vnodes: int = 64, write_on_miss: bool = True,
                 replication: int = 1, heal: str = "sync",
                 heal_weight: float = HEAL_WEIGHT,
                 admission: str = "always", admission_min_asks: int = 2,
                 admission_min_score: float = 1.0):
        assert placement in ("hash", "popular"), placement
        assert heal in ("sync", "link", "manual"), heal
        assert admission in ("always", "second_hit", "cost"), admission
        assert len(nodes) > 0
        assert 1 <= replication <= len(nodes), replication
        assert len({n.node_id for n in nodes}) == len(nodes), \
            "duplicate node ids"
        self.nodes = list(nodes)
        self.by_id = {n.node_id: n for n in self.nodes}
        self.placement = placement
        self.replicate_threshold = replicate_threshold
        self.write_on_miss = write_on_miss
        self.replication = replication
        self.heal = heal
        self.heal_weight = heal_weight
        self.admission = admission
        self.admission_min_asks = admission_min_asks
        self.admission_min_score = admission_min_score
        self.catalog: Dict[str, StoredPrefix] = {}
        self.hits_by_key: Dict[str, int] = {}
        self.asks_by_key: Dict[str, int] = {}  # lookups incl. misses
        self.events: List[Tuple[str, str, str]] = []
        self.lookups = 0
        self.full_hits = 0
        self.partial_hits = 0
        self.misses = 0
        self.heals_completed = 0
        self.rebalances_completed = 0
        # per-node smoothed RTT, fed by the fetch controller from each
        # completed fetch's RttEstimator (replica/heal-source
        # selection avoids the most-contended node)
        self.node_rtt: Dict[str, float] = {}
        # heal="manual": tasks wait here for pump_heal() (wall-clock
        # engines have no virtual event queue to schedule them on);
        # entries are (entry, source_id, target_id, kind)
        self.heal_queue: List[
            Tuple[StoredPrefix, Optional[str], str, str]] = []
        # delayed write-on-miss: keys whose recompute is outstanding.
        # An insertion-ordered dict (not a set): the heal/recompute
        # paths may drain it, and a set of str keys would drain in
        # per-process hash order, silently breaking cross-env replay
        # (repro-lint ordered-iteration)
        self._pending_recompute: Dict[str, None] = {}
        # external event-queue hook (heal="link"): push(t, fn)
        self._push = None
        self._heal_flow = 0  # negative flow ids, distinct from rids
        self._ring: List[Tuple[int, str]] = []
        for n in self.nodes:
            for v in range(vnodes):
                self._ring.append((self._point(f"{n.node_id}#{v}"),
                                   n.node_id))
        self._ring.sort()

    def __repr__(self) -> str:
        used = sum(n.used_bytes for n in self.nodes)
        return (f"StorageCluster({len(self.nodes)} nodes, "
                f"{self.placement}, {len(self.catalog)} cataloged, "
                f"{used / GB:.2f} GB resident)")

    @staticmethod
    def _point(s: str) -> int:
        return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8],
                              "big")

    def _ring_nodes(self, key: str) -> List[StorageNode]:
        """Distinct **alive** nodes in ring order starting at ``key``'s
        successor — a failed node simply vanishes from every key's
        successor list, which is the whole re-route story."""
        p = self._point(key)
        i = 0
        while i < len(self._ring) and self._ring[i][0] < p:
            i += 1
        seen: List[str] = []
        for j in range(len(self._ring)):
            nid = self._ring[(i + j) % len(self._ring)][1]
            if nid not in seen:
                seen.append(nid)
            if len(seen) == len(self.nodes):
                break
        return [self.by_id[nid] for nid in seen if self.by_id[nid].alive]

    def primary_node(self, key: str) -> StorageNode:
        ring = self._ring_nodes(key)
        assert ring, "every storage node has failed"
        return ring[0]

    def alive_nodes(self) -> List[StorageNode]:
        return [n for n in self.nodes if n.alive]

    # -- registration -------------------------------------------------------
    def register(self, entry: StoredPrefix, now: float = 0.0) -> None:
        """Catalog ``entry`` and — admission permitting — place it on
        the first ``replication`` alive ring nodes."""
        self.catalog[entry.key] = entry
        self.hits_by_key.setdefault(entry.key, 0)
        if not self._admit_ok(entry):
            self.events.append(("reject", entry.key, ""))
            return
        self._place_replicas(entry, now, skip_resident=False)

    def register_prefix(self, token_ids: np.ndarray, kv_k: np.ndarray,
                        kv_v: np.ndarray, *, now: float = 0.0,
                        ttl: Optional[float] = None, pinned: bool = False,
                        **kw) -> StoredPrefix:
        """Encode real KV into a manifest (like the legacy `KVStore`),
        auto-detect the longest registered ancestor from ``token_ids``,
        and register the result."""
        token_ids = np.asarray(token_ids)
        key = prefix_key(token_ids)
        man = encode_prefix(kv_k, kv_v, prefix=key, **kw)
        parent = self._longest_cataloged(token_ids, below=len(token_ids))
        entry = StoredPrefix.from_manifest(
            man, raw_kv_bytes=int(kv_k.nbytes + kv_v.nbytes),
            parent=parent.key if parent else None, token_ids=token_ids,
            ttl=ttl, pinned=pinned)
        self.register(entry, now)
        return entry

    def _place_replicas(self, entry: StoredPrefix, now: float, *,
                        skip_resident: bool) -> bool:
        """Place ``entry`` on its first ``replication`` alive ring
        nodes.  ``skip_resident=True`` leaves existing copies (and
        their TTL clocks) untouched — the write-on-miss path;
        ``False`` replaces them in place, refreshing the TTL — the
        register/operator-admit semantics."""
        ok = False
        for node in self._ring_nodes(entry.key)[:self.replication]:
            if skip_resident and node.contains(entry.key):
                continue
            ok |= self._place(entry, node, now)
        return ok

    def _place(self, entry: StoredPrefix, node: StorageNode,
               now: float, *, kind: str = "admit") -> bool:
        # eager TTL at the eviction scan, logged here; put() sweeps
        # again internally (node-level contract for direct users like
        # KVStore) but finds nothing — same `now`
        for k in node.sweep_expired(now):
            self.events.append(("expire", k, node.node_id))
        ok, evicted = node.put(entry, now)
        for k in evicted:
            # per-resolution eviction reports "key/res" tokens (prefix
            # keys are hex digests, so "/" is unambiguous)
            kind_ev = ("evict_res" if node.evict_granularity == "resolution"
                       and "/" in k else "evict")
            self.events.append((kind_ev, k, node.node_id))
        if ok:
            self.events.append((kind, entry.key, node.node_id))
        else:
            self.events.append(("reject", entry.key, node.node_id))
        return ok

    # -- admission control ---------------------------------------------------
    def _admit_ok(self, entry: StoredPrefix) -> bool:
        """Should this entry be granted node residency at all?"""
        if self.admission == "always":
            return True
        asks = self.asks_by_key.get(entry.key, 0)
        if self.admission == "second_hit":
            return asks >= self.admission_min_asks
        # documented formula, no floor: an entry whose encoding saves
        # nothing (raw <= stored, or raw unknown) scores accordingly low
        # — those are exactly the writes this gate exists to filter
        return asks * entry.raw_kv_bytes / max(entry.stored_bytes, 1) \
            >= self.admission_min_score

    # -- lookup -------------------------------------------------------------
    def _resident_nodes(self, key: str,
                        now: Optional[float] = None) -> List[StorageNode]:
        """Alive nodes holding ``key``, in deterministic ring order.
        With ``now``, TTL-expired copies are dropped lazily here (and
        logged) before they can serve the lookup."""
        out: List[StorageNode] = []
        for n in self._ring_nodes(key):
            if not n.contains(key):
                continue
            if now is not None and n.is_expired(key, now):
                n.expire_key(key)
                self.events.append(("expire", key, n.node_id))
                continue
            out.append(n)
        return out

    def note_resolution_use(self, node_id: str, key: str,
                            res: str) -> None:
        """Per-resolution usage feedback from the fetch controller's
        ``res_sink`` hook: the fetch for ``key`` served from ``node_id``
        actually delivered resolution ``res``.  Not logged to
        :attr:`events` (it is derived from the fetch outcome, which the
        replay tests already compare); it only steers per-resolution
        eviction recency/frequency on the node."""
        node = self.by_id.get(node_id)
        if node is None or not node.alive:
            return
        node.note_resolution_use(key, res)

    def observe_rtt(self, node_id: str, srtt: float) -> None:
        """Fold one completed fetch's smoothed RTT into ``node_id``'s
        EWMA (fed by ``FetchController`` via its ``rtt_sink`` hook).
        The per-flow `RttEstimator` already smooths within a fetch;
        this smooths across fetches so one contended transfer does not
        blacklist a node forever."""
        if node_id not in self.by_id or srtt is None:
            return
        prev = self.node_rtt.get(node_id)
        self.node_rtt[node_id] = (srtt if prev is None else
                                  prev + self.RTT_GAIN * (srtt - prev))

    def _rtt_candidates(self,
                        nodes: List[StorageNode]) -> List[StorageNode]:
        """Drop nodes whose observed RTT sits more than ``RTT_SLACK``
        above the best known node; unsampled nodes are kept (optimistic
        — they must be explored before they can be judged)."""
        rtts = [self.node_rtt.get(n.node_id) for n in nodes]
        known = [r for r in rtts if r is not None]
        if not known:
            return nodes
        best = min(known)
        return [n for n, r in zip(nodes, rtts)
                if r is None or r <= best * (1.0 + self.RTT_SLACK)]

    def _pick_replica(self, key: str,
                      nodes: List[StorageNode]) -> StorageNode:
        """Rotate across resident replicas by this key's lookup count —
        spreads concurrent fetches over the replicas' links while
        staying a pure function of the access sequence (unlike e.g.
        least-in-flight, which would make the event log clock-dependent
        and break cross-environment determinism).  Replicas whose
        observed RTT has drifted ``RTT_SLACK`` above the best node are
        excluded from the rotation (fetches stop piling onto
        the most-contended replica); with no or uniform RTT data this
        degenerates to the legacy rotation."""
        cand = self._rtt_candidates(nodes)
        return cand[self.hits_by_key.get(key, 0) % len(cand)]

    def _pick_heal_source(self,
                          nodes: List[StorageNode]) -> StorageNode:
        """Heal/re-balance source: the lowest observed-RTT holder, ring
        order breaking ties; a node with no samples scores as best
        (legacy ``survivors[0]`` behaviour until data says otherwise)."""
        return min(nodes,
                   key=lambda n: self.node_rtt.get(n.node_id, 0.0))

    def _longest_cataloged(self, token_ids: np.ndarray, *,
                           below: int) -> Optional[StoredPrefix]:
        """Longest cataloged prefix of ``token_ids`` shorter than
        ``below`` tokens (linear scan over the catalog; the catalog holds
        registered prefixes, not per-request state, so it stays small)."""
        best: Optional[StoredPrefix] = None
        for e in self.catalog.values():
            if e.token_ids is None or e.n_tokens >= below:
                continue
            if e.n_tokens > len(token_ids):
                continue
            if best is not None and e.n_tokens <= best.n_tokens:
                continue
            if np.array_equal(e.token_ids,
                              np.asarray(token_ids[:e.n_tokens])):
                best = e
        return best

    def _ancestor_chain(self, key: str) -> List[StoredPrefix]:
        """``key``'s cataloged ancestors, nearest first (via ``parent``
        links; used by the simulator where entries carry no token ids)."""
        out: List[StoredPrefix] = []
        cur = self.catalog.get(key)
        seen = {key}
        while cur is not None and cur.parent and cur.parent not in seen:
            seen.add(cur.parent)
            cur = self.catalog.get(cur.parent)
            if cur is not None:
                out.append(cur)
        return out

    def lookup(self, key: str, now: float,
               requested_tokens: Optional[int] = None) -> StorageHit:
        """Resolve a fetch for prefix ``key``: full hit if resident,
        partial hit on the nearest resident ancestor, else miss.  With
        ``write_on_miss``, a missed *cataloged* prefix becomes a pending
        write that :meth:`notify_recompute_done` resolves once the
        fallback prefill actually finishes — the donor cannot re-upload
        KV that does not exist yet."""
        self.lookups += 1
        self.asks_by_key[key] = self.asks_by_key.get(key, 0) + 1
        want = self.catalog.get(key)
        requested = (requested_tokens if requested_tokens is not None
                     else (want.n_tokens if want else 0))
        candidates = [want] if want else []
        candidates += self._ancestor_chain(key)
        for cand in candidates:
            nodes = self._resident_nodes(cand.key, now)
            if not nodes:
                continue
            node = self._pick_replica(cand.key, nodes)
            node.get(cand.key, now)
            self.hits_by_key[cand.key] = \
                self.hits_by_key.get(cand.key, 0) + 1
            full = cand.key == key and cand.n_tokens >= requested
            kind = "full" if full else "partial"
            self.events.append((kind, cand.key, node.node_id))
            if full:
                self.full_hits += 1
            else:
                self.partial_hits += 1
            self._maybe_replicate(cand, now)
            return StorageHit(kind=kind, requested_tokens=requested,
                              covered_tokens=min(cand.n_tokens, requested),
                              entry=cand, node=node,
                              resolutions=node.resident_resolutions(
                                  cand.key))
        self.misses += 1
        self.events.append(("miss", key, ""))
        if self.write_on_miss and want is not None:
            self._pending_recompute[key] = None
        return StorageHit(kind="miss", requested_tokens=requested,
                          missed_key=want.key if want else None)

    def notify_recompute_done(self, key: str, now: float) -> None:
        """The fallback full prefill for a missed prefix completed: the
        KV exists again, so the delayed write-on-miss can re-admit it
        (admission control permitting).  Called by both environments
        when a ``storage_hit == "miss"`` request reaches its first
        token; a no-op for keys with no pending write."""
        if key not in self._pending_recompute:
            return
        self._pending_recompute.pop(key, None)
        entry = self.catalog.get(key)
        if entry is None:
            return
        if not self._admit_ok(entry):
            self.events.append(("reject", key, ""))
            return
        self._place_replicas(entry, now, skip_resident=True)

    def lookup_tokens(self, token_ids: np.ndarray,
                      now: float) -> StorageHit:
        """Longest-prefix-match lookup by token ids (live-engine path):
        resolve the longest cataloged prefix of ``token_ids``, then fall
        through :meth:`lookup` for residency/ancestors/replication."""
        token_ids = np.asarray(token_ids)
        best = self._longest_cataloged(token_ids,
                                       below=len(token_ids) + 1)
        if best is None:
            key = prefix_key(token_ids)
            self.lookups += 1
            self.asks_by_key[key] = self.asks_by_key.get(key, 0) + 1
            self.misses += 1
            self.events.append(("miss", key, ""))
            return StorageHit(kind="miss",
                              requested_tokens=len(token_ids))
        return self.lookup(best.key, now,
                           requested_tokens=len(token_ids))

    def admit(self, key: str, now: float) -> bool:
        """Explicitly (re-)admit a cataloged prefix onto its first
        ``replication`` alive ring nodes — the operator override that
        bypasses admission control (misses go through the delayed
        :meth:`notify_recompute_done` path instead).  Existing copies
        are replaced in place, refreshing their TTL clocks."""
        entry = self.catalog.get(key)
        if entry is None:
            return False
        return self._place_replicas(entry, now, skip_resident=False)

    def _maybe_replicate(self, entry: StoredPrefix, now: float) -> None:
        if self.placement != "popular":
            return
        if self.hits_by_key.get(entry.key, 0) < self.replicate_threshold:
            return
        for node in self._ring_nodes(entry.key)[1:]:
            if not node.contains(entry.key):
                if self._place(entry, node, now):
                    self.events.append(("replicate", entry.key,
                                        node.node_id))
                return  # one replica per threshold crossing

    # -- node failure + ring heal -------------------------------------------
    def bind(self, push) -> None:
        """Wire the environment's event queue (``push(t, fn)`` — the
        fetch controller's, via `FetchController.push_event`) so
        ``heal="link"`` transfers can schedule their completions on the
        shared virtual clock.  Also binds every node link, so heal flows
        can join links no fetch has touched yet."""
        self._push = push
        for n in self.nodes:
            if n.link is not None:
                n.link.bind(push)

    def fail_node(self, node_id: str, now: float) -> List[str]:
        """Kill a node: its residents are lost, its keys re-route to
        their ring successors, and a re-replication queue restores the
        replication factor of every lost key — from a surviving replica
        when one exists, else from the durable catalog.  Returns the
        lost keys.  Heal transfers either complete immediately
        (``heal="sync"``) or stream over the source node's link at
        ``heal_weight`` (``heal="link"``), contending with live
        fetches."""
        node = self.by_id[node_id]
        assert node.alive, f"{node_id} already failed"
        lost = node.fail()
        self.events.append(("fail", "", node_id))
        assert self.alive_nodes(), "every storage node has failed"
        for key in lost:
            entry = self.catalog.get(key)
            if entry is None:
                continue
            # pass `now` so TTL-expired copies neither count toward the
            # replication factor nor get picked as the heal source
            survivors = self._resident_nodes(key, now)
            need = self.replication - len(survivors)
            targets = [n for n in self._ring_nodes(key)
                       if not n.contains(key)][:max(need, 0)]
            source = (self._pick_heal_source(survivors) if survivors
                      else None)
            for target in targets:
                self._start_heal(entry, source, target, now)
        return lost

    def recover_node(self, node_id: str, now: float) -> None:
        """Bring a failed node back (empty): it rejoins the ring, and
        keys it is now a preferred replica for are proactively streamed
        back from their current holders (``rebalance`` events) — without
        this, keys registered during the outage stay on ring successors
        and every primary lookup pays the successor hop forever."""
        node = self.by_id[node_id]
        assert not node.alive, f"{node_id} is not failed"
        node.recover()
        self.events.append(("recover", "", node_id))
        self._rebalance_onto(node, now)

    def _rebalance_onto(self, node: StorageNode, now: float) -> None:
        """Proactive key re-balance after recovery: every cataloged key
        whose first ``replication`` ring nodes include ``node`` but
        which is resident only on later successors is copied back over
        the heal machinery (same transports/weights); once the copy
        lands, surplus copies beyond the replication factor are trimmed
        from non-preferred holders, de-skewing occupancy.  Catalog
        insertion order keeps the event log a pure function of the
        access/churn sequence."""
        for key, entry in self.catalog.items():
            if node not in self._ring_nodes(key)[:self.replication]:
                continue
            if node.contains(key):
                continue
            holders = self._resident_nodes(key, now)
            if not holders:
                continue  # nothing resident: write-on-miss path owns it
            source = self._pick_heal_source(holders)
            self._start_heal(entry, source, node, now, kind="rebalance")

    def _trim_surplus(self, key: str, now: float) -> None:
        """Drop copies beyond the replication factor from non-preferred
        holders (reverse ring order), keeping preferred copies."""
        preferred = {n.node_id
                     for n in self._ring_nodes(key)[:self.replication]}
        holders = self._resident_nodes(key, now)
        for n in reversed(holders):
            if len(holders) <= self.replication:
                return
            if n.node_id in preferred:
                continue
            n._remove(key)
            holders.remove(n)
            self.events.append(("rebalance_drop", key, n.node_id))

    def _start_heal(self, entry: StoredPrefix,
                    source: Optional[StorageNode],
                    target: StorageNode, now: float, *,
                    kind: str = "heal") -> None:
        """One re-replication transfer.  The wire path is the source
        node's own link (the durable catalog re-seeds over the target's
        link — the donor uploads into the target); a heal flow joins at
        ``heal_weight`` so live fetches keep link priority.  Modes:
        ``sync`` completes here, ``manual`` queues for
        :meth:`pump_heal` (wall-clock engines), ``link`` schedules the
        completion on the bound event queue."""
        if self.heal == "manual":
            self.heal_queue.append(
                (entry, source.node_id if source else None,
                 target.node_id, kind))
            return
        link = source.link if source is not None else target.link
        if self.heal == "sync" or link is None:
            self._finish_heal(entry, target, now, kind=kind)
            return
        assert self._push is not None, \
            "heal='link' needs bind() — pass the cluster to a " \
            "simulator/virtual-clock engine, or use heal='sync'/'manual'"
        self._heal_flow -= 1
        flow = self._heal_flow  # negative: never collides with a rid
        # join at the heal weight; on a ramp="slowstart" link the heal
        # flow slow-starts like any other joiner (live fetches keep
        # priority while the ring re-converges)
        link.open_flow(flow, weight=self.heal_weight, t=now)

        def done(t: float, entry=entry, target=target, link=link,
                 flow=flow, kind=kind) -> None:
            link.close_flow(flow)
            self._finish_heal(entry, target, t, kind=kind)

        link.submit(flow, entry.stored_bytes, now, done)

    def pump_heal(self, now: float) -> int:
        """Complete every queued ``heal="manual"`` task (in enqueue
        order); returns how many landed.  The operator's knob for
        staging recovery in wall-clock environments and tests."""
        tasks, self.heal_queue = self.heal_queue, []
        n = 0
        for entry, _, target_id, kind in tasks:
            target = self.by_id[target_id]
            before = self.heals_completed + self.rebalances_completed
            self._finish_heal(entry, target, now, kind=kind)
            n += (self.heals_completed + self.rebalances_completed
                  - before)
        return n

    def _finish_heal(self, entry: StoredPrefix, target: StorageNode,
                     now: float, *, kind: str = "heal") -> None:
        if not target.alive or target.contains(entry.key):
            return  # target churned away / copy arrived by another path
        if self._place(entry, target, now, kind=kind):
            if kind == "rebalance":
                self.rebalances_completed += 1
                self._trim_surplus(entry.key, now)
            else:
                self.heals_completed += 1  # rejected: not a completion

    # -- stats --------------------------------------------------------------
    def hit_rate(self) -> float:
        """Full+partial hits over all lookups (0.0 when no lookups)."""
        if not self.lookups:
            return 0.0
        return (self.full_hits + self.partial_hits) / self.lookups

    def stored_bytes(self) -> int:
        return sum(n.used_bytes for n in self.nodes)


# ---------------------------------------------------------------------------
# Legacy single-node facade
# ---------------------------------------------------------------------------


class KVStore:
    """The original flat in-process store, now a facade over one
    unbounded :class:`StorageNode` — same API (register / lookup /
    get_chunk return `KVManifest`\\ s), no capacity pressure, no network
    placement.  Integration tests and the quickstart keep using it; the
    multi-node tier above is the production-shaped path."""

    def __init__(self) -> None:
        self.node = StorageNode("local", capacity_bytes=None)

    @property
    def manifests(self) -> Dict[str, KVManifest]:
        return {k: r.entry.manifest for k, r in self.node.residents.items()
                if r.entry.manifest is not None}

    def register(self, manifest: KVManifest) -> None:
        self.node.put(StoredPrefix.from_manifest(manifest), now=0.0)

    def register_prefix(self, token_ids: np.ndarray, kv_k: np.ndarray,
                        kv_v: np.ndarray, **kw) -> KVManifest:
        key = prefix_key(np.asarray(token_ids))
        man = encode_prefix(kv_k, kv_v, prefix=key, **kw)
        self.register(man)
        return man

    def lookup(self, prefix: str) -> Optional[KVManifest]:
        e = self.node.get(prefix, now=0.0)
        return e.manifest if e is not None else None

    def get_chunk(self, prefix: str, chunk_id: str, resolution: str) -> bytes:
        return self.node.residents[prefix].entry.manifest.blobs[
            (chunk_id, resolution)]

    def stored_bytes(self) -> int:
        return self.node.stored_bytes()
