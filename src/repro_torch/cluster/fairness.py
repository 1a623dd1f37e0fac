"""User-level fair scheduling for multi-tenant serving.

One abusive tenant flooding prefix fetches can starve every
well-behaved user's TTFT on the shared WAN link and the shared storage
nodes.  This module adds the enterprise serving layer the north star
asks for: a virtual-token-counter scheduler (VTC / FairServe-style —
the FCFS-vs-VTC-vs-FairServe experiment loop of SNIPPETS.md #2, the
LMCache serving layer of PAPERS.md) that tracks *per-user served cost*
and always dispatches the most lagging backlogged user next.

Counter model
-------------
Every user ``u`` carries one monotone counter ``C[u]`` in abstract
*cost units*, advanced whenever work is served on u's behalf:

* **fetched bytes** — a completed (or aborted-after-partial-delivery)
  fetch charges ``wire_bytes / byte_unit / W[u]``;
* **decode work** — admission to the running batch charges the
  *expected* serve cost ``(prefill_tokens + output_token_weight *
  max_new_tokens) * token_unit / W[u]`` (FairServe charges expected
  tokens at schedule time, which keeps the event log free of
  compute-side timing).

``W[u]`` is the weight of the user's SLO tier (``slo_tier`` →
:attr:`FairScheduler.tiers`), so a premium user's counter advances
proportionally slower — weighted fair queueing in virtual-time form.
A user (re)joining with an empty backlog is lifted to the minimum
counter among currently backlogged/in-flight users, so idling never
banks credit (the VTC no-gaming rule).

Scheduling levers
-----------------
The same tier weight drives every shared resource:

* **link** — ``Request.weight`` is stamped at arrival, so
  `SharedLink`'s weighted-fair fluid shares and DRR quanta honor the
  tier directly;
* **fetch dispatch** — queued fetches drain through :meth:`take` in
  lagging-user order, at most ``max_inflight`` on the wire at once
  (the VTC admission queue: an abusive flood backlogs behind every
  lagging well-behaved user);
* **storage** — :meth:`apply_storage_priority` maps tiers onto the
  storage tier's levers: top-tier prefixes are pinned (never evicted /
  expired), above-baseline tiers get their admission ask-counter
  seeded so ``second_hit``/``cost`` admission grants residency on
  first touch;
* **prefetch** — :meth:`prefetch_share` splits a
  `PrefetchManager`'s mispredict budget by tier weight, so one
  tenant's bad speculation cannot burn the shared budget
  (``fairness=`` on the manager).

Determinism contract
--------------------
Every decision appends a timestamp-free event ``(user, rid, kind,
counter)`` with the counter quantized to integer milli-units.  Kinds:
``arrive`` / ``dispatch`` / ``fetched`` / ``abort`` / ``miss`` /
``serve``.  All inputs are pure functions of the access sequence
(token counts, table-size wire bytes, arrival order), so the analytic
simulator and the live engine replay byte-identical logs for the same
trace (``tests/test_fairness.py``); see docs/fairness.md for the full
state machine and a worked abusive-flood timeline.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.scheduler import Request

#: event-log counter quantization: counters are logged in integer
#: milli-cost-units so cross-environment comparison is exact
COUNTER_QUANT = 1000.0


class FairScheduler:
    """Virtual-token-counter (VTC) fair scheduler over users.

    Plug it into both environments (``ServingSimulator(fairness=...)``,
    ``LiveEngine(fairness=...)``); they hand it to the shared
    `FetchingAwareScheduler`, so there is no second fairness
    implementation to drift (the no-second-pipeline rule).
    """

    #: default SLO ladder: weight = share multiplier on every lever
    DEFAULT_TIERS = {"free": 1.0, "standard": 2.0, "premium": 4.0}
    DEFAULT_TIER = "standard"

    def __init__(self, *, tiers: Optional[Dict[str, float]] = None,
                 max_inflight: Optional[int] = 2,
                 byte_unit: float = 1e6, token_unit: float = 1e-3,
                 output_token_weight: float = 2.0):
        self.tiers = dict(tiers if tiers is not None
                          else self.DEFAULT_TIERS)
        assert self.tiers and all(w > 0 for w in self.tiers.values()), \
            "tier weights must be positive"
        #: global cap on concurrently dispatched fetches (None = no
        #: cap: lagging-user *ordering* still applies, backlogging
        #: does not)
        self.max_inflight = max_inflight
        self.byte_unit = float(byte_unit)
        self.token_unit = float(token_unit)
        self.output_token_weight = float(output_token_weight)
        #: per-user served-cost counters (weight-normalized cost units)
        self.counters: Dict[str, float] = {}
        #: deterministic decision log: (user, rid, kind, milli-counter)
        self.events: List[Tuple[str, int, str, int]] = []
        self._tier_of: Dict[str, str] = {}
        self._backlog: Dict[str, Deque[Request]] = {}
        self._inflight: Dict[int, str] = {}  # rid -> user
        self._inflight_by_user: Dict[str, int] = {}
        # rids already charged decode work; an insertion-ordered dict
        # (not a set) so any future drain replays in admission order
        self._served: Dict[int, None] = {}
        self._prefix_users: Dict[str, str] = {}  # key -> last demander

    def __repr__(self) -> str:
        return (f"FairScheduler({len(self.counters)} users, "
                f"{sum(len(q) for q in self._backlog.values())} queued, "
                f"{len(self._inflight)} in flight)")

    # -- identity ----------------------------------------------------------
    @staticmethod
    def user_of(req: Request) -> str:
        return req.user if req.user is not None else "anon"

    def register(self, user: str, slo_tier: str) -> float:
        """Pin ``user`` to an SLO tier ahead of any traffic (tenant
        onboarding); returns the tier weight.  Arrivals carrying a
        ``slo_tier`` update the mapping themselves."""
        assert slo_tier in self.tiers, \
            f"unknown tier {slo_tier!r} (have {sorted(self.tiers)})"
        self._tier_of[user] = slo_tier
        return self.tiers[slo_tier]

    def tier_of(self, user: str) -> str:
        return self._tier_of.get(user, self.DEFAULT_TIER)

    def weight_of(self, user: str) -> float:
        return self.tiers.get(self.tier_of(user),
                              self.tiers.get(self.DEFAULT_TIER, 1.0))

    # -- event log ---------------------------------------------------------
    def _emit(self, user: str, rid: int, kind: str) -> None:
        self.events.append(
            (user, rid, kind,
             int(round(self.counters.get(user, 0.0) * COUNTER_QUANT))))

    # -- arrival / queueing -------------------------------------------------
    def _active_counters(self) -> List[float]:
        return [self.counters[u] for u in self.counters
                if self._backlog.get(u) or
                self._inflight_by_user.get(u, 0) > 0]

    def on_arrival(self, req: Request) -> None:
        """A request entered the system: bind the user's tier, stamp the
        link weight, and lift an idle user's counter to the active
        minimum (idling must not bank credit)."""
        u = self.user_of(req)
        if req.slo_tier is not None:
            self.register(u, req.slo_tier)
        req.weight = self.weight_of(u)
        idle = not (self._backlog.get(u)
                    or self._inflight_by_user.get(u, 0) > 0)
        active = self._active_counters()
        if idle and active:
            self.counters[u] = max(self.counters.get(u, 0.0),
                                   min(active))
        else:
            self.counters.setdefault(u, 0.0)
        if req.prefix is not None:
            self._prefix_users[req.prefix] = u
        self._emit(u, req.rid, "arrive")

    def enqueue(self, req: Request) -> None:
        """Queue one fetch for fair dispatch (called by the scheduler
        instead of handing the fetch straight to the controller)."""
        u = self.user_of(req)
        self._backlog.setdefault(u, deque()).append(req)

    def backlog_size(self, user: Optional[str] = None) -> int:
        if user is not None:
            return len(self._backlog.get(user, ()))
        return sum(len(q) for q in self._backlog.values())

    def inflight_size(self) -> int:
        return len(self._inflight)

    # -- dispatch (the VTC decision) ----------------------------------------
    def take(self) -> List[Request]:
        """Drain queued fetches in lagging-user order into the free
        dispatch slots.  Work-conserving: whenever a slot is free and
        any user has backlog, a fetch IS dispatched — fairness only
        decides *whose*.  Ties break toward fewer in-flight fetches,
        then the heavier tier, then the lexicographically smaller user
        (fully deterministic)."""
        out: List[Request] = []
        while any(self._backlog.values()):
            if self.max_inflight is not None \
                    and len(self._inflight) >= self.max_inflight:
                break
            u = min((u for u, q in self._backlog.items() if q),
                    key=lambda u: (self.counters.get(u, 0.0),
                                   self._inflight_by_user.get(u, 0),
                                   -self.weight_of(u), u))
            req = self._backlog[u].popleft()
            if not self._backlog[u]:
                del self._backlog[u]
            self._inflight[req.rid] = u
            self._inflight_by_user[u] = \
                self._inflight_by_user.get(u, 0) + 1
            self._emit(u, req.rid, "dispatch")
            out.append(req)
        return out

    def _release(self, rid: int) -> Optional[str]:
        u = self._inflight.pop(rid, None)
        if u is not None:
            n = self._inflight_by_user.get(u, 0) - 1
            if n > 0:
                self._inflight_by_user[u] = n
            else:
                self._inflight_by_user.pop(u, None)
        return u

    # -- served-cost charges -------------------------------------------------
    def _charge(self, user: str, cost_units: float) -> None:
        self.counters[user] = (self.counters.get(user, 0.0)
                               + cost_units / self.weight_of(user))

    def on_fetch_done(self, req: Request, nbytes: float) -> None:
        """A fetch delivered: free its slot and charge the wire bytes.
        Idempotent per rid, so the wall-clock fallback (which cannot
        meter bytes and charges 0) never double-counts the virtual
        path's charge."""
        u = self._release(req.rid)
        if u is None:
            return
        self._charge(u, nbytes / self.byte_unit)
        self._emit(u, req.rid, "fetched")

    def on_fetch_abort(self, req: Request, nbytes: float) -> None:
        """Transport abort (``max_attempts`` exhausted): the user still
        consumed the delivered bytes — charge them and free the slot."""
        u = self._release(req.rid)
        if u is None:
            return
        self._charge(u, nbytes / self.byte_unit)
        self._emit(u, req.rid, "abort")

    def on_fetch_miss(self, req: Request) -> None:
        """Storage miss at dispatch: nothing moved on the wire — free
        the slot without charging.  No-op when the rid never reached a
        slot (e.g. an abort already released it)."""
        u = self._release(req.rid)
        if u is None:
            return
        self._emit(u, req.rid, "miss")

    def on_admit(self, req: Request) -> None:
        """Admission to the running batch: charge the *expected* serve
        cost (suffix prefill + weighted output tokens) FairServe-style,
        so the decision log never depends on compute-side timing."""
        if req.rid in self._served:
            return
        self._served[req.rid] = None
        u = self.user_of(req)
        tokens = (max(req.prompt_len - req.reuse_tokens, 0)
                  + self.output_token_weight * req.max_new_tokens)
        self._charge(u, tokens * self.token_unit)
        self._emit(u, req.rid, "serve")

    # -- storage tier priority ----------------------------------------------
    def apply_storage_priority(self, cluster, user: str, key: str,
                               now: float = 0.0) -> bool:
        """Map ``user``'s SLO tier onto the storage tier's levers for
        ``key``: top-tier prefixes are pinned (never evicted, never
        expired — `StoredPrefix.pinned`), any tier above the minimum
        weight gets the admission ask-counter seeded to
        ``admission_min_asks`` so ``second_hit``/``cost`` admission
        grants residency on first touch; bottom-tier keys earn
        residency like everyone else.  Returns True when the key is
        cataloged (i.e. the priority could attach)."""
        entry = cluster.catalog.get(key)
        if entry is None:
            return False
        w = self.weight_of(user)
        if w >= max(self.tiers.values()):
            entry.pinned = True
        if w > min(self.tiers.values()):
            cluster.asks_by_key[key] = max(
                cluster.asks_by_key.get(key, 0),
                cluster.admission_min_asks)
        return True

    # -- prefetch budget shares ---------------------------------------------
    def prefix_user(self, key: Optional[str]) -> Optional[str]:
        """Owner attribution for speculation: the last user whose demand
        named this prefix (None if never demanded)."""
        if key is None:
            return None
        return self._prefix_users.get(key)

    def prefetch_share(self, user: Optional[str]) -> float:
        """``user``'s fraction of the shared mispredict budget: tier
        weight over the total weight of all known users (1.0 while no
        user is known — nothing to split yet)."""
        known = set(self._tier_of) | set(self.counters)
        if user is not None:
            known.add(user)
        if not known:
            return 1.0
        total = sum(self.weight_of(u) for u in known)
        return self.weight_of(user if user is not None
                              else "anon") / total
