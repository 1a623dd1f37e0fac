"""Fetching-aware scheduler (paper §3.3.1, Fig. 15).

A dedicated ``waiting_for_KV`` queue lives outside the engine's own
waiting/running queues. Each scheduling iteration:
  - requests that need remote KV move to waiting_for_KV and their fetch is
    started in the background (the engine never blocks on them);
  - non-reuse requests follow the engine's normal FCFS admission;
  - when a fetch completes (or the layer-wise condition of Appx A.3 allows
    early admission), the request re-enters the admission flow.

``policy="fetch_agnostic"`` reproduces the baseline HOL-blocking behaviour
(fetching requests sit at the head of the single FCFS queue and block
everyone behind them) for the Fig. 9 / Fig. 19 comparisons.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Dict, List, Optional


class ReqState(enum.Enum):
    WAITING = "waiting"
    WAITING_FOR_KV = "waiting_for_kv"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    max_new_tokens: int = 64
    reuse_tokens: int = 0  # prefix tokens whose KV is fetched remotely
    prefix: Optional[str] = None  # manifest key when reuse_tokens > 0
    # Shared-link arbitration weight: under the "fair" policy this fetch
    # receives weight/total_weight of the link; under "drr" it is served
    # proportionally more bytes per round (see network.SharedLink).
    weight: float = 1.0
    # multi-tenant identity: owning user + SLO tier.  With a
    # FairScheduler wired (fairness= on either environment) the tier is
    # mapped to `weight` at arrival and all served cost is charged to
    # `user`'s virtual counter (docs/fairness.md).  None = single-tenant.
    user: Optional[str] = None
    slo_tier: Optional[str] = None

    state: ReqState = ReqState.WAITING
    # storage-tier resolution (set when a StorageCluster serves fetches):
    # "full" | "partial" | "miss"; on a partial hit reuse_tokens is
    # reduced to the resident ancestor's coverage and the original ask is
    # preserved in requested_reuse_tokens (the tail is recomputed).
    storage_hit: Optional[str] = None
    storage_node: Optional[str] = None
    requested_reuse_tokens: Optional[int] = None
    # cataloged key that missed (delayed write-on-miss): the environment
    # calls StorageCluster.notify_recompute_done(storage_miss_key) when
    # this request's fallback prefill reaches its first token.
    storage_miss_key: Optional[str] = None
    # fetch progress
    fetch_dispatched: bool = False  # scheduler handed it to the controller
    fetch_started: Optional[float] = None
    fetch_done: Optional[float] = None
    layers_ready: int = 0
    early_admitted: bool = False
    # serving progress
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    tokens_out: int = 0
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def needs_fetch(self) -> bool:
        return self.reuse_tokens > 0

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        if len(self.token_times) < 2:
            return None
        spans = [b - a for a, b in zip(self.token_times, self.token_times[1:])]
        return sum(spans) / len(spans)


class FetchingAwareScheduler:
    # ``fairness`` (optional) is a cluster.fairness.FairScheduler: it
    # stamps tier weights at arrival, holds queued fetches in a
    # per-user backlog drained in lagging-user order through
    # take_fetches(), and charges served cost on admission /
    # fetch-completion (docs/fairness.md).  None keeps plain FCFS.
    def __init__(self, policy: str = "kvfetcher",
                 max_running: int = 8, fairness=None):
        assert policy in ("kvfetcher", "fetch_agnostic")
        assert fairness is None or policy == "kvfetcher", \
            "fairness= needs the kvfetcher policy (fetch_agnostic IS " \
            "the HOL-blocking FCFS baseline)"
        self.policy = policy
        self.max_running = max_running
        self.fairness = fairness
        self.waiting: Deque[Request] = deque()
        self.waiting_for_kv: Deque[Request] = deque()
        self.running: List[Request] = []
        self.fetch_requests: List[Request] = []  # fetches to start

    # -- intake ----------------------------------------------------------
    def submit(self, req: Request, now: float) -> None:
        req.state = ReqState.WAITING
        if self.fairness is not None:
            self.fairness.on_arrival(req)
        self.waiting.append(req)

    # -- background-fetch notifications -----------------------------------
    def notify_fetch_done(self, req: Request, now: float) -> None:
        req.fetch_done = now
        if self.fairness is not None:
            # wall-clock fallback: no byte meter, charge 0 but free the
            # slot.  The virtual-clock controller charges real wire
            # bytes *before* notifying, making this call a no-op there.
            self.fairness.on_fetch_done(req, 0.0)
        if req.state is ReqState.WAITING_FOR_KV:
            self.waiting_for_kv.remove(req)
            req.state = ReqState.WAITING
            self.waiting.appendleft(req)  # ready: head of admission queue

    def notify_early_admissible(self, req: Request, now: float) -> None:
        """Layer-wise pipeline condition satisfied (Appx A.3)."""
        if req.state is ReqState.WAITING_FOR_KV:
            self.waiting_for_kv.remove(req)
            req.early_admitted = True
            req.state = ReqState.WAITING
            self.waiting.appendleft(req)

    def notify_fetch_miss(self, req: Request, now: float) -> None:
        """Nothing (more) to fetch — the request falls back to a full
        prefill: a storage-tier miss, or a WAN transport abort after
        ``max_attempts`` exhausted.  It re-enters admission immediately
        (there is no fetch to wait for); under ``fetch_agnostic`` it
        simply stops blocking the queue head since ``needs_fetch`` turns
        False.  A transport abort keeps the request's original storage
        resolution (the tier DID hit; the network failed), so
        ``storage_hit``/``requested_reuse_tokens`` are only stamped when
        still unset.

        Resolution of a storage miss is the *delayed write-on-miss*
        hook: the environment watches for this request's first token and
        then calls ``StorageCluster.notify_recompute_done`` with
        ``req.storage_miss_key`` — the recomputed KV exists only from
        that moment, so the storage tier must not re-admit earlier."""
        if self.fairness is not None:
            # free the dispatch slot without charging (nothing moved on
            # the wire; a transport abort charged its partial delivery
            # already and this call is then a no-op)
            self.fairness.on_fetch_miss(req)
        if req.requested_reuse_tokens is None:
            req.requested_reuse_tokens = req.reuse_tokens
        req.reuse_tokens = 0
        if req.storage_hit is None:
            req.storage_hit = "miss"
        if req.state is ReqState.WAITING_FOR_KV:
            self.waiting_for_kv.remove(req)
            req.state = ReqState.WAITING
            self.waiting.appendleft(req)

    def finish(self, req: Request, now: float) -> None:
        req.state = ReqState.FINISHED
        req.t_finished = now
        if req in self.running:
            self.running.remove(req)

    # -- scheduling iteration ---------------------------------------------
    def schedule(self, now: float) -> List[Request]:
        """One iteration: returns requests newly admitted to running.

        Side effect: fills ``self.fetch_requests`` with fetches the caller
        (fetch controller) must start in the background.
        """
        admitted: List[Request] = []
        if self.policy == "kvfetcher":
            # move fetching requests out of the engine's admission path
            still: Deque[Request] = deque()
            for req in self.waiting:
                if req.needs_fetch and not req.fetch_dispatched:
                    req.fetch_dispatched = True
                    req.state = ReqState.WAITING_FOR_KV
                    self.waiting_for_kv.append(req)
                    if self.fairness is not None:
                        self.fairness.enqueue(req)  # fair backlog
                    else:
                        self.fetch_requests.append(req)
                else:
                    still.append(req)
            self.waiting = still
            while self.waiting and len(self.running) < self.max_running:
                req = self.waiting.popleft()
                req.state = ReqState.RUNNING
                req.t_admitted = now
                if self.fairness is not None:
                    self.fairness.on_admit(req)
                self.running.append(req)
                admitted.append(req)
        else:  # fetch_agnostic: single FCFS queue, HOL blocking
            for req in self.waiting:
                if req.needs_fetch and not req.fetch_dispatched:
                    req.fetch_dispatched = True
                    self.fetch_requests.append(req)
            while self.waiting and len(self.running) < self.max_running:
                head = self.waiting[0]
                if head.needs_fetch and head.fetch_done is None:
                    break  # head blocks everyone behind it
                self.waiting.popleft()
                head.state = ReqState.RUNNING
                head.t_admitted = now
                self.running.append(head)
                admitted.append(head)
        return admitted

    def take_fetches(self) -> List[Request]:
        if self.fairness is not None:
            # drain the fair backlog into free dispatch slots in
            # lagging-user order (slots are released on fetch
            # completion / miss / abort, so an abusive flood queues
            # here instead of monopolizing the link)
            self.fetch_requests.extend(self.fairness.take())
        out, self.fetch_requests = self.fetch_requests, []
        return out
