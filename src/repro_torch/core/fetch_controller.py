"""Event-driven asynchronous fetch controller (paper §3.3, Appx A.3).

One pipeline-state machine drives every in-flight :class:`FetchPlan`
through explicit transmit -> decode -> restore stages against a virtual
clock, shared by the live serving engine (`repro_torch.serving.engine`)
and the cluster simulator (`cluster/simulator.py` of the JAX package) so
the two can never diverge.  Per chunk the controller

  * selects the resolution with Alg. 1 (`select_resolution`) — ABR
    style (ISSUE 7): minimum total pipelined time from the flow's live
    bandwidth estimate (the Jacobson/Karels `RttEstimator` service-time
    view once it has samples, rescaled by the flow's current
    `SharedLink.flow_share` and halved per outstanding lost chunk) vs
    the per-resolution decode-table projection at the pool's load.
    When the share structure collapses mid-fetch — a flow joins the
    link, a slow-start ramp epoch re-shares it, or a loss burst is
    confirmed — the controller re-evaluates immediately and
    down-switches the *remaining* chunks, recording a deterministic
    ``resolution_switch`` event ``(rid, chunk_seq, from, to, reason)``
    that replays identically in the simulator and the live engine
    (the decisions are pure functions of wire timings and link state,
    never of wall-clock interleaving),
  * transmits it over the shared link
    (`repro_torch.cluster.network.SharedLink` arbitrates concurrent
    fetches; a bare `BandwidthTrace` is wrapped into a single-flow
    link) — or, with the multi-node storage tier, over the
    *storage node's own* link passed per fetch via ``start(link=...)``,
    so placement changes the observed path — arming a retransmit timer
    at each attempt's submit time: the deadline comes from a per-flow
    Jacobson/Karels SRTT/RTTVAR estimator over observed chunk service
    times (``rto_mode="adaptive"``, ``rto = srtt + 4*rttvar`` clamped to
    ``[min_rto, max_rto]`` with exponential backoff) or from the
    projected wire time plus the fixed ``retransmit_timeout`` grace
    (``rto_mode="fixed"``).  A timer that fires resends the chunk while
    — in pipelined mode — later chunks keep streaming (selective
    repeat); a resend that duplicated a copy which later delivers is a
    *spurious* retransmit: the duplicate is cancelled on the link and
    counted separately from loss-driven retransmits,
  * decodes it on the decode pool (or the CacheGen-style serialized GPU
    decompressor, or instantly for raw transfers), and
  * fires a restore event, at which the environment hook performs the
    actual (or modeled) frame-wise restoration.

After every restore the controller re-evaluates the Appx A.3 layer-wise
condition and, when satisfied, calls
``scheduler.notify_early_admissible`` so suffix prefill can start while
later layer groups are still in flight.  A fetch with any retransmit
outstanding is never admitted early: the lost chunk's layer group is not
actually buffered, so admitting would stall compute.  The per-layer
delivery estimate is the Appx A.3 per-resolution projection from the
live bandwidth estimate and the profiled decode table (loss-rate
inflation applies only when the flow's link actually carries a
`LossModel`), so admission stays tight under ramp/loss jitter instead
of chasing a lagging mean of observed chunk latencies.

A chunk that exhausts ``max_attempts`` with every copy lost does not
stall its request forever: the fetch is aborted and routed through
``scheduler.notify_fetch_miss`` so the request falls back to a full
prefill (for an already-early-admitted request the cap is instead
lifted — the engine is attending over restored prefix KV and a fallback
is no longer possible).

Environment differences (real codec work vs. analytic cost models, real
blob sizes vs. ratio-derived sizes) live behind :class:`FetchHooks`; the
stage ordering, pipelining, retransmission, and admission logic are
written once here — both `_SimHooks` and `_EngineHooks` pump this same
retry/fair-share state machine (the "no second pipeline" rule).

See ``docs/fetch_pipeline.md`` for the full state machine and timeline.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.adaptive import (BandwidthEstimator, DecodeTable,
                                 select_resolution)
from repro_torch.core.fetch import FetchPlan, PlannedChunk
from repro_torch.core.layout import RESOLUTION_ORDER
from repro_torch.core.pipelining import non_blocking_ok
from repro_torch.core.scheduler import ReqState, Request
from repro_torch.cluster.network import RttEstimator, make_link


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Method-level switches of the fetch pipeline."""
    adaptive: bool = True  # Alg. 1 per-chunk resolution selection
    fixed_resolution: str = "1080p"
    # Overlap transmit/decode/restore of successive chunks.  False models
    # the synchronous baseline: chunk i+1 is not requested until chunk i
    # is fully restored (the pre-pipelining live-engine behaviour).
    pipelined: bool = True
    layerwise_admission: bool = True  # Appx A.3 early admission
    blocking_fetch: bool = False  # LMCache: one bulk transfer, no overlap
    gpu_decomp_tokens_per_s: float = 0.0  # CacheGen CUDA decompression
    use_table_sizes: bool = False  # Appx A.2 table sizes, not real bytes
    resolutions: Tuple[str, ...] = RESOLUTION_ORDER
    # WAN retransmission: every transmission attempt arms a retransmit
    # timer at its submit time — a real sender only learns about loss
    # from a missing ack, so the old model's drop detection at the
    # actual wire-completion instant (an oracle no transport has) is
    # gone.  rto_mode="adaptive" (default) derives the deadline from
    # the per-flow Jacobson/Karels estimator — rto = srtt + 4*rttvar
    # over observed chunk service times, clamped to [min_rto, max_rto],
    # doubled on consecutive fires for the same chunk; "fixed" keeps a
    # constant retransmit_timeout grace beyond the projected wire time
    # (the non-adaptive baseline the ttft.wan.adaptive.* bench rows
    # compare against).
    rto_mode: str = "adaptive"
    # RACK-style fast retransmit (RFC 8985 in spirit): the delivery of a
    # later-sent chunk reveals the sequence gap left by an earlier chunk
    # whose every copy is known lost, so the sender resends immediately
    # instead of waiting out the full RTO.  It only acts on
    # confirmed-loss state (no copy in flight), so it can never fire a
    # spurious duplicate; the timer stays as the last resort for tail
    # losses with no later delivery to ack past them.  Applies to both
    # rto modes — it is a recovery mechanism, not a deadline policy.
    fast_retransmit: bool = True
    # fixed-mode grace beyond the projected wire time; also pads the
    # adaptive pre-sample seed (3x projected service + this grace).
    retransmit_timeout: float = 0.05
    min_rto: float = 0.02
    max_rto: float = 10.0
    # Hard cap of transmission attempts per chunk.  A chunk that
    # exhausts it with every copy lost aborts the fetch and falls back
    # to full prefill via notify_fetch_miss (no eternal stall).
    max_attempts: int = 64
    # Explicit ACK/NACK propagation delay in the retransmit race: a real
    # sender cannot observe a missing ack before the ack itself would
    # have crossed the reverse path, so every retransmit timer arms at
    # submit + rto + ack_delay.  The default 0 keeps every existing
    # trace byte-identical.
    ack_delay: float = 0.0


class FetchHooks:
    """Environment-specific callbacks; defaults fit real-manifest plans."""

    def chunk_bytes(self, fetch: "ActiveFetch", pc: PlannedChunk,
                    res: str) -> float:
        return float(pc.sizes[res])

    def restore_seconds(self, fetch: "ActiveFetch",
                        pc: PlannedChunk) -> float:
        return 0.0

    def gpu_decomp_seconds(self, fetch: "ActiveFetch",
                           pc: PlannedChunk) -> float:
        return 0.0

    def buffer_bytes(self, fetch: "ActiveFetch",
                     pc: PlannedChunk) -> float:
        """Peak decompress-buffer bytes while restoring this chunk."""
        return 0.0

    def bulk_buffer_bytes(self, fetch: "ActiveFetch") -> float:
        """Peak buffer for the blocking (non-pipelined bulk) path."""
        return 0.0

    def on_restored(self, fetch: "ActiveFetch", pc: PlannedChunk,
                    now: float) -> None:
        """Perform the actual restoration work (live engine) — or nothing
        (simulator, where restoration is purely a timing event)."""

    def comp_times(self, req: Request) -> Optional[Sequence[float]]:
        """Per-layer prefill compute times for the Appx A.3 condition.
        Returning None disables early admission for this request."""
        return None


@dataclasses.dataclass
class _ChunkTx:
    """Transmit-side bookkeeping for one chunk under the send-time
    retransmit-timer model (ISSUE 5)."""
    # attempt number -> SharedLink handle of the copy on the wire
    in_flight: Dict[int, object] = dataclasses.field(default_factory=dict)
    # resend attempt -> the in-flight copies it duplicated at fire time;
    # classified spurious when one of them delivers, genuine (a real
    # retransmit) once every one of them is lost.
    pending_dups: Dict[int, Set[int]] = dataclasses.field(
        default_factory=dict)
    timer_attempt: int = 0  # attempt the armed retransmit timer covers
    fires: int = 0  # consecutive timer fires (backoff exponent)
    last_submit: float = 0.0  # submit time of the newest attempt


@dataclasses.dataclass
class ActiveFetch:
    """Controller-side state of one in-flight fetch."""
    req: Request
    plan: FetchPlan
    est: BandwidthEstimator
    trans_free_at: float
    # the SharedLink this fetch transmits over: the controller's default
    # link, or — multi-node storage tier — the storage node's own link,
    # so placement decisions change the observed network path.
    link: Optional[object] = None
    active_res: Optional[str] = None
    # resolutions actually resident at the serving storage node (None =
    # unrestricted): with per-resolution eviction a node may hold only
    # part of the encoded ladder, and the ABR selection must not pick a
    # rung that was evicted (`StorageHit.resolutions`)
    avail_res: Optional[Tuple[str, ...]] = None
    # storage key this fetch serves (for the per-resolution usage sink)
    served_key: Optional[str] = None
    # link share fraction at the last goodput sample: selection rescales
    # the estimate by share_now/est_share when the structure moves
    est_share: float = 1.0
    # deterministic ABR event log: (rid, chunk_seq, from, to, reason)
    resolution_switches: List[Tuple[int, int, str, str, str]] = \
        dataclasses.field(default_factory=list)
    gpu_decomp_until: float = 0.0
    chunk_latencies: List[float] = dataclasses.field(default_factory=list)
    pending_retx: Set[int] = dataclasses.field(default_factory=set)
    retransmits: int = 0  # loss-driven (genuine) resends so far
    spurious_retransmits: int = 0  # resends of copies that delivered
    est_samples: int = 0  # goodput samples folded into ``est`` so far
    # per-flow Jacobson/Karels service-time estimator driving the RTO
    rtt: RttEstimator = dataclasses.field(default_factory=RttEstimator)
    tx: Dict[int, _ChunkTx] = dataclasses.field(default_factory=dict)


class FetchController:
    """Event-driven pipeline over all in-flight fetches.

    ``bandwidth`` is a `repro_torch.cluster.network.SharedLink` (multi-flow
    arbitration + optional `LossModel`) or anything providing ``bw_at(t)``
    and ``transmit(nbytes, t0)`` — e.g. a bare ``BandwidthTrace``, which
    is wrapped into a single-flow link.  ``pool`` (optional) must provide
    ``decode(res, t_ready, size_scale)`` and ``load_at(t)`` (see
    `repro_torch.cluster.decodepool.DecodePool`).
    """

    def __init__(self, sched, bandwidth, *,
                 table: Optional[DecodeTable] = None,
                 pool=None,
                 config: Optional[PipelineConfig] = None,
                 hooks: Optional[FetchHooks] = None,
                 prefetcher=None):
        self.sched = sched
        self.link = make_link(bandwidth)
        self.link.bind(self._push)
        self.bw = self.link  # link-rate view for estimator seeding
        if table is None and pool is not None:
            table = pool.table  # decode scaling needs the pool's profile
        self.table = table
        self.pool = pool
        self.config = config or PipelineConfig()
        self.hooks = hooks or FetchHooks()
        # speculative prefetch (repro_torch.cluster.staging.
        # PrefetchManager): demand fetches starting on a link cancel
        # speculation riding it
        self.prefetcher = prefetcher
        # per-node smoothed-RTT sink (StorageCluster.observe_rtt): each
        # completed fetch reports its flow's RTT estimate keyed by the
        # serving storage node, driving RTT-aware replica selection
        self.rtt_sink: Optional[Callable[[str, float], None]] = None
        # per-resolution usage sink (StorageCluster.note_resolution_use):
        # each completed fetch reports which encoded resolutions it
        # actually pulled, keyed by (node, key) — cost-aware eviction
        # uses the counts to keep hot resolutions and shed cold ones
        self.res_sink: Optional[Callable[[str, str, str], None]] = None
        self.active: Dict[int, ActiveFetch] = {}
        self.now = 0.0
        self.buffer_high_water = 0.0
        self.retransmits_total = 0  # across all fetches (WAN stats)
        self.spurious_retransmits_total = 0  # duplicates of live copies
        # global ABR event log across fetches, in decision order:
        # (rid, chunk_seq, from_res, to_res, reason) — reasons are
        # "estimate" (chunk-boundary re-selection), "flow_join" /
        # "ramp_epoch" (link share collapse), "loss" (confirmed drop).
        # Deterministic given the access sequence: cross-env replay
        # tests assert simulator == live engine on this log.
        self.resolution_switches: List[Tuple[int, int, str, str, str]] = []
        self._events: List[Tuple[float, int, Callable[[float], None]]] = []
        self._eid = 0
        self.link.on_share_change(self._on_share_change)

    # -- event queue --------------------------------------------------------
    def _push(self, t: float, fn: Callable[[float], None]) -> None:
        self._eid += 1
        heapq.heappush(self._events, (t, self._eid, fn))

    def push_event(self, t: float, fn: Callable[[float], None]) -> None:
        """Public event-queue handle for external producers sharing this
        controller's virtual clock — the storage tier binds it
        (`StorageCluster.bind`) so ``heal="link"`` re-replication
        transfers complete through the same ``pump()`` the fetch
        pipeline runs on, and heal flows contend with live fetches on
        the nodes' `SharedLink`\\ s."""
        self._push(t, fn)

    def pump(self, until: float) -> None:
        """Process every pipeline event with timestamp <= ``until``."""
        while self._events and self._events[0][0] <= until:
            t, _, fn = heapq.heappop(self._events)
            self.now = max(self.now, t)
            fn(t)

    def pump_next(self) -> Optional[float]:
        """Process the single next event; returns its time (None if idle)."""
        if not self._events:
            return None
        t, _, fn = heapq.heappop(self._events)
        self.now = max(self.now, t)
        fn(t)
        return t

    def next_event_time(self) -> Optional[float]:
        return self._events[0][0] if self._events else None

    def drain(self, plan: FetchPlan) -> float:
        """Run this plan's pipeline to completion (the ``sync`` mode);
        returns the completion time on the virtual clock.  An aborted
        plan (``max_attempts`` exhausted, fetch fell back to prefill)
        drains to the abort instant instead of spinning forever."""
        t = self.now
        while not (plan.done or plan.aborted):
            nt = self.pump_next()
            if nt is None:
                raise RuntimeError(
                    f"fetch pipeline stalled for rid={plan.rid}")
            t = nt
        return t

    @property
    def busy(self) -> bool:
        return bool(self._events or self.active)

    # -- fetch lifecycle ----------------------------------------------------
    def start(self, req: Request, plan: FetchPlan, now: float, *,
              link=None, resolutions: Optional[Sequence[str]] = None,
              served_key: Optional[str] = None) -> ActiveFetch:
        """Begin fetching ``plan``.  ``link`` (optional) routes this fetch
        over a specific `SharedLink` — e.g. the storage node holding the
        prefix — instead of the controller's default link; per-fetch links
        share this controller's event queue.  ``resolutions`` (optional)
        restricts the ABR selection to the encodings actually resident at
        the serving node (per-resolution eviction may have shed part of
        the ladder); ``served_key`` names the stored prefix for the
        per-resolution usage sink."""
        req.fetch_started = now
        lnk = self.link if link is None else make_link(link)
        lnk.bind(self._push)
        lnk.on_share_change(self._on_share_change)
        if self.prefetcher is not None:
            # demand traffic needs this link: in-flight speculation on
            # it is cancelled before the flow opens (host-tier fetches
            # cancel nothing — they ride the staging link)
            self.prefetcher.demand_started(req, lnk, now)
        f = ActiveFetch(req, plan, BandwidthEstimator(lnk.bw_at(now)),
                        trans_free_at=now, link=lnk,
                        avail_res=(tuple(resolutions)
                                   if resolutions else None),
                        served_key=served_key)
        self.active[req.rid] = f
        lnk.open_flow(req.rid, weight=getattr(req, "weight", 1.0), t=now)
        if self.config.blocking_fetch:
            self._start_blocking(f, now)
        else:
            self._send_next(f, now)
        return f

    def _start_blocking(self, f: ActiveFetch, now: float) -> None:
        """LMCache-style inference-blocking fetch: one bulk transfer of
        every chunk, bulk decode, chunk-wise restoration buffer.  The bulk
        stream monopolizes the link (no per-chunk arbitration); WAN loss
        becomes a goodput haircut of ``1 / (1 - mean_loss_rate)`` since a
        byte-stream transfer retransmits inline."""
        res = self.config.fixed_resolution
        total = 0.0
        for pc in f.plan.chunks:
            pc.resolution = res
            pc.t_transmit_start = now
            total += self._chunk_bytes(f, pc, res)
        total = self._loss_inflate(f.link, total)
        t_done = f.link.transmit(total, now)
        if self.pool is not None:
            _, t_done = self.pool.decode(res, t_done,
                                         size_scale=len(f.plan.chunks))
        self.buffer_high_water = max(self.buffer_high_water,
                                     self.hooks.bulk_buffer_bytes(f))

        def on_bulk_done(t: float, f=f) -> None:
            for pc in f.plan.chunks:
                pc.t_transmit_done = pc.t_decode_done = pc.t_restored = t
                self.hooks.on_restored(f, pc, t)
            self._finish(f, t)

        self._push(t_done, on_bulk_done)

    # -- per-chunk pipeline -------------------------------------------------
    @staticmethod
    def _loss_inflate(link, estimate: float) -> float:
        """Inflate a transfer-time/byte estimate by the expected
        retransmission rate of the flow's OWN link.  A lossless (e.g.
        storage-node) link pays no haircut even when other links carry a
        LossModel, and a zero-rate model (scripted) is a no-op."""
        loss = link.loss if link is not None else None
        if loss is not None:
            rate = loss.mean_loss_rate()
            if rate > 0:
                return estimate / max(1.0 - rate, 1e-3)
        return estimate

    def _decode_size_scale(self, nbytes: float, res: str) -> float:
        """Decode cost scales with actual bytes relative to the decode
        table's reference chunk (floored: tiny chunks still pay setup)."""
        return max(nbytes / (self.table.chunk_size_mb[res] * 1e6), 0.05)

    def _chunk_bytes(self, f: ActiveFetch, pc: PlannedChunk,
                     res: str) -> float:
        if self.config.use_table_sizes and self.table is not None \
                and res in self.table.chunk_size_mb:
            return self.table.chunk_size_mb[res] * 1e6
        return self.hooks.chunk_bytes(f, pc, res)

    def _available_res(self, f: Optional[ActiveFetch],
                       pc: PlannedChunk) -> Tuple[str, ...]:
        if pc.sizes:
            base = tuple(r for r in self.config.resolutions
                         if r in pc.sizes)
        else:
            base = self.config.resolutions
        if f is not None and f.avail_res:
            # resolutions evicted at the serving node are not fetchable
            restricted = tuple(r for r in base if r in f.avail_res)
            if restricted:
                return restricted
        return base

    def _sel_bw(self, f: ActiveFetch, now: float) -> float:
        """Bandwidth estimate feeding the ABR selection (bytes/sec):
        the flow's achieved rate — the Jacobson/Karels `RttEstimator`
        smoothed service time over the active resolution's chunk bytes
        once it has samples (Karn-filtered, so retransmission ambiguity
        never pollutes it), the raw goodput estimator before that —
        rescaled by how the flow's link share has moved since the last
        sample (``flow_share(now) / est_share``: a flow join or ramp
        epoch is visible *immediately*, not one smoothed sample later),
        and halved per outstanding lost chunk (multiplicative decrease
        while a loss burst is in progress).  Every input is wire-side
        state, so the resulting switch decisions are deterministic
        across environments with matching wire timings."""
        rate = f.est.est
        if f.rtt.srtt is not None and f.active_res is not None:
            plan = f.plan
            pc = plan.chunks[min(plan.next_to_send, len(plan.chunks) - 1)]
            if not pc.sizes or f.active_res in pc.sizes:
                rate = (self._chunk_bytes(f, pc, f.active_res)
                        / max(f.rtt.srtt, 1e-9))
        if hasattr(f.link, "flow_share"):
            rate *= (f.link.flow_share(f.req.rid)
                     / max(f.est_share, 1e-9))
        rate /= 2.0 ** min(len(f.pending_retx), 8)
        return max(rate, 1.0)

    def _select(self, f: ActiveFetch, pc: PlannedChunk,
                now: float) -> str:
        """One ABR selection (Alg. 1, minimum total pipelined time) for
        ``pc`` from the live share-adjusted bandwidth estimate and the
        decode pool's current load."""
        avail = self._available_res(f, pc)
        sizes = (None if self.config.use_table_sizes else
                 {r: int(self._chunk_bytes(f, pc, r)) for r in avail})
        load = self.pool.load_at(now) if self.pool else 0
        res, _ = select_resolution(self._sel_bw(f, now), load, self.table,
                                   sizes_bytes=sizes,
                                   active_resolution=f.active_res,
                                   resolutions=avail)
        return res

    def _choose_resolution(self, f: ActiveFetch, pc: PlannedChunk,
                           now: float) -> str:
        avail = self._available_res(f, pc)
        if not self.config.adaptive or self.table is None:
            res = self.config.fixed_resolution
            if not avail or res in avail:
                return res
            # fixed resolution not encoded for this chunk: nearest
            # available, preferring the next one below
            want = RESOLUTION_ORDER.index(res)
            lower = [r for r in avail
                     if RESOLUTION_ORDER.index(r) <= want]
            return lower[-1] if lower else avail[0]
        return self._select(f, pc, now)

    def _record_switch(self, f: ActiveFetch, seq: int, old: str,
                       new: str, reason: str) -> None:
        evt = (f.req.rid, seq, old, new, reason)
        f.resolution_switches.append(evt)
        self.resolution_switches.append(evt)

    def _on_share_change(self, t: float, reason: str) -> None:
        """A subscribed link's share structure moved (flow join / leave,
        slow-start ramp epoch): re-evaluate every active adaptive fetch
        so the *remaining* chunks down-switch at the collapse instant
        instead of a chunk boundary later.  Fetches on an unrelated
        link see an unchanged ``flow_share`` and re-select identically
        (no event); a leave only grows the survivors' shares, so no
        down-switch can be missed by skipping it."""
        if reason == "flow_leave":
            return
        for f in list(self.active.values()):
            self._reconsider(f, t, reason)

    def _reconsider(self, f: ActiveFetch, now: float,
                    reason: str) -> None:
        """Re-run the ABR selection for the remaining chunks of one
        active fetch at a share-collapse signal.  Only *down*-switches
        apply mid-fetch — the collapse evidence is structural (join /
        ramp re-share / confirmed loss), while an upgrade safely waits
        for the next chunk boundary's own selection — and an applied
        switch is recorded as a deterministic ``resolution_switch``
        event against the first not-yet-sent chunk."""
        if (not self.config.adaptive or self.table is None
                or f.active_res is None):
            return
        plan = f.plan
        if plan.aborted or plan.next_to_send >= len(plan.chunks):
            return
        res = self._select(f, plan.chunks[plan.next_to_send], now)
        if res == f.active_res:
            return
        order = RESOLUTION_ORDER
        if (res in order and f.active_res in order
                and order.index(res) >= order.index(f.active_res)):
            return  # an up-switch: leave it to the next chunk boundary
        self._record_switch(f, plan.next_to_send, f.active_res, res,
                            reason)
        f.active_res = res

    def _send_next(self, f: ActiveFetch, now: float) -> None:
        plan = f.plan
        if plan.aborted or plan.next_to_send >= len(plan.chunks):
            return
        seq = plan.next_to_send
        pc = plan.chunks[seq]
        plan.next_to_send += 1
        res = self._choose_resolution(f, pc, now)
        if f.active_res is not None and res != f.active_res:
            self._record_switch(f, seq, f.active_res, res, "estimate")
        pc.resolution = res
        f.active_res = res
        self._transmit(f, pc, seq, attempt=1, now=now)

    def _transmit(self, f: ActiveFetch, pc: PlannedChunk, seq: int,
                  attempt: int, now: float) -> None:
        """Submit one transmission attempt of chunk ``seq`` to the link
        and arm its retransmit timer at the submit time (the sender's
        view: the clock starts when the chunk leaves, not when its bytes
        happen to land).  Retransmissions resend the same resolution (the
        blob already chosen); ``pc.t_transmit_start`` keeps the *first*
        attempt's start so latency stats include the full loss penalty."""
        nbytes = self._chunk_bytes(f, pc, pc.resolution)
        t_start = max(now, f.trans_free_at)
        pc.attempts = max(pc.attempts, attempt)
        if attempt == 1:
            pc.t_transmit_start = t_start
        st = f.tx.setdefault(seq, _ChunkTx())
        handle = f.link.submit(
            f.req.rid, nbytes, t_start,
            lambda t, f=f, pc=pc, seq=seq, attempt=attempt, nbytes=nbytes,
            t_start=t_start: self._on_wire(f, pc, seq, attempt, nbytes,
                                           t_start, t))
        st.in_flight[attempt] = handle
        st.timer_attempt = attempt
        st.last_submit = t_start
        deadline = (t_start + self._rto(f, nbytes, st.fires)
                    + self.config.ack_delay)
        self._push(deadline,
                   lambda t, f=f, pc=pc, seq=seq, attempt=attempt:
                   self._on_timeout(f, pc, seq, attempt, t))

    def _rto(self, f: ActiveFetch, nbytes: float, fires: int) -> float:
        """Retransmit deadline offset for the next attempt of a chunk of
        ``nbytes`` bytes, after ``fires`` consecutive timer fires (each
        fire doubles the deadline — classic exponential backoff).  For
        the flow's *tail* chunk — nothing left unsent, so no later
        delivery will ever reveal its loss to ``_fast_retransmit`` — the
        adaptive deadline tightens to a TLP-style probe (~2x srtt beyond
        the projected service time, RFC 8985): a tail loss otherwise
        idles for the full jitter-padded RTO at the worst possible
        moment, right before the fetch completes."""
        cfg = self.config
        expected = nbytes / max(f.est.est, 1.0)  # projected service time
        if f.est_samples == 0:
            # cold start: the estimator still holds the raw trace rate,
            # but the sender at least knows how many flows its own link
            # carries and its own slow-start window — project the
            # (ramp-scaled) fair share, not the full pipe
            expected *= max(getattr(f.link, "n_flows", 1), 1)
            if hasattr(f.link, "ramp_factor"):
                expected /= max(f.link.ramp_factor(f.req.rid), 1e-3)
        if cfg.rto_mode == "adaptive":
            base = f.rtt.rto(cfg.min_rto, cfg.max_rto)
            if base is None:
                # no service-time sample yet: seed conservatively, like
                # TCP's large initial RTO (3x the projected wire time)
                base = 3.0 * expected + cfg.retransmit_timeout
            elif (cfg.fast_retransmit and f.rtt.srtt is not None
                    and f.plan.next_to_send >= len(f.plan.chunks)):
                base = min(base, max(expected, f.rtt.srtt)
                           + 2.0 * f.rtt.srtt)  # tail loss probe
        else:
            base = expected + cfg.retransmit_timeout
        # never cap below the base: a deadline ahead of the *projected*
        # completion would guarantee a duplicate storm
        return min(base * (2.0 ** fires), max(cfg.max_rto, base))

    def _self_in_flight(self, f: ActiveFetch) -> int:
        """Transmission attempts of this flow currently on the wire."""
        return sum(len(st.in_flight) for st in f.tx.values())

    def _on_timeout(self, f: ActiveFetch, pc: PlannedChunk, seq: int,
                    attempt: int, now: float) -> None:
        """Retransmit timer fired for ``attempt`` of chunk ``seq``.  If
        the chunk already landed (or the fetch ended) the timer is stale.
        Otherwise resend — classifying the resend as a genuine retransmit
        when every prior copy is known lost, or keeping it *provisional*
        while copies are still in flight (resolved at their delivery /
        loss: see ``_on_wire``)."""
        st = f.tx.get(seq)
        if (st is None or pc.t_transmit_done is not None
                or f.req.rid not in self.active):
            return  # chunk landed or fetch finished: stale timer
        if attempt != st.timer_attempt:
            return  # superseded by a newer attempt's timer
        if attempt in st.in_flight and self._self_in_flight(f) > 1:
            # The sender can account for its own multiplexing: another
            # of this flow's transfers shares the wire with this one, so
            # the missing ack is self-explained — defer rather than fire
            # a duplicate.  (Cross-flow contention stays invisible, as
            # for a real transport, and genuinely fires spuriously.)
            nbytes = self._chunk_bytes(f, pc, pc.resolution)
            self._push(now + self._rto(f, nbytes, st.fires)
                       + self.config.ack_delay,
                       lambda t, f=f, pc=pc, seq=seq, attempt=attempt:
                       self._on_timeout(f, pc, seq, attempt, t))
            return
        nxt = pc.attempts + 1
        if nxt > self.config.max_attempts:
            if not f.req.early_admitted:
                # not yet admitted (waiting_for_kv, or parked in the
                # fetch_agnostic FCFS queue): a full-prefill fallback is
                # still possible
                if not st.in_flight:
                    self._abort(f, now)  # every copy lost: fall back
                return  # copies still on the wire may yet land
            # early-admitted request: the engine is already attending
            # over restored prefix KV, a fallback prefill is no longer
            # possible — lift the cap and keep retrying instead
        st.fires += 1
        dup_of = set(st.in_flight)
        if dup_of:
            st.pending_dups[nxt] = dup_of  # classified at resolution
        else:
            f.retransmits += 1  # every prior copy known lost: genuine
            self.retransmits_total += 1
        f.pending_retx.add(seq)
        self._transmit(f, pc, seq, nxt, now)

    def _on_wire(self, f: ActiveFetch, pc: PlannedChunk, seq: int,
                 attempt: int, nbytes: float, t_start: float,
                 now: float) -> None:
        """Wire transfer of one attempt finished: either the chunk landed
        (advance to decode; superseded duplicates are cancelled and any
        provisional resends counted spurious) or the loss model dropped
        it (provisional resends that only duplicated lost copies become
        genuine retransmits).  Pipelined mode streams the next chunk
        either way — selective repeat keeps the pipe busy during loss
        recovery."""
        st = f.tx.setdefault(seq, _ChunkTx())
        st.in_flight.pop(attempt, None)
        if self.config.pipelined and attempt == 1:
            self._send_next(f, now)
        if pc.t_transmit_done is not None:
            return  # a duplicate of an already-landed chunk
        loss = f.link.loss
        if loss is not None and loss.dropped(f.req.rid, seq, attempt, now):
            f.pending_retx.add(seq)
            genuine = 0
            for r, dup in list(st.pending_dups.items()):
                dup.discard(attempt)
                if not dup:  # duplicated copies all lost: was necessary
                    genuine += 1
                    del st.pending_dups[r]
            f.retransmits += genuine
            self.retransmits_total += genuine
            # a confirmed drop is a share-collapse signal: down-switch
            # the remaining chunks now (the goodput estimator only sees
            # the burst when the retransmitted chunk finally lands)
            self._reconsider(f, now, "loss")
            self._maybe_dead(f, pc, seq, st, now)
            return
        # landed: the first delivered copy wins
        if attempt == 1:
            # Karn's algorithm: only unambiguous (first-attempt) service
            # times feed the RTO estimator
            f.rtt.observe(now - t_start)
        for handle in st.in_flight.values():
            f.link.cancel(handle, now)  # cancel superseded duplicates
        st.in_flight.clear()
        for r in list(st.pending_dups):
            if r == attempt:  # the resend itself delivered first
                f.retransmits += 1
                self.retransmits_total += 1
            else:  # duplicated a copy that delivered: wasted bytes
                f.spurious_retransmits += 1
                self.spurious_retransmits_total += 1
        st.pending_dups.clear()
        f.pending_retx.discard(seq)
        # goodput sample over the full chunk history (first attempt start
        # -> landing), so the estimate degrades under loss/contention
        f.est.observe(int(nbytes), now - pc.t_transmit_start)
        f.est_samples += 1
        if hasattr(f.link, "flow_share"):
            # the sample embodies the share the flow held while this
            # chunk was on the wire; selection rescales by the ratio of
            # the *current* share to this one (see _sel_bw)
            f.est_share = f.link.flow_share(f.req.rid)
        if self.config.fast_retransmit:
            self._fast_retransmit(f, t_start, now)
        self._on_transmitted(f, pc, nbytes, pc.t_transmit_start, now)

    def _fast_retransmit(self, f: ActiveFetch, acked_submit: float,
                         now: float) -> None:
        """RACK-style loss recovery: this delivery acks a chunk submitted
        at ``acked_submit``, so any earlier-submitted chunk whose every
        copy is already known lost has a confirmed sequence gap — resend
        it now instead of waiting for its (possibly backed-off) RTO
        timer.  Only fires on confirmed-loss state (``in_flight`` empty),
        so the resend is always a genuine retransmit, never spurious."""
        for seq in sorted(f.pending_retx):
            st = f.tx.get(seq)
            pc = f.plan.chunks[seq]
            if (st is None or st.in_flight
                    or pc.t_transmit_done is not None
                    or st.last_submit >= acked_submit):
                continue
            nxt = pc.attempts + 1
            if (nxt > self.config.max_attempts
                    and not f.req.early_admitted):
                continue  # cap exhausted: the abort path owns this chunk
            # the delivery is fresh evidence the path is alive: the
            # resend's timer restarts from the un-backed-off RTO
            st.fires = 0
            f.retransmits += 1
            self.retransmits_total += 1
            self._transmit(f, pc, seq, nxt, now)

    def _maybe_dead(self, f: ActiveFetch, pc: PlannedChunk, seq: int,
                    st: _ChunkTx, now: float) -> None:
        """Abort the fetch when a chunk has exhausted ``max_attempts``
        with no copy left on the wire (nothing can deliver it anymore)."""
        if (pc.t_transmit_done is None and not st.in_flight
                and pc.attempts >= self.config.max_attempts
                and not f.req.early_admitted
                and f.req.rid in self.active):
            self._abort(f, now)

    def _abort(self, f: ActiveFetch, now: float) -> None:
        """``max_attempts`` exhausted with every copy lost: abandon the
        fetch and route the request through ``notify_fetch_miss`` so it
        falls back to a full prefill instead of hanging in
        ``waiting_for_kv`` forever."""
        f.plan.aborted = True
        for st in f.tx.values():
            for handle in st.in_flight.values():
                f.link.cancel(handle, now)
            st.in_flight.clear()
            st.pending_dups.clear()
        self.active.pop(f.req.rid, None)
        f.link.close_flow(f.req.rid, now)
        fair = getattr(self.sched, "fairness", None)
        if fair is not None:
            # the tenant still consumed every byte that DID deliver
            fair.on_fetch_abort(f.req, sum(
                self._chunk_bytes(f, pc, pc.resolution
                                  or self.config.fixed_resolution)
                for pc in f.plan.chunks
                if pc.t_transmit_done is not None))
        self.sched.notify_fetch_miss(f.req, now)

    def _on_transmitted(self, f: ActiveFetch, pc: PlannedChunk,
                        nbytes: float, t_start: float, now: float) -> None:
        pc.t_transmit_done = now
        if self.pool is not None:
            _, t_dec = self.pool.decode(
                pc.resolution, now,
                size_scale=self._decode_size_scale(nbytes, pc.resolution))
        elif self.config.gpu_decomp_tokens_per_s:
            dur = self.hooks.gpu_decomp_seconds(f, pc)
            t_dec = max(now, f.gpu_decomp_until) + dur
            f.gpu_decomp_until = t_dec
        else:
            t_dec = now  # raw transfer: nothing to decode
        pc.t_decode_done = t_dec
        self.buffer_high_water = max(self.buffer_high_water,
                                     self.hooks.buffer_bytes(f, pc))
        t_done = t_dec + self.hooks.restore_seconds(f, pc)
        f.chunk_latencies.append(t_done - t_start)
        self._push(t_done, lambda t, f=f, pc=pc: self._on_restored(f, pc, t))

    def _on_restored(self, f: ActiveFetch, pc: PlannedChunk,
                     now: float) -> None:
        pc.t_restored = now
        self.hooks.on_restored(f, pc, now)
        req = f.req
        req.layers_ready = f.plan.layers_ready()
        if not self.config.pipelined:
            self._send_next(f, now)  # serialized: request the next chunk
        if f.plan.done:
            self._finish(f, now)
            return
        if (self.config.layerwise_admission and not req.early_admitted
                and req.state is ReqState.WAITING_FOR_KV):
            self._maybe_admit_early(f, now)

    def _finish(self, f: ActiveFetch, now: float) -> None:
        f.req.layers_ready = f.plan.layers_ready()
        self.active.pop(f.req.rid, None)
        f.link.close_flow(f.req.rid, now)
        if self.rtt_sink is not None and f.rtt.srtt is not None \
                and f.req.storage_node:
            self.rtt_sink(f.req.storage_node, f.rtt.srtt)
        if self.res_sink is not None and f.served_key:
            # report which encoded rungs this fetch actually used, in
            # ladder order (deterministic): cost-aware per-resolution
            # eviction keeps hot rungs and sheds cold ones
            used = {pc.resolution for pc in f.plan.chunks
                    if pc.resolution}
            for r in sorted(used, key=lambda r: (
                    RESOLUTION_ORDER.index(r)
                    if r in RESOLUTION_ORDER else -1)):
                self.res_sink(f.req.storage_node or "", f.served_key, r)
        fair = getattr(self.sched, "fairness", None)
        if fair is not None:
            # charge the tenant's virtual counter with the fetch's wire
            # bytes BEFORE notifying (the scheduler's own fallback then
            # sees the slot already released and is a no-op); chunk
            # bytes are a pure function of token counts / table sizes,
            # so both environments charge identically
            fair.on_fetch_done(f.req, sum(
                self._chunk_bytes(f, pc, pc.resolution
                                  or self.config.fixed_resolution)
                for pc in f.plan.chunks))
        self.sched.notify_fetch_done(f.req, now)

    # -- Appx A.3 layer-wise early admission --------------------------------
    def _projected_chunk_interval(self, f: ActiveFetch,
                                  now: float) -> float:
        """Appx A.3 per-resolution projection of the steady-state chunk
        delivery interval: transmit time from the live bandwidth estimate
        (inflated by the expected retransmission rate only when THIS
        flow's link carries a `LossModel`) and decode time from the
        profiled decode table at the pool's current load.  Replaces the
        mean of recent observed chunk latencies, which lags badly under
        the jitter a slow-start ramp or bursty loss introduces.  Without
        a decode table the observed-latency fallback remains."""
        if self.table is None:
            return (float(np.mean(f.chunk_latencies[-4:]))
                    if f.chunk_latencies else 1.0)
        plan = f.plan
        pc = plan.chunks[min(plan.next_to_send, len(plan.chunks) - 1)]
        res = pc.resolution or f.active_res or self.config.fixed_resolution
        avail = self._available_res(f, pc)
        if avail and res not in avail:
            res = avail[0]
        nbytes = self._chunk_bytes(f, pc, res)
        # lossless links pay no goodput haircut (satellite regression)
        tau_trans = self._loss_inflate(f.link,
                                       nbytes / max(f.est.est, 1.0))
        if self.pool is not None and res in self.table.latency \
                and self.table.chunk_size_mb.get(res):
            tau_dec = self.table.decode_latency(
                res, self.pool.load_at(now) + 1) \
                * self._decode_size_scale(nbytes, res)
        elif self.config.gpu_decomp_tokens_per_s:
            tau_dec = self.hooks.gpu_decomp_seconds(f, pc)
        else:
            tau_dec = 0.0
        tau_restore = self.hooks.restore_seconds(f, pc)
        if self.config.pipelined:
            # transmit and decode of successive chunks overlap: the
            # steady-state interval is the slower stage, plus the
            # (serial) restore event
            return max(tau_trans, tau_dec) + tau_restore
        return tau_trans + tau_dec + tau_restore

    def _maybe_admit_early(self, f: ActiveFetch, now: float) -> None:
        if f.pending_retx:
            # A dropped chunk's layer group is NOT buffered even though
            # later chunks may already be restored; admitting now would
            # stall compute at that group.  Wait for the retransmit.
            return
        comp = self.hooks.comp_times(f.req)
        if comp is None:
            return
        L = len(comp)
        total = max(f.plan.n_layers_total, 1)
        buffered = int(round(f.req.layers_ready * L / total))
        per_layer_dec = (self._projected_chunk_interval(f, now)
                         * len(f.plan.chunks) / max(L, 1))
        dec = [per_layer_dec] * L
        if non_blocking_ok(dec, comp, buffered):
            self.sched.notify_early_admissible(f.req, now)
