"""Network model: bandwidth traces, chunk loss, and shared-link arbitration.

Three layers, composed bottom-up into the WAN model the fetch pipeline
runs against (ROADMAP "WAN scenarios"; LMCache / KV-offloading analyses
show loss and contention, not raw bandwidth, dominate tail TTFT):

  * :class:`BandwidthTrace` — piecewise-constant link capacity over time.
    Transmission times integrate the trace exactly, so adaptive-resolution
    decisions see realistic partial-chunk bandwidth shifts (paper Fig. 17).
  * :class:`LossModel` — per-chunk-attempt drop decisions: independent
    Bernoulli, bursty Gilbert-Elliott (per-flow or *shared* cross-flow
    correlated), or a scripted drop set for tests.  Decisions are keyed
    on ``(flow, chunk, attempt)`` so a seeded model produces the *same*
    drop schedule in the analytic simulator and the virtual-clock live
    engine regardless of event interleaving.
  * :class:`SharedLink` — splits one trace across concurrent fetch flows
    (``fair`` weighted fluid sharing or ``drr`` deficit-round-robin chunk
    interleaving), replacing the old model where every in-flight fetch
    silently got the full trace bandwidth.  With ``ramp="slowstart"`` a
    joining flow's share multiplicatively grows toward its fair share
    instead of converging instantly (congestion-window-shaped ramp).

:class:`RttEstimator` (Jacobson/Karels SRTT/RTTVAR over chunk service
times) lives here too: the fetch controller uses it to derive the
per-flow adaptive retransmit timeout ``rto = srtt + 4*rttvar``.

Units
-----
Internally everything is **bytes/sec** and **seconds**.  All public
constructors take link rates in **Gbps** (``GBPS`` converts: 1 Gbps ==
1e9/8 bytes/sec); ``repr`` shows Gbps so printed traces are readable.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

#: bytes/sec per Gbps (all internal rates are bytes/sec).
GBPS = 1e9 / 8.0

#: Default arbitration weight for storage-tier *heal* (re-replication)
#: flows on a SharedLink.  Heal traffic shares the same links live
#: fetches ride (`StorageCluster` with ``heal="link"``); joining at
#: half weight keeps recovery from doubling the tail TTFT of requests
#: in flight while the ring re-converges — under ``fair`` a heal flow
#: gets weight/total_weight of the trace, under ``drr`` proportionally
#: fewer bytes per round (see `SharedLink`).
HEAL_WEIGHT = 0.5


@dataclasses.dataclass(repr=False)
class BandwidthTrace:
    """Piecewise-constant link capacity.

    ``times`` holds segment start times in **seconds** (``times[0] == 0``);
    ``bps`` holds the capacity of each segment in **bytes/sec** (note: not
    bits — use :data:`GBPS` or the constructors, which take Gbps).
    """

    times: np.ndarray  # [n] segment start times (s), times[0] == 0
    bps: np.ndarray  # [n] capacity in each segment (bytes/sec)

    @staticmethod
    def constant(gbps: float) -> "BandwidthTrace":
        """Flat trace at ``gbps`` gigabits/sec (stored as bytes/sec)."""
        return BandwidthTrace(np.array([0.0]), np.array([gbps * GBPS]))

    @staticmethod
    def steps(segs: Sequence[Tuple[float, float]]) -> "BandwidthTrace":
        """``segs``: [(t_start_seconds, gbps), ...], t_start ascending
        from 0.  Rates are gigabits/sec at this constructor boundary."""
        t = np.array([s[0] for s in segs], np.float64)
        b = np.array([s[1] * GBPS for s in segs], np.float64)
        assert t[0] == 0.0
        return BandwidthTrace(t, b)

    @staticmethod
    def jittered(rng: np.random.Generator, base_gbps: float,
                 duration: float, seg_len: float = 2.0,
                 rel_std: float = 0.35,
                 floor_frac: float = 0.25) -> "BandwidthTrace":
        """Random-walk-free jitter: one i.i.d. normal multiplier per
        ``seg_len``-second segment.

        ``base_gbps`` is gigabits/sec; each segment's rate is
        ``base_gbps * m`` with ``m ~ N(1, rel_std)`` clipped to
        ``[floor_frac, 2.5]`` — so the realized *mean* rate can sit
        slightly above ``base_gbps`` when ``rel_std`` is large (the clip
        is asymmetric).  The trace covers ``[0, duration]`` and holds the
        last segment's rate forever after.
        """
        n = max(2, int(duration / seg_len) + 1)
        mult = np.clip(rng.normal(1.0, rel_std, n), floor_frac, 2.5)
        return BandwidthTrace(np.arange(n) * seg_len,
                              base_gbps * GBPS * mult)

    def __repr__(self) -> str:  # Gbps, not raw bytes/sec
        g = self.bps / GBPS
        if len(g) == 1:
            return f"BandwidthTrace({g[0]:g} Gbps)"
        return (f"BandwidthTrace({len(g)} segs, "
                f"{g[0]:g}->{g[-1]:g} Gbps, mean {g.mean():.3g} Gbps)")

    def bw_at(self, t: float) -> float:
        """Capacity at time ``t`` (seconds) in **bytes/sec**."""
        i = int(np.searchsorted(self.times, t, side="right") - 1)
        return float(self.bps[max(i, 0)])

    def next_change(self, t: float) -> float:
        """First segment boundary strictly after ``t`` (inf if none)."""
        i = int(np.searchsorted(self.times, t, side="right"))
        return float(self.times[i]) if i < len(self.times) else float("inf")

    def transmit(self, nbytes: float, t0: float) -> float:
        """Finish time (seconds) of an ``nbytes``-byte transfer starting
        at ``t0``, integrating the trace exactly."""
        remaining = float(nbytes)
        t = t0
        i = int(np.searchsorted(self.times, t0, side="right") - 1)
        i = max(i, 0)
        while True:
            bw = float(self.bps[i])
            seg_end = (float(self.times[i + 1])
                       if i + 1 < len(self.times) else np.inf)
            dt = remaining / bw
            if t + dt <= seg_end:
                return t + dt
            remaining -= (seg_end - t) * bw
            t = seg_end
            i += 1


# ---------------------------------------------------------------------------
# RTT estimation (Jacobson/Karels)
# ---------------------------------------------------------------------------


class RttEstimator:
    """Jacobson/Karels smoothed-RTT estimator over chunk service times.

    The fetch controller feeds it the service time (submit -> wire
    completion) of every *first-attempt* chunk delivery — retransmitted
    chunks are skipped per Karn's algorithm, since their samples are
    ambiguous — and reads back the retransmit timeout

        rto = srtt + max(K * rttvar, floor)

    clamped to the caller's ``[min_rto, max_rto]``.  The ``floor`` term
    plays the role of TCP's clock granularity ``G``: once service times
    stabilize, ``rttvar`` decays geometrically toward zero and without a
    floor the deadline would converge onto the completion time itself,
    turning float jitter into spurious retransmissions.
    """

    ALPHA = 1.0 / 8.0  # srtt gain
    BETA = 1.0 / 4.0  # rttvar gain
    K = 4.0  # variance multiplier in the RTO

    def __init__(self) -> None:
        self.srtt: Optional[float] = None
        self.rttvar: float = 0.0

    def observe(self, sample: float) -> None:
        if sample <= 0:
            return
        if self.srtt is None:
            self.srtt = sample
            self.rttvar = sample / 2.0
            return
        self.rttvar = ((1.0 - self.BETA) * self.rttvar
                       + self.BETA * abs(self.srtt - sample))
        self.srtt = (1.0 - self.ALPHA) * self.srtt + self.ALPHA * sample

    def rto(self, min_rto: float, max_rto: float) -> Optional[float]:
        """Current retransmit timeout, or None before the first sample
        (the caller seeds the pre-sample deadline from its bandwidth
        estimate instead)."""
        if self.srtt is None:
            return None
        raw = self.srtt + max(self.K * self.rttvar, min_rto)
        return min(max(raw, min_rto), max_rto)


# ---------------------------------------------------------------------------
# Chunk loss
# ---------------------------------------------------------------------------


class LossModel:
    """Per-chunk-attempt drop decisions for the WAN scenarios.

    Every transmission attempt of every chunk asks :meth:`dropped` once.
    Draws are keyed on ``(seed, flow, chunk_seq, attempt)`` — *not* on
    global call order — so the same seeded model replays the identical
    drop schedule in the analytic simulator and the virtual-clock live
    engine even though their event interleavings differ.  The decided
    schedule is recorded in :attr:`drops` as ``(flow, chunk_seq,
    attempt)`` triples.

    Modes
    -----
    ``bernoulli``        i.i.d. loss with probability ``p`` per attempt.
    ``gilbert_elliott``  two-state burst-loss chain (good/bad states with
                         per-state loss rates); the chain advances once
                         per attempt *per flow*, so burst structure is
                         deterministic given the per-flow attempt order
                         (which the controller serializes).
    ``ge_shared``        cross-flow **correlated** bursts: one shared
                         good/bad chain advanced per ``slot`` seconds of
                         virtual time (the link's physical state), so
                         concurrent flows see the same bursts.  The state
                         of slot ``n`` is a pure function of ``(seed,
                         n)``-seeded draws and the per-attempt loss draw
                         stays keyed on ``(flow, chunk, attempt)`` —
                         environments whose wire timings agree (same
                         bytes over the same link) replay the identical
                         schedule regardless of decode/restore timing.
    ``scripted``         an explicit drop set, for tests and docs.
    """

    def __init__(self, mode: str, seed: int = 0, *, p: float = 0.0,
                 good_to_bad: float = 0.05, bad_to_good: float = 0.25,
                 p_good: float = 0.001, p_bad: float = 0.5,
                 slot: float = 0.05,
                 script: Optional[Set[Tuple[int, int, int]]] = None):
        assert mode in ("bernoulli", "gilbert_elliott", "ge_shared",
                        "scripted")
        self.mode = mode
        self.seed = seed
        self.p = p
        self.good_to_bad = good_to_bad
        self.bad_to_good = bad_to_good
        self.p_good = p_good
        self.p_bad = p_bad
        self.slot = slot  # ge_shared: seconds per link-state step
        self.script = script or set()
        self.drops: List[Tuple[int, int, int]] = []  # decided drop schedule
        self.drop_slots: List[int] = []  # ge_shared: slot of each drop
        self.attempts = 0
        self._ge_state: Dict[int, bool] = {}  # flow -> in bad state?
        self._ge_step: Dict[int, int] = {}  # flow -> chain step counter
        self._shared: List[bool] = [False]  # slot idx -> in bad state?
        # one sequential stream drives the shared chain's transitions
        # (slot n's state depends only on (seed, draws 1..n), so every
        # instance replays the same states without a per-slot Generator)
        self._shared_rng = np.random.default_rng((seed, 0x6E57))

    # -- constructors -------------------------------------------------------
    @staticmethod
    def bernoulli(p: float, seed: int = 0) -> "LossModel":
        """Independent per-attempt loss with probability ``p``."""
        return LossModel("bernoulli", seed, p=p)

    @staticmethod
    def gilbert_elliott(seed: int = 0, *, good_to_bad: float = 0.05,
                        bad_to_good: float = 0.25, p_good: float = 0.001,
                        p_bad: float = 0.5) -> "LossModel":
        """Bursty loss: a per-flow good/bad Markov chain advanced once per
        attempt; losses are drawn at ``p_good``/``p_bad`` by state."""
        return LossModel("gilbert_elliott", seed, good_to_bad=good_to_bad,
                         bad_to_good=bad_to_good, p_good=p_good,
                         p_bad=p_bad)

    @staticmethod
    def scripted(drops: Set[Tuple[int, int, int]]) -> "LossModel":
        """Drop exactly the given ``(flow, chunk_seq, attempt)`` triples."""
        return LossModel("scripted", script=set(drops))

    @staticmethod
    def correlated(seed: int = 0, *, slot: float = 0.05,
                   good_to_bad: float = 0.05, bad_to_good: float = 0.25,
                   p_good: float = 0.001,
                   p_bad: float = 0.5) -> "LossModel":
        """Cross-flow correlated bursts: one **shared** Gilbert-Elliott
        link state sampled once per ``slot`` seconds of virtual time, so
        concurrent flows see bad periods together (a congested or fading
        WAN segment drops everyone's chunks at once, not one flow's)."""
        return LossModel("ge_shared", seed, slot=slot,
                         good_to_bad=good_to_bad, bad_to_good=bad_to_good,
                         p_good=p_good, p_bad=p_bad)

    # -- queries ------------------------------------------------------------
    def _draw(self, flow: int, seq: int, attempt: int) -> float:
        rng = np.random.default_rng(
            (self.seed, int(flow), int(seq), int(attempt)))
        return float(rng.random())

    def _shared_bad(self, slot_idx: int) -> bool:
        """State of the shared chain at time slot ``slot_idx``: a pure
        function of the seed and the slot (transition draws come from one
        sequential seeded stream, advanced — and memoized — front-to-
        back, so query order never changes the states)."""
        while len(self._shared) <= slot_idx:
            u = float(self._shared_rng.random())
            bad = self._shared[-1]
            bad = (u >= self.bad_to_good) if bad else \
                (u < self.good_to_bad)
            self._shared.append(bad)
        return self._shared[slot_idx]

    def dropped(self, flow: int, seq: int, attempt: int,
                now: float = 0.0) -> bool:
        """Decide (and record) whether this transmission attempt is lost.
        ``now`` is the attempt's delivery instant on the virtual clock —
        only the ``ge_shared`` mode reads it (to index the shared link
        state); the other modes stay keyed purely on the triple."""
        self.attempts += 1
        if self.mode == "scripted":
            lost = (flow, seq, attempt) in self.script
        elif self.mode == "bernoulli":
            lost = self._draw(flow, seq, attempt) < self.p
        elif self.mode == "ge_shared":
            slot_idx = max(int(now / self.slot), 0)
            bad = self._shared_bad(slot_idx)
            lost = self._draw(flow, seq, attempt) < \
                (self.p_bad if bad else self.p_good)
            if lost:
                self.drop_slots.append(slot_idx)
        else:  # gilbert_elliott: advance this flow's chain one step
            step = self._ge_step.get(flow, 0)
            self._ge_step[flow] = step + 1
            rng = np.random.default_rng((self.seed, int(flow), step))
            u_state, u_loss = rng.random(2)
            bad = self._ge_state.get(flow, False)
            bad = (u_state >= self.bad_to_good) if bad else \
                (u_state < self.good_to_bad)
            self._ge_state[flow] = bad
            lost = u_loss < (self.p_bad if bad else self.p_good)
        if lost:
            self.drops.append((flow, seq, attempt))
        return lost

    def mean_loss_rate(self) -> float:
        """Stationary per-attempt loss probability (for bulk-transfer
        baselines that model loss as a goodput haircut)."""
        if self.mode == "bernoulli":
            return self.p
        if self.mode in ("gilbert_elliott", "ge_shared"):
            denom = self.good_to_bad + self.bad_to_good
            frac_bad = self.good_to_bad / denom if denom else 0.0
            return frac_bad * self.p_bad + (1 - frac_bad) * self.p_good
        return 0.0


# ---------------------------------------------------------------------------
# Shared-link arbitration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Xfer:
    flow: int
    nbytes: float
    left: float
    t_ready: float
    cb: Callable[[float], None]  # called with the finish time
    cancelled: bool = False  # abandoned duplicate: cb never fires


class SharedLink:
    """Splits one :class:`BandwidthTrace` across concurrent fetch flows.

    The fetch controller binds its event queue via :meth:`bind` and then
    submits chunk transfers with :meth:`submit`; the link schedules each
    transfer's completion event itself (re-timing in-flight transfers as
    flows join and leave), so both hook environments see the identical
    contention model.

    Policies
    --------
    ``fair``  weighted fluid (processor-sharing) model: at any instant
              every active flow receives ``weight / total_active_weight``
              of the trace capacity, split evenly over that flow's
              in-flight transfers (a flow retransmitting while its next
              chunk streams does not get a double share).
    ``drr``   deficit round robin at chunk granularity: the wire carries
              one chunk at a time at full trace rate; queued chunks are
              served in round-robin order with per-flow deficit counters,
              so a weight-2 flow gets ~2x the bytes of a weight-1 flow
              while both are backlogged.

    Ramp
    ----
    ``ramp="instant"`` (default) reproduces the classic fluid model: a
    joining flow snaps straight to its fair share.  ``ramp="slowstart"``
    shapes the join like a congestion window: the flow starts at
    ``ramp_init`` of its fair share and doubles every ``ramp_interval``
    seconds (in-flight transfers are re-timed at each ramp epoch) until
    it reaches the full share.  Capacity a ramping flow leaves unclaimed
    goes to fully-ramped flows; if every flow is still ramping the link
    runs underutilized — exactly the slow-start underutilization real
    transports pay.  Under ``drr`` the ramp factor scales the flow's
    deficit quantum instead.

    A single-flow ``fair`` link degenerates to the bare trace, so wrapping
    a dedicated link in :class:`SharedLink` changes nothing — which is why
    :func:`make_link` always wraps.
    """

    #: DRR service quantum added per round-robin visit (bytes).
    DRR_QUANTUM = 4e6

    def __init__(self, trace: BandwidthTrace, policy: str = "fair",
                 loss: Optional[LossModel] = None, ramp: str = "instant",
                 ramp_init: float = 0.125, ramp_interval: float = 0.5):
        assert policy in ("fair", "drr"), policy
        assert ramp in ("instant", "slowstart"), ramp
        # a zero initial share would stall fair-share math (and DRR's
        # quantum accumulation) forever
        assert 0.0 < ramp_init <= 1.0, ramp_init
        self.trace = trace
        self.policy = policy
        self.loss = loss
        self.ramp = ramp
        self.ramp_init = ramp_init
        self.ramp_interval = ramp_interval
        self._ramp: Dict[int, float] = {}  # flow -> share factor (<= 1)
        # per-open generation token: flow ids are reused (retransmit /
        # heal / prefetch flows close and reopen under the same id), and
        # a ramp epoch scheduled by a previous open must not advance the
        # ramp of a later one
        self._ramp_gen: Dict[int, int] = {}
        self._push: Optional[Callable[[float, Callable], None]] = None
        self._weights: Dict[int, float] = {}
        # share-change observers (ABR down-switching, ISSUE 7): called
        # with (t, reason) whenever the per-flow share structure moves —
        # a flow joins/leaves or a slow-start ramp epoch fires — so the
        # fetch controller can re-evaluate remaining chunks' resolution
        # at the collapse instant instead of a chunk boundary later
        self._share_listeners: List[Callable[[float, str], None]] = []
        # fair-mode state: fluid frontier + in-flight transfers
        self._xfers: List[_Xfer] = []
        self._t = 0.0
        self._epoch = 0
        # drr-mode state
        self._queue: List[_Xfer] = []
        self._order: List[int] = []  # round-robin flow order
        self._rr = 0
        self._deficit: Dict[int, float] = {}
        self._serving: Optional[_Xfer] = None
        self._busy_until = 0.0

    def __repr__(self) -> str:
        return (f"SharedLink({self.policy}, {len(self._weights)} flows, "
                f"{self.trace!r})")

    # -- controller wiring --------------------------------------------------
    def bind(self, push: Callable[[float, Callable], None]) -> None:
        """Receive the controller's event-queue ``push(t, fn)`` handle."""
        self._push = push

    def on_share_change(self,
                        fn: Callable[[float, str], None]) -> None:
        """Subscribe to share-structure changes.  ``fn(t, reason)`` fires
        synchronously when a flow joins (``"flow_join"``), leaves with a
        known time (``"flow_leave"``), or a slow-start ramp epoch
        re-shares the link (``"ramp_epoch"``).  Deterministic: driven
        only by open/close/ramp events on the virtual clock."""
        if fn not in self._share_listeners:
            self._share_listeners.append(fn)

    def _notify_share(self, t: Optional[float], reason: str) -> None:
        if t is None:
            return  # no virtual-clock timestamp: nothing to re-time
        for fn in list(self._share_listeners):
            fn(t, reason)

    def open_flow(self, flow: int, weight: float = 1.0,
                  t: Optional[float] = None) -> None:
        """Register a flow.  With ``ramp="slowstart"`` and a join time
        ``t``, the flow starts at ``ramp_init`` of its share and doubles
        every ``ramp_interval`` seconds (epochs ride the bound event
        queue); without ``t`` (or in ``instant`` mode) it joins at full
        share."""
        self._weights[flow] = float(weight)
        # every open (including a reopen of a reused flow id) starts a
        # fresh ramp generation; epochs scheduled by prior opens of the
        # same id become stale and are dropped in _ramp_epoch
        gen = self._ramp_gen.get(flow, 0) + 1
        self._ramp_gen[flow] = gen
        if flow not in self._order:
            self._order.append(flow)
            self._deficit.setdefault(flow, 0.0)
        if self.ramp == "slowstart" and t is not None \
                and self._push is not None:
            self._ramp[flow] = self.ramp_init
            self._push(t + self.ramp_interval,
                       lambda tt, fl=flow, g=gen: self._ramp_epoch(fl, tt, g))
        else:
            self._ramp.pop(flow, None)
        self._notify_share(t, "flow_join")

    def _ramp_epoch(self, flow: int, t: float, gen: int) -> None:
        """One slow-start doubling; re-times in-flight transfers."""
        if gen != self._ramp_gen.get(flow):
            return  # stale epoch from a previous open of this flow id
        cur = self._ramp.get(flow)
        if cur is None or flow not in self._weights:
            return  # flow finished ramping or already closed
        if self.policy == "fair":
            self._advance(t)
        nxt = min(1.0, cur * 2.0)
        if nxt >= 1.0:
            self._ramp.pop(flow, None)
        else:
            self._ramp[flow] = nxt
            self._push(t + self.ramp_interval,
                       lambda tt, fl=flow, g=gen: self._ramp_epoch(fl, tt, g))
        if self.policy == "fair":
            self._reschedule()
        self._notify_share(t, "ramp_epoch")

    def close_flow(self, flow: int, t: Optional[float] = None) -> None:
        """Unregister a flow.  ``t`` (optional) timestamps the leave for
        share-change listeners; legacy callers that omit it skip the
        notification (a leave only ever *raises* the survivors' shares,
        so no down-switch is missed)."""
        self._weights.pop(flow, None)
        self._ramp.pop(flow, None)
        self._reap(flow)
        self._notify_share(t, "flow_leave")

    # -- trace passthrough (estimator seeding; bulk blocking baseline) ------
    def bw_at(self, t: float) -> float:
        """Full-trace capacity at ``t`` in bytes/sec (flow shares are a
        runtime property; estimators learn them from observed chunks)."""
        return self.trace.bw_at(t)

    def transmit(self, nbytes: float, t0: float) -> float:
        """Unarbitrated bulk transfer occupying the whole trace: the
        inference-blocking (LMCache-style) baseline path."""
        return self.trace.transmit(nbytes, t0)

    # -- arbitrated submission ----------------------------------------------
    def submit(self, flow: int, nbytes: float, t0: float,
               cb: Callable[[float], None]) -> object:
        """Start an ``nbytes`` chunk transfer for ``flow`` at ``t0``;
        ``cb(t_done)`` fires from the controller's event queue when the
        wire transfer completes under the arbitration policy.  Returns an
        opaque handle accepted by :meth:`cancel`."""
        assert self._push is not None, "SharedLink.bind() not called"
        x = _Xfer(flow, float(nbytes), float(nbytes), t0, cb)
        if self.policy == "fair":
            self._advance(t0)
            self._xfers.append(x)
            self._reschedule()
        else:
            self._queue.append(x)
            if self._serving is None:
                self._dispatch(max(t0, self._busy_until))
        return x

    def cancel(self, handle: object, t: float) -> None:
        """Abandon an in-flight transfer (a superseded retransmit
        duplicate): its callback never fires.  Under ``fair`` the
        remaining bytes leave the fluid at ``t`` and the other transfers
        are re-timed; under ``drr`` a queued chunk is pulled from the
        queue, while a chunk already on the wire finishes occupying it
        (those bytes are committed) with its completion suppressed."""
        x = handle
        if not isinstance(x, _Xfer) or x.cancelled:
            return
        x.cancelled = True
        if self.policy == "fair":
            if x in self._xfers:
                self._advance(t)
                self._xfers.remove(x)
                self._reschedule()
        else:
            if x in self._queue:
                self._queue.remove(x)
                self._reap(x.flow)

    def _reap(self, flow: int) -> None:
        """Drop a closed flow from the DRR round-robin state once it has
        nothing queued or serving (deferred close_flow cleanup)."""
        if flow in self._weights or flow not in self._order:
            return
        busy = ((self._serving is not None and self._serving.flow == flow)
                or any(x.flow == flow for x in self._queue))
        if busy:
            return
        i = self._order.index(flow)
        self._order.remove(flow)
        if self._rr > i:
            self._rr -= 1
        if self._order:
            self._rr %= len(self._order)
        self._deficit.pop(flow, None)

    # -- fair: fluid weighted processor sharing -----------------------------
    def _shares(self) -> Dict[int, float]:
        """Per-transfer capacity fractions: each flow gets its (ramp-
        scaled) weighted share split evenly over its in-flight transfers;
        capacity that ramping flows leave unclaimed is redistributed to
        fully-ramped flows by weight (or left idle if all are ramping)."""
        per_flow: Dict[int, int] = {}
        for x in self._xfers:
            per_flow[x.flow] = per_flow.get(x.flow, 0) + 1
        w = {f: self._weights.get(f, 1.0) for f in per_flow}
        W = sum(w.values())
        share = {f: w[f] / W * self._ramp.get(f, 1.0) for f in per_flow}
        leftover = 1.0 - sum(share.values())
        full = [f for f in per_flow if f not in self._ramp]
        if leftover > 1e-12 and full:
            Wf = sum(w[f] for f in full)
            for f in full:
                share[f] += leftover * w[f] / Wf
        return {id(x): share[x.flow] / per_flow[x.flow]
                for x in self._xfers}

    def _advance(self, t: float) -> None:
        """Drain in-flight bytes at the current shares up to time ``t``."""
        while self._xfers and self._t < t:
            shares = self._shares()
            step = min(t, self.trace.next_change(self._t))
            bw = self.trace.bw_at(self._t)
            dt = step - self._t
            for x in self._xfers:
                x.left -= bw * shares[id(x)] * dt
            self._t = step
        self._t = max(self._t, t)

    def _reschedule(self) -> None:
        """Push a (possibly superseding) event at the earliest projected
        completion; stale events are ignored via the epoch counter."""
        self._epoch += 1
        if not self._xfers:
            return
        shares = self._shares()
        t_next = min(self.trace.transmit(max(x.left, 0.0) / shares[id(x)],
                                         self._t) for x in self._xfers)
        ep = self._epoch
        self._push(t_next, lambda t: self._tick(t, ep))

    @staticmethod
    def _drained(x: _Xfer) -> bool:
        # relative tolerance: integration error scales with transfer size
        return x.left <= 1e-6 + 1e-9 * x.nbytes

    def _tick(self, t: float, epoch: int) -> None:
        if epoch != self._epoch:
            return  # superseded by a later join/leave
        self._advance(t)
        done = [x for x in self._xfers if self._drained(x)]
        if not done and self._xfers:
            # numerical guard: if the earliest projected completion can no
            # longer advance the clock, the residue is pure float error —
            # force-complete it instead of ticking forever at time t
            shares = self._shares()
            nxt = min(self._xfers,
                      key=lambda x: self.trace.transmit(
                          x.left / shares[id(x)], t))
            if self.trace.transmit(nxt.left / shares[id(nxt)],
                                   t) <= t + 1e-9 * max(t, 1.0):
                nxt.left = 0.0
                done = [nxt]
        self._xfers = [x for x in self._xfers if x not in done]
        for x in done:
            # a callback earlier in this loop may have cancelled a later
            # transfer that drained in the same tick (e.g. a fetch abort
            # at a shared trace boundary) — honor it, as _drr_done does
            if not x.cancelled:
                x.cb(t)
        self._reschedule()

    # -- drr: serialized wire, deficit-round-robin chunk interleave ---------
    def _dispatch(self, t: float) -> None:
        backlogged = {x.flow for x in self._queue}
        if not backlogged:
            return
        while True:
            flow = self._order[self._rr]
            self._rr = (self._rr + 1) % len(self._order)
            if flow not in backlogged:
                continue
            self._deficit[flow] = self._deficit.get(flow, 0.0) + \
                self.DRR_QUANTUM * self._weights.get(flow, 1.0) * \
                self._ramp.get(flow, 1.0)
            head = next(x for x in self._queue if x.flow == flow)
            if self._deficit[flow] < head.nbytes:
                continue
            self._deficit[flow] -= head.nbytes
            self._queue.remove(head)
            if not any(x.flow == flow for x in self._queue):
                self._deficit[flow] = 0.0  # no banking credit while idle
            t_start = max(t, head.t_ready)
            t_done = self.trace.transmit(head.nbytes, t_start)
            self._serving = head
            self._busy_until = t_done
            self._push(t_done, lambda tt, h=head: self._drr_done(h, tt))
            return

    def _drr_done(self, x: _Xfer, t: float) -> None:
        self._serving = None
        if x.cancelled:  # abandoned mid-wire: bytes burned, no callback
            self._reap(x.flow)
        else:
            x.cb(t)  # may submit the flow's next chunk synchronously
        if self._serving is None and self._queue:
            self._dispatch(max(t, self._busy_until))

    @property
    def in_flight(self) -> int:
        return len(self._xfers) + len(self._queue) + \
            (1 if self._serving is not None else 0)

    @property
    def n_flows(self) -> int:
        """Open flows on this link (the serving node knows its own
        concurrency — used to seed projected service times before the
        first goodput sample lands)."""
        return len(self._weights)

    def demand_flows(self) -> int:
        """Open flows with non-negative ids.  Background transfers
        (storage heals, speculative prefetches) use negative flow ids by
        repo convention, so this counts the demand fetches currently on
        the link — the prefetcher defers new speculation while it is
        non-zero."""
        return sum(1 for fl in self._weights if fl >= 0)

    def ramp_factor(self, flow: int) -> float:
        """Current slow-start factor of ``flow`` (1.0 once fully ramped
        or in ``instant`` mode).  A sender knows its own congestion
        window: the fetch controller divides its projected service time
        by this, so self-imposed ramp slowness never reads as loss."""
        return self._ramp.get(flow, 1.0)

    def flow_share(self, flow: int) -> float:
        """Fraction of the trace capacity ``flow`` would receive right
        now under the fluid model: its (ramp-scaled) weighted share over
        every *open* flow, plus its part of the capacity that ramping
        flows leave unclaimed (redistributed to fully-ramped flows by
        weight, mirroring :meth:`_shares`).  Unlike ``_shares`` this is
        a pure function of the open/close/ramp state — no in-flight
        transfer bookkeeping — so the fetch controller can use it to
        rescale its bandwidth estimate deterministically when the share
        structure moves (ABR down-switching).  An unknown flow sees the
        full pipe (1.0)."""
        if flow not in self._weights:
            return 1.0
        w = self._weights
        W = sum(w.values())
        share = {f: w[f] / W * self._ramp.get(f, 1.0) for f in w}
        leftover = 1.0 - sum(share.values())
        full = [f for f in w if f not in self._ramp]
        if leftover > 1e-12 and full:
            Wf = sum(w[f] for f in full)
            for f in full:
                share[f] += leftover * w[f] / Wf
        return share[flow]


def make_link(bandwidth, policy: Optional[str] = None,
              loss: Optional[LossModel] = None,
              ramp: Optional[str] = None) -> SharedLink:
    """Wrap a :class:`BandwidthTrace` (or anything exposing ``bw_at`` /
    ``transmit``) into a :class:`SharedLink`; pass an existing link
    through unchanged (asserting no conflicting loss/policy/ramp
    request).  ``policy=None`` / ``ramp=None`` mean "caller doesn't
    care": bare traces get ``fair`` / ``instant``, existing links keep
    whatever they were built with."""
    if isinstance(bandwidth, SharedLink):
        assert loss is None or bandwidth.loss is loss, \
            "conflicting LossModel for an already-built SharedLink"
        assert policy is None or bandwidth.policy == policy, \
            f"link is {bandwidth.policy!r}, caller asked for {policy!r}"
        assert ramp is None or bandwidth.ramp == ramp, \
            f"link ramps {bandwidth.ramp!r}, caller asked for {ramp!r}"
        return bandwidth
    return SharedLink(bandwidth, policy=policy or "fair", loss=loss,
                      ramp=ramp or "instant")
