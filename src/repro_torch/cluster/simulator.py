"""Discrete-event serving simulator: the TTFT/TPOT experiment harness.

The *policy code* under test (fetching-aware scheduler, Alg. 1 adaptive
resolution, Appx A.3 layer-wise admission) is the production code from
repro_torch.core — since the async-fetch refactor the whole transmit ->
decode -> restore pipeline state machine is
`repro_torch.core.fetch_controller`, the SAME code the live engine
pumps; the simulator only supplies clocks: an analytic engine cost
model (costmodel.py), a WAN link model — bandwidth
traces shared across concurrent fetches by a fair/DRR arbiter, with
optional seeded chunk loss and retransmission (network.py) — and decode
pools with the paper's profiled NVDEC tables (decodepool.py).
Compressed chunk sizes are driven by ratios measured with the real codec
on real KV tensors.

With ``storage=`` a multi-node prefix tier (storage.py,
docs/storage_tier.md) resolves every fetch before it starts: full hits
fetch over the serving node's own link, partial hits fetch the resident
ancestor and recompute the tail, misses fall back to a full prefill —
and the tier's delayed write-on-miss re-admits the prefix only once
that prefill reaches its first token.  ``fail_at=[(t, node_id)]`` /
``recover_at=`` script node churn mid-run: failed nodes' keys re-route
to ring successors and re-replication heals stream over the nodes' own
links, contending with live fetches (ttft.storage.failover.* rows).

Methods modeled (paper §5.1 baselines):
  kvfetcher    video codec (ours), adaptive res, fetch-aware sched,
               layer-wise early admission, frame-wise restoration
  llm265       video codec w/o inter-frame prediction (lower ratio), fixed
               resolution, fetch-agnostic batching, chunk-wise restoration
  cachegen     arithmetic coding ratio, GPU CUDA decompression (contends:
               +50% prefill, +20% decode while active), HOL scheduling
  raw          Mooncake-style raw KV transfer, layer-wise pipeline, no
               decode stage
  lmcache_raw  raw KV transfer, inference-blocking fetch
  full_prefill no reuse at all
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adaptive import DecodeTable
from repro_torch.core.fetch import FetchPlan, synthetic_plan
from repro_torch.core.fetch_controller import (ActiveFetch, FetchController,
                                               FetchHooks, PipelineConfig)
from repro_torch.core.scheduler import FetchingAwareScheduler, Request
from repro_torch.cluster.costmodel import CHIPS, EngineCostModel
from repro_torch.cluster.decodepool import DecodePool
from repro_torch.cluster.network import BandwidthTrace, LossModel, make_link
from repro_torch.cluster.storage import StorageCluster

RESOLUTIONS = ("240p", "480p", "640p", "1080p")


@dataclasses.dataclass
class MethodSpec:
    name: str
    reuse: bool = True
    # fp16-relative compression ratio per resolution (video methods) or a
    # single "ratio" entry (byte-stream methods); 1.0 == raw fp16
    ratios: Dict[str, float] = dataclasses.field(default_factory=dict)
    adaptive: bool = False
    fixed_resolution: str = "1080p"
    uses_decode_pool: bool = True
    gpu_decomp_tokens_per_s: float = 0.0  # CacheGen-style CUDA decomp
    prefill_slowdown: float = 1.0  # while GPU decompression is active
    decode_slowdown: float = 1.0
    scheduler_policy: str = "kvfetcher"  # or fetch_agnostic
    layerwise_admission: bool = False
    framewise_restoration: bool = True
    blocking_fetch: bool = False  # LMCache: engine idles during fetch
    # False models the chunk-serial sync baseline (chunk i+1 waits for
    # chunk i's restore) — the WAN async-vs-sync comparisons flip this.
    pipelined: bool = True
    # Reproduce the paper's own chunk-size operating point (Appx A.2
    # tables: 180-256 MB per chunk) instead of deriving sizes from the
    # measured compression ratio. Used by the Fig. 17/23 experiments.
    use_table_sizes: bool = False
    # Retransmit-timeout mode: "adaptive" = per-flow Jacobson/Karels
    # estimator (default), "fixed" = projected wire time + the constant
    # PipelineConfig.retransmit_timeout grace (the non-adaptive baseline
    # the ttft.wan.adaptive.* bench rows compare against).
    rto_mode: str = "adaptive"
    # Per-chunk transmission-attempt cap; exhaustion (every copy lost)
    # aborts the fetch and falls back to full prefill via
    # notify_fetch_miss instead of stalling the request forever.
    max_attempts: int = 64
    # Resolution ladder the fetcher may select from (ABR selection picks
    # within this set; a storage hit further restricts it to the rungs
    # still resident on the serving node).  Cross-env tests narrow this
    # to match the live engine's registered manifest ladder.
    resolutions: Tuple[str, ...] = RESOLUTIONS


def kvfetcher_spec(ratios: Dict[str, float]) -> MethodSpec:
    return MethodSpec("kvfetcher", ratios=ratios, adaptive=True,
                      scheduler_policy="kvfetcher",
                      layerwise_admission=True, framewise_restoration=True)


def llm265_spec(ratio: float) -> MethodSpec:
    return MethodSpec("llm265", ratios={r: ratio for r in RESOLUTIONS},
                      adaptive=False, fixed_resolution="1080p",
                      scheduler_policy="fetch_agnostic",
                      framewise_restoration=False)


def cachegen_spec(ratio: float) -> MethodSpec:
    return MethodSpec("cachegen", ratios={"stream": ratio},
                      uses_decode_pool=False,
                      gpu_decomp_tokens_per_s=60_000,
                      prefill_slowdown=1.5, decode_slowdown=1.2,
                      scheduler_policy="fetch_agnostic",
                      framewise_restoration=False)


def raw_spec() -> MethodSpec:
    return MethodSpec("raw", ratios={"stream": 1.0}, uses_decode_pool=False,
                      scheduler_policy="kvfetcher",
                      layerwise_admission=True)


def lmcache_raw_spec() -> MethodSpec:
    return MethodSpec("lmcache_raw", ratios={"stream": 1.0},
                      uses_decode_pool=False,
                      scheduler_policy="fetch_agnostic",
                      blocking_fetch=True)


def full_prefill_spec() -> MethodSpec:
    return MethodSpec("full_prefill", reuse=False)


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    requests: List[Request]
    decode_pool_utilization: float
    decompress_buffer_high_water: float
    sim_time: float
    retransmits: int = 0  # loss-driven (genuine) resends
    # resends whose original (slow, not lost) copy later delivered: the
    # duplicate was cancelled and its bytes wasted — the signature of a
    # retransmit timeout shorter than the contended chunk service time
    spurious_retransmits: int = 0
    # ABR down/up-switch events, in emission order:
    # (rid, chunk_seq, from_res, to_res, reason) — timestamp-free so the
    # cross-environment replay tests compare them directly
    resolution_switches: List[Tuple[int, int, str, str, str]] = \
        dataclasses.field(default_factory=list)
    # user-level fairness decision log, in emission order:
    # (user, rid, kind, milli-counter) — timestamp-free, byte-identical
    # across environments for the same trace (docs/fairness.md); empty
    # unless the simulator was built with fairness=
    fairness_events: List[Tuple[str, int, str, int]] = \
        dataclasses.field(default_factory=list)

    def fetching(self) -> List[Request]:
        return [r for r in self.requests if r.needs_fetch]

    def non_reuse(self) -> List[Request]:
        return [r for r in self.requests if not r.needs_fetch]


class _SimHooks(FetchHooks):
    """Analytic cost models standing in for the live codec/restore path."""

    def __init__(self, sim: "ServingSimulator"):
        self.sim = sim

    @staticmethod
    def _n_tok(pc) -> int:
        return pc.ref.token_end - pc.ref.token_start

    def chunk_bytes(self, fetch: ActiveFetch, pc, res: str) -> float:
        return self.sim._chunk_bytes(self._n_tok(pc), res)

    def gpu_decomp_seconds(self, fetch: ActiveFetch, pc) -> float:
        # throughput is in full-KV tokens/s; one chunk holds only a
        # (3 layers x 1 kind) share of each token's KV
        cfg = self.sim.cfg
        n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
        share = 3.0 / max(2 * n_attn, 1)
        return (self._n_tok(pc) * share
                / self.sim.method.gpu_decomp_tokens_per_s)

    def restore_seconds(self, fetch: ActiveFetch, pc) -> float:
        if self.sim.method.framewise_restoration:
            return 0.002
        raw_chunk = self.sim.cfg.kv_bytes_per_token() * self._n_tok(pc)
        return raw_chunk / (self.sim.cost.chip.hbm_bw * 0.5)

    def buffer_bytes(self, fetch: ActiveFetch, pc) -> float:
        if self.sim.method.framewise_restoration:
            frame_bytes = self.sim.cfg.kv_bytes_per_token() / 2 * 64
            return 2 * frame_bytes  # residual + reference frame
        return 2.7 * self.sim.cfg.kv_bytes_per_token() * self._n_tok(pc)

    def bulk_buffer_bytes(self, fetch: ActiveFetch) -> float:
        raw_chunk = self.sim.cfg.kv_bytes_per_token() * min(
            fetch.req.reuse_tokens, self.sim.chunk_tokens)
        return 2.7 * raw_chunk

    def comp_times(self, req: Request):
        return self.sim.cost.layer_comp_times(
            req.prompt_len - req.reuse_tokens + self.sim.prefill_chunk)


class ServingSimulator:
    def __init__(self, cfg: ModelConfig, method: MethodSpec, *,
                 # analytic engine cost model knobs — simulator-only by
                 # construction (the live engine runs real compute)
                 # repro-lint: allow(cross-env-parity)
                 chip: str = "h20", n_chips: int = 2,
                 bandwidth: BandwidthTrace,
                 loss: Optional[LossModel] = None,
                 link_policy: Optional[str] = None,  # None -> "fair"
                 link_ramp: Optional[str] = None,  # None -> "instant"
                 storage: Optional[StorageCluster] = None,
                 # speculative prefetch + host staging tier: a
                 # repro_torch.cluster.staging.PrefetchManager over `storage`
                 prefetch=None,
                 # scripted storage-node churn: fail_at=[(t, node_id)]
                 # kills nodes mid-run, recover_at brings them back.
                 # Sim-only ctor form: LiveEngine scripts the identical
                 # churn imperatively via fail_node()/recover_node()
                 # (clock-scale-free, so the logs still replay)
                 # repro-lint: allow(cross-env-parity)
                 fail_at: Optional[List[Tuple[float, str]]] = None,
                 # repro-lint: allow(cross-env-parity)
                 recover_at: Optional[List[Tuple[float, str]]] = None,
                 table: Optional[DecodeTable] = None,
                 # user-level fair scheduling: a
                 # repro_torch.cluster.fairness.FairScheduler shared with the
                 # FetchingAwareScheduler (docs/fairness.md)
                 fairness=None,
                 # analytic chunking/throughput knobs (the live engine
                 # derives these from the model + paged memory)
                 # repro-lint: allow(cross-env-parity)
                 chunk_tokens: int = 10_000,
                 # repro-lint: allow(cross-env-parity)
                 prefill_chunk: int = 2048,
                 max_running: int = 8,
                 # repro-lint: allow(cross-env-parity)
                 mfu: float = 0.45):
        self.cfg = cfg
        self.method = method
        self.cost = EngineCostModel(cfg, CHIPS[chip], n_chips, mfu=mfu)
        # concurrent fetches share (and contend for) one WAN link; chunks
        # may additionally be dropped by the loss model and retransmitted.
        # With a multi-node ``storage`` tier each fetch is instead routed
        # over the serving node's own link (this one stays the default for
        # nodes without a dedicated link).
        self.storage = storage
        if storage is not None and (loss is not None
                                    or link_policy is not None
                                    or link_ramp is not None):
            assert all(n.link is None for n in storage.nodes), \
                "loss=/link_policy=/link_ramp= only shape the default " \
                "link; nodes with their own links must carry their own " \
                "LossModel/policy/ramp: StorageNode(link=make_link(" \
                "trace, policy=, loss=, ramp=))"
        self.link = make_link(bandwidth, policy=link_policy, loss=loss,
                              ramp=link_ramp)
        self.bw = self.link.trace
        self.table = table
        self.pool = DecodePool(table) if (table and
                                          method.uses_decode_pool) else None
        self.chunk_tokens = chunk_tokens
        self.prefill_chunk = prefill_chunk
        self.fairness = fairness
        self.sched = FetchingAwareScheduler(
            method.scheduler_policy, max_running=max_running,
            fairness=fairness)
        self.ctrl = FetchController(
            self.sched, self.link, table=table, pool=self.pool,
            config=PipelineConfig(
                adaptive=method.adaptive,
                fixed_resolution=method.fixed_resolution,
                pipelined=method.pipelined,
                layerwise_admission=method.layerwise_admission,
                blocking_fetch=method.blocking_fetch,
                gpu_decomp_tokens_per_s=method.gpu_decomp_tokens_per_s,
                use_table_sizes=method.use_table_sizes,
                resolutions=method.resolutions,
                rto_mode=method.rto_mode,
                max_attempts=method.max_attempts),
            hooks=_SimHooks(self), prefetcher=prefetch)
        # scripted node churn, merged and time-ordered; heal transfers
        # (heal="link") schedule their completions on the controller's
        # event queue so they contend with live fetches
        assert not (fail_at or recover_at) or storage is not None, \
            "fail_at/recover_at need a storage cluster"
        self._churn: List[Tuple[float, str, str]] = sorted(
            [(t, "fail", nid) for t, nid in (fail_at or [])]
            + [(t, "recover", nid) for t, nid in (recover_at or [])])
        if storage is not None:
            storage.bind(self.ctrl.push_event)
            # completed fetches report their flow's smoothed RTT keyed
            # by serving node — drives RTT-aware replica/heal selection
            self.ctrl.rtt_sink = storage.observe_rtt
            # ...and which resolutions they actually delivered, steering
            # per-resolution eviction on the serving node
            self.ctrl.res_sink = storage.note_resolution_use
        self.prefetch = prefetch
        if prefetch is not None:
            assert storage is not None, "prefetch= needs a storage cluster"
            prefetch.bind(self.ctrl.push_event)
        # per-request engine progress
        self.prefill_remaining: Dict[int, int] = {}
        self.context_done: Dict[int, int] = {}

    # -- chunk size model ------------------------------------------------------
    def _chunk_bytes(self, n_tokens: int, res: str) -> float:
        """One chunk = one kind (K or V) x one 3-layer group x n_tokens."""
        if self.method.use_table_sizes and self.table is not None \
                and res in self.table.chunk_size_mb:
            return self.table.chunk_size_mb[res] * 1e6
        per_layer_kind = self.cfg.num_kv_heads * self.cfg.head_dim * 2
        raw = per_layer_kind * 3 * n_tokens
        key = res if res in self.method.ratios else "stream"
        return raw / self.method.ratios[key]

    def _build_plan(self, req: Request) -> FetchPlan:
        n_attn = sum(1 for k in self.cfg.layer_kinds() if k == "attn")
        return synthetic_plan(req.rid, req.reuse_tokens, n_attn,
                              self.chunk_tokens)

    # -- storage-tier fetch dispatch ---------------------------------------
    def _dispatch_fetch(self, req: Request, now: float) -> bool:
        """Start ``req``'s fetch; with a storage tier, resolve residency
        first.  A full hit fetches everything over the serving node's
        link; a partial hit fetches the resident *ancestor* (the tail is
        recomputed as extra suffix prefill); a miss re-queues the request
        as a plain full prefill.  Returns True on a miss (the caller must
        re-run admission — there is no fetch event to wait for)."""
        if self.storage is None:
            self.ctrl.start(req, self._build_plan(req), now)
            return False
        if self.prefetch is not None:
            staged = self.prefetch.host_lookup(req.prefix,
                                               req.reuse_tokens, now)
            if staged is not None:
                # host-first: a staged full hit rides the staging
                # tier's h2d link — the WAN is off the TTFT path
                req.storage_hit = "host"
                req.storage_node = "host"
                self.prefetch.observe(req.prefix, now)
                self.ctrl.start(req, self._build_plan(req), now,
                                link=self.prefetch.staging.link)
                return False
        hit = self.storage.lookup(req.prefix, now,
                                  requested_tokens=req.reuse_tokens)
        if self.prefetch is not None:
            self.prefetch.observe(req.prefix, now)
        req.storage_hit = hit.kind
        if hit.kind == "miss":
            req.storage_miss_key = hit.missed_key
            self.sched.notify_fetch_miss(req, now)
            return True
        req.storage_node = hit.node.node_id
        if hit.kind == "partial":
            req.requested_reuse_tokens = req.reuse_tokens
            req.reuse_tokens = hit.covered_tokens
        self.ctrl.start(req, self._build_plan(req), now,
                        link=hit.node.link,
                        resolutions=hit.resolutions,
                        served_key=hit.entry.key)
        return False

    # -- main loop ----------------------------------------------------------------
    def run(self, requests: List[Request], max_new_tokens: int = 32,
            horizon: float = 100_000.0) -> SimResult:
        arrivals = sorted(requests, key=lambda r: r.arrival)
        ai = 0
        now = 0.0
        for req in arrivals:
            self.prefill_remaining[req.rid] = req.prompt_len
            self.context_done[req.rid] = 0
        while now < horizon:
            # scripted node churn due by `now` (before arrivals, so a
            # request arriving at the failure instant sees the new ring)
            while self._churn and self._churn[0][0] <= now:
                t, kind, nid = self._churn.pop(0)
                if kind == "fail":
                    self.storage.fail_node(nid, t)
                else:
                    self.storage.recover_node(nid, t)
            # admit arrivals and process pipeline events up to `now`
            while ai < len(arrivals) and arrivals[ai].arrival <= now:
                r = arrivals[ai]
                if not self.method.reuse:
                    r.reuse_tokens = 0
                self.sched.submit(r, r.arrival)
                ai += 1
            self.ctrl.pump(now)
            admitted = self.sched.schedule(now)
            for req in admitted:
                if req.needs_fetch and self.method.reuse:
                    # reused prefix KV is restored: prefill the suffix only
                    self.prefill_remaining[req.rid] = max(
                        req.prompt_len - req.reuse_tokens, 0)
                    self.context_done[req.rid] = req.reuse_tokens
            missed = False
            for req in self.sched.take_fetches():
                missed |= self._dispatch_fetch(req, now)
            if self.prefetch is not None:
                # sglang-style tick: launch speculation for heated
                # prefixes (deferred while demand holds the link)
                self.prefetch.tick(now)
            if missed:
                # miss fallbacks re-entered the waiting queue with
                # reuse_tokens=0; admit them now (their full-prompt
                # prefill state was set at arrival and still stands)
                self.sched.schedule(now)
            # engine work for this iteration
            prefills = [r for r in self.sched.running
                        if self.prefill_remaining[r.rid] > 0]
            decodes = [r for r in self.sched.running
                       if self.prefill_remaining[r.rid] == 0
                       and r.tokens_out < max_new_tokens]
            step = 0.0
            if prefills:
                head = prefills[0]
                chunk = min(self.prefill_chunk,
                            max(self.prefill_remaining[head.rid], 1))
                step += self.cost.prefill_time(
                    chunk, ctx=self.context_done[head.rid])
                self.prefill_remaining[head.rid] -= chunk
                self.context_done[head.rid] += chunk
                if self.prefill_remaining[head.rid] <= 0:
                    self.prefill_remaining[head.rid] = 0
            if decodes:
                ctx = np.mean([r.prompt_len + r.tokens_out
                               for r in decodes])
                step += self.cost.decode_step_time(len(decodes), ctx)
            if step == 0.0:
                # idle: jump to the next event/arrival/churn instant
                nxt = []
                t_ev = self.ctrl.next_event_time()
                if t_ev is not None:
                    nxt.append(t_ev)
                if ai < len(arrivals):
                    nxt.append(arrivals[ai].arrival)
                if self._churn:
                    # churn fires at its scheduled instant even after
                    # the last arrival: an in-flight fetch must see the
                    # heal-flow contention, and recover_at entries must
                    # execute so the cluster's post-run state is honest
                    nxt.append(self._churn[0][0])
                if not nxt:
                    break
                now = max(now, min(nxt))
                continue
            # CacheGen-style contention while CUDA decompression is active
            decomp_active = any(f.gpu_decomp_until > now
                                for f in self.ctrl.active.values())
            if decomp_active:
                step *= (self.method.prefill_slowdown if prefills
                         else self.method.decode_slowdown)
            now += step
            tnow = now
            for req in prefills:
                if self.prefill_remaining[req.rid] == 0 \
                        and req.t_first_token is None:
                    req.t_first_token = tnow
                    req.tokens_out = 1
                    req.token_times.append(tnow)
                    if (req.storage_hit == "miss" and self.storage
                            and req.storage_miss_key):
                        # delayed write-on-miss: the recomputed KV
                        # exists from this instant, not from lookup time
                        self.storage.notify_recompute_done(
                            req.storage_miss_key, tnow)
            for req in decodes:
                if req.t_first_token is None:  # zero-suffix fetch request
                    req.t_first_token = tnow
                req.tokens_out += 1
                req.token_times.append(tnow)
                if req.tokens_out >= max_new_tokens:
                    self.sched.finish(req, tnow)
        util = (self.pool.stats.utilization(self.pool.n)
                if self.pool else 0.0)
        return SimResult(requests=arrivals,
                         decode_pool_utilization=util,
                         decompress_buffer_high_water=(
                             self.ctrl.buffer_high_water),
                         sim_time=now,
                         retransmits=self.ctrl.retransmits_total,
                         spurious_retransmits=(
                             self.ctrl.spurious_retransmits_total),
                         resolution_switches=(
                             self.ctrl.resolution_switches),
                         fairness_events=(
                             list(self.fairness.events)
                             if self.fairness is not None else []))
