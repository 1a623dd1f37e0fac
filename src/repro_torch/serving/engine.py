"""Live serving engine: real compute, real codec, real paged memory.

The JAX package's ``LiveEngine``: fetching-aware scheduling, fetches
whose chunks are decoded frame by frame on the host and restored into
the paged cache by the ``kv_restore`` kernel (one launch per fetched
chunk), suffix prefill over the restored prefix KV, and continuously
batched paged decode through the ``paged_attention`` kernel.  Fetching
runs through the event-driven `repro_torch.core.fetch_controller`.  Two
operating modes:

  * wall clock (default, ``bandwidth=None``): fetches complete
    synchronously at dispatch, timestamps are ``time.monotonic()``.
  * virtual clock (``bandwidth=`` a BandwidthTrace): network transmit
    and decode latencies are modeled on a virtual clock while the codec
    and paged-memory mechanics stay real.  ``fetch_mode="async"`` pumps
    the controller from ``step()`` so restoration overlaps compute and a
    request can start suffix prefill while later layer groups are still
    in flight (Appx A.3 early admission); ``fetch_mode="sync"`` drains
    the pipeline serially at dispatch, the pre-pipelining baseline.
    Compute advances the clock by the analytic ``EngineCostModel``
    (default: the ``h20`` chip), not by the card's own times.

In virtual-clock mode the network is the WAN model of
`repro_torch.cluster.network`: a ``SharedLink`` (``link_policy=``,
``link_ramp=``), a seeded ``loss=`` `LossModel` and adaptive-RTO
retransmission (``rto_mode=``); restoration stays bit-exact, only
timing moves.

The ``store`` may be a flat `KVStore` or a multi-node `StorageCluster`
(`repro_torch.cluster.storage`): with a cluster, every fetch resolves
through a longest-prefix match over the prompt tokens (full hit,
partial hit on an ancestor whose tail becomes suffix prefill, or a miss
that falls back to a plain prefill) and transmits over the serving
node's own link.  ``fail_node``/``recover_node`` churn the cluster
mid-serve, and a missed prefix is written back once its fallback
prefill produced the first token (``notify_recompute_done``).
``prefetch=`` (a `repro_torch.cluster.staging.PrefetchManager`) stages
predicted prefixes in host memory and resolves demand fetches
host-first; ``fairness=`` (a `repro_torch.cluster.fairness.
FairScheduler`) orders fetch dispatch by per-user virtual counters.

``external_dispatch=True`` hands fetch dispatch to a fleet
(`repro_torch.cluster.fleet.LiveFleet`): ``step()`` no longer takes
fetches itself, and the fleet calls ``dispatch_fetch`` for a fetch over
the storage tier or ``local_restore`` for a prefix the serving node
already holds.

``mesh=`` (a ``DeviceMesh``, `repro_torch.launch.mesh`) lays the paged
cache out over the mesh by the logical-axis rules (kv heads on the
"model" axis), and ``mesh_shards=`` (default: the mesh's "model" size)
splits each virtual-clock fetch plan by layer group into per-shard
subplans, each its own flow through the one controller under a shadow
request id; the real request completes once, when its last shard lands.

The constructor takes every knob of the JAX engine so the two stay
interchangeable.  Where the JAX engine asserts, this one raises
``ValueError`` with the same message.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cluster.costmodel import CHIPS, EngineCostModel
from repro_torch.cluster.decodepool import DecodePool
from repro_torch.cluster.network import LossModel, make_link
from repro_torch.cluster.storage import KVStore, StorageCluster
from repro_torch.configs.base import ModelConfig
from repro_torch.core.adaptive import DecodeTable
from repro_torch.core.chunks import KVManifest
from repro_torch.core.codec import KVCodec
from repro_torch.core.fetch import (FetchPlan, PlannedChunk, build_plan,
                                    sharded_layers_ready, split_plan_shards)
from repro_torch.core.fetch_controller import (ActiveFetch, FetchController,
                                               FetchHooks, PipelineConfig)
from repro_torch.core.layout import IntraLayout
from repro_torch.core.scheduler import (FetchingAwareScheduler, ReqState,
                                        Request)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dense_3xtf32 import ops as dense
from repro_torch.paged.cache import PagedKVCache
from repro_torch.serving import paged_model, tracing
from repro_torch.sharding import rules

# Shadow rids for mesh-sharded fetches live far above any real rid so
# the per-shard controller flows can never collide with request flows.
_SHADOW_RID_BASE = 10_000_000


@dataclasses.dataclass
class EngineStats:
    restore_buffer_high_water: int = 0
    restored_tokens: int = 0
    fetched_bytes: int = 0
    steps: int = 0
    prefill_stall_time: float = 0.0  # virtual time spent waiting for KV


class _EngineHooks(FetchHooks):
    """Real codec restoration driven by the controller's restore events."""

    def __init__(self, engine: "LiveEngine"):
        self.engine = engine

    def restore_seconds(self, fetch: ActiveFetch, pc: PlannedChunk) -> float:
        return 0.002  # frame-wise restoration cost (matches the simulator)

    def on_restored(self, fetch: ActiveFetch, pc: PlannedChunk,
                    now: float) -> None:
        self.engine._restore_chunk(fetch.req, fetch.plan, pc)

    def comp_times(self, req: Request):
        eng = self.engine
        if eng.cost is None:
            return None
        suffix = max(req.prompt_len - req.reuse_tokens, 1)
        return eng.cost.layer_comp_times(suffix)


class LiveEngine:
    """Single-node engine over a dense model (real compute)."""

    def __init__(self, params, cfg: ModelConfig, store, *,
                 n_pages: int = 256, page_size: int = 16,
                 policy: str = "kvfetcher", max_running: int = 4,
                 resolution: str = "240p",
                 fetch_mode: str = "sync",
                 bandwidth=None,
                 loss: Optional[LossModel] = None,
                 link_policy: Optional[str] = None,  # None -> "fair"
                 link_ramp: Optional[str] = None,  # None -> "instant"
                 rto_mode: str = "adaptive",  # or "fixed" (baseline)
                 use_table_sizes: bool = False,  # model Appx A.2 sizes
                 # ABR selection: None keeps the legacy rule (adaptive
                 # iff a decode table is given); False pins
                 # ``resolution`` even with a table
                 adaptive: Optional[bool] = None,
                 # ladder the selector may pick from (None = the full
                 # RESOLUTION_ORDER)
                 resolutions: Optional[Tuple[str, ...]] = None,
                 decode_table: Optional[DecodeTable] = None,
                 cost: Optional[EngineCostModel] = None,
                 prefetch=None,
                 fairness=None,
                 external_dispatch: bool = False,
                 # streaming client view: called as on_token(req, token,
                 # t) the moment each token exists, first token inside
                 # prefill, then once per decode step
                 on_token: Optional[Callable[[Request, int, float],
                                             None]] = None,
                 mesh=None, mesh_shards: Optional[int] = None,
                 device: DeviceLike = None,
                 # where the engine's spans go (None: tracing.TRACER,
                 # the process's)
                 tracer: Optional[tracing.Tracer] = None):
        if not isinstance(store, (KVStore, StorageCluster)):
            raise TypeError(
                f"LiveEngine store {type(store).__module__}."
                f"{type(store).__name__}: the port serves its own KVStore "
                f"or StorageCluster (repro_torch.cluster.storage)")
        if fetch_mode not in ("sync", "async"):
            raise ValueError(f"fetch_mode {fetch_mode!r}: 'sync' or 'async'")
        if prefetch is not None and not isinstance(store, StorageCluster):
            raise ValueError("prefetch= needs a multi-node StorageCluster "
                             "store")
        self.virtual = bandwidth is not None
        if not self.virtual and (fetch_mode != "sync" or loss is not None
                                 or link_policy is not None
                                 or link_ramp is not None):
            raise ValueError(
                "WAN options (async fetch, loss=, link_policy=, link_ramp=) "
                "need a bandwidth trace (virtual clock)")
        if isinstance(store, StorageCluster) and (
                loss is not None or link_policy is not None
                or link_ramp is not None) and any(
                    n.link is not None for n in store.nodes):
            raise ValueError(
                "loss=/link_policy=/link_ramp= only shape the default "
                "link; nodes with their own links must carry their own "
                "LossModel/policy/ramp: StorageNode(link=make_link("
                "trace, policy=, loss=, ramp=))")
        if not self.virtual and prefetch is not None \
                and prefetch.transport != "sync":
            # wall clock has no event queue to stream speculation on
            raise ValueError(
                "wall-clock engines need PrefetchManager(transport='sync')")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.store = store
        self.prefetch = prefetch
        self.cache = PagedKVCache(cfg, n_pages, page_size,
                                  device=self.device)
        # mesh sharding: the pages lay out over the mesh's "model" axis
        # (kv heads); fetch plans split into per-shard subplans so each
        # shard restores its slice as its own flow
        self.n_shards = 1
        if mesh is not None or mesh_shards is not None:
            self.n_shards = int(mesh_shards) if mesh_shards is not None \
                else rules.mesh_sizes(mesh).get("model", 1)
            if self.n_shards < 1:
                raise ValueError(f"mesh_shards {self.n_shards}: at least 1")
            if mesh is not None:
                self._shard_cache(mesh)
        #: rid -> (req, shard subplans) for fetches in sharded flight
        self._sharded: Dict[int, Tuple[Request, List[FetchPlan]]] = {}
        #: shadow rid -> real request (restore callbacks remap through it)
        self._shadow_real: Dict[int, Request] = {}
        self.fairness = fairness
        self.sched = FetchingAwareScheduler(policy, max_running=max_running,
                                            fairness=fairness)
        self.resolution = resolution
        self.fetch_mode = fetch_mode
        self.external_dispatch = external_dispatch
        self.stats = EngineStats()
        self.tracer = tracing.TRACER if tracer is None else tracer
        self.prompts: Dict[int, np.ndarray] = {}
        self.outputs: Dict[int, List[int]] = {}
        self.finished: List[Request] = []
        self._clock = 0.0
        self.on_token = on_token
        self.cost = cost
        self.ctrl: Optional[FetchController] = None
        self._fetch_scales: Dict[int, Dict[str, torch.Tensor]] = {}
        if self.virtual:
            if self.cost is None:
                self.cost = EngineCostModel(cfg, CHIPS["h20"], 1)
            pool = DecodePool(decode_table) if decode_table else None
            # concurrent fetches contend for one WAN link (fair or DRR
            # split, optionally slow-start ramped) and survive seeded
            # chunk loss via adaptive-RTO retransmission
            link = make_link(bandwidth, policy=link_policy, loss=loss,
                             ramp=link_ramp)
            pipe_kw = {}
            if resolutions is not None:
                pipe_kw["resolutions"] = tuple(resolutions)
            self.ctrl = FetchController(
                self.sched, link, table=decode_table, pool=pool,
                config=PipelineConfig(
                    adaptive=(decode_table is not None if adaptive is None
                              else adaptive),
                    fixed_resolution=resolution,
                    pipelined=fetch_mode == "async",
                    layerwise_admission=(fetch_mode == "async"
                                         and policy == "kvfetcher"),
                    use_table_sizes=use_table_sizes,
                    rto_mode=rto_mode, **pipe_kw),
                hooks=_EngineHooks(self), prefetcher=prefetch)
            if isinstance(store, StorageCluster):
                # heal="link" re-replication transfers share the
                # controller's virtual clock and the nodes' links
                store.bind(self.ctrl.push_event)
                self.ctrl.rtt_sink = store.observe_rtt
                # per-resolution usage feedback for rung-level eviction
                self.ctrl.res_sink = store.note_resolution_use
            if prefetch is not None:
                prefetch.bind(self.ctrl.push_event)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on the card through pinned
        memory and an asynchronous copy."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- time: virtual clock in modeled-network mode, else wall clock -------
    def now(self) -> float:
        # wall-clock mode stamps real times (fetches complete synchronously
        # at dispatch); every replayed event log comes from virtual-clock
        # mode, where this branch never runs
        return self._clock if self.virtual \
            else time.monotonic()  # repro-lint: allow(no-wall-clock)

    # -- mesh-sharded paged cache --------------------------------------------
    def _shard_cache(self, mesh) -> None:
        """Lay the paged KV out over ``mesh``: kv heads shard on the
        "model" axis (DEFAULT_RULES), everything else replicates.
        Non-divisible dims fall back to replication."""
        with rules.activate(mesh):
            placements = rules.placements(
                ("layers", None, None, "kv_heads", None),
                self.cache.k_pages.shape, mesh=mesh)
        self.cache.shard(mesh, placements)

    # -- storage-node churn ---------------------------------------------------
    def fail_node(self, node_id: str) -> None:
        """Kill one storage node at the engine's current clock: its keys
        re-route to ring successors and the cluster's heal queue
        restores the replication factor.  Later lookups for prefixes it
        alone held miss and fall back to a plain prefill until healed."""
        self._cluster("fail_node").fail_node(node_id, self.now())

    def recover_node(self, node_id: str) -> None:
        self._cluster("recover_node").recover_node(node_id, self.now())

    def _cluster(self, what: str) -> StorageCluster:
        if not isinstance(self.store, StorageCluster):
            raise ValueError(f"{what} needs a multi-node StorageCluster "
                             f"store")
        return self.store

    # -- intake -------------------------------------------------------------
    def submit(self, tokens: np.ndarray, reuse_prefix: Optional[str] = None,
               reuse_tokens: int = 0, max_new_tokens: int = 8,
               user: Optional[str] = None,
               slo_tier: Optional[str] = None,
               rid: Optional[int] = None) -> Request:
        rid = len(self.prompts) if rid is None else int(rid)
        if rid in self.prompts:
            raise ValueError(f"rid {rid} already submitted")
        req = Request(rid=rid, arrival=self.now(), prompt_len=len(tokens),
                      max_new_tokens=max_new_tokens,
                      reuse_tokens=reuse_tokens, prefix=reuse_prefix,
                      user=user, slo_tier=slo_tier)
        self.prompts[rid] = np.asarray(tokens)
        self.outputs[rid] = []
        self.sched.submit(req, req.arrival)
        return req

    # -- fetch dispatch -------------------------------------------------------
    def dispatch_fetch(self, req: Request) -> None:
        """External-dispatch entry point: a fleet drained the shared
        fair backlog and placed ``req`` here; start its fetch and run
        admission again, as ``step()`` does when it owns dispatch."""
        self._start_fetch(req)
        self.sched.schedule(self.now())

    def local_restore(self, req: Request) -> None:
        """Serve ``req`` from this serving node's own resident KV: a
        real restore from the cataloged manifest (one ``kv_restore``
        launch per chunk) at zero virtual network time, since the bytes
        never cross the wire.  Fairness sees the same 0-byte "fetched"
        event the simulator logs for a local hit."""
        if not isinstance(self.store, StorageCluster) or not req.prefix:
            raise ValueError("local_restore needs a multi-node "
                             "StorageCluster store and a prefix key")
        entry = self.store.catalog[req.prefix]
        self._run_fetch_wall(req, self._prepare_restore(req,
                                                        entry.manifest))
        # every chunk is restored: the scales are not read again
        self._fetch_scales.pop(req.rid, None)

    def _prepare_restore(self, req: Request,
                         man: KVManifest) -> FetchPlan:
        """The plan of restoring ``man`` for ``req``, with what its
        chunks' restores read: the sequence's rows, the staging buffer
        sized to the largest chunk, and each kind's scales on the
        device."""
        plan = build_plan(req.rid, man)
        self.cache.add_seq(req.rid, req.prompt_len + req.max_new_tokens)
        self.cache.reserve_staging(
            max(len(r.layers) for r in man.refs),
            max(r.token_end - r.token_start for r in man.refs))
        # each kind's [L, K] scales reach the device once per fetch
        self._fetch_scales[req.rid] = {
            kind: self._upload(sc) for kind, sc in man.scales.items()}
        return plan

    def _start_fetch(self, req: Request) -> None:
        """Resolve the request's prefix against the store and start its
        fetch: at once on the wall clock, else through the controller.
        Against a `StorageCluster` the resolution is host-first (a copy
        the prefetcher staged), then a longest-prefix match over the
        prompt tokens: a **full** hit fetches the whole ask, a
        **partial** hit fetches the resident ancestor's manifest (the
        tail becomes suffix prefill), and a **miss** falls back to a
        plain prefill; fetches route over the serving node's own
        link."""
        link = res_avail = served_key = None
        if isinstance(self.store, StorageCluster):
            tokens = self.prompts[req.rid][:req.reuse_tokens]
            staged = (self.prefetch.host_lookup_tokens(tokens, self.now())
                      if self.prefetch is not None else None)
            if staged is not None:
                # host-first: the staged copy serves from host memory
                # over the staging tier's h2d link, off the WAN
                req.storage_hit = "host"
                req.storage_node = "host"
                req.prefix = staged.key
                self.prefetch.observe(staged.key, self.now())
                man = staged.manifest
                link = self.prefetch.staging.link
            else:
                hit = self.store.lookup_tokens(tokens, self.now())
                if self.prefetch is not None:
                    self.prefetch.observe(
                        hit.entry.key if hit.entry is not None
                        else hit.missed_key, self.now())
                req.storage_hit = hit.kind
                if hit.kind == "miss":
                    req.storage_miss_key = hit.missed_key
                    self.sched.notify_fetch_miss(req, self.now())
                    return
                req.storage_node = hit.node.node_id
                if hit.kind == "partial":
                    req.requested_reuse_tokens = req.reuse_tokens
                    req.reuse_tokens = hit.covered_tokens
                    req.prefix = hit.entry.key  # fetch the ancestor
                man = hit.entry.manifest
                link = hit.node.link
                res_avail = hit.resolutions
                served_key = hit.entry.key
        else:
            man = self.store.lookup(req.prefix)
        if man is None:
            raise KeyError(f"prefix {req.prefix} not registered")
        plan = self._prepare_restore(req, man)
        if self.ctrl is None:
            self._run_fetch_wall(req, plan)
            return
        if self.n_shards > 1:
            self._start_sharded(req, plan, link=link, resolutions=res_avail,
                                served_key=served_key)
            return
        self.ctrl.start(req, plan, self.now(), link=link,
                        resolutions=res_avail, served_key=served_key)
        if self.fetch_mode == "sync":
            # blocking baseline: the engine idles until the (serialized)
            # pipeline finishes; the virtual clock absorbs the whole fetch
            self._clock = max(self._clock, self.ctrl.drain(plan))

    # -- mesh-sharded fetch: per-shard plans as independent flows -------------
    def _start_sharded(self, req: Request, plan: FetchPlan, *,
                       link=None, resolutions=None,
                       served_key=None) -> None:
        """Split the plan by layer-group shard and run every shard's
        fetch/decode/restore stream as its own flow through the ONE
        controller event loop: shards contend on the link like per-device
        DMA streams would, and the request is admitted when
        `sharded_layers_ready` over the subplans says its contiguous
        layer prefix landed.  Each shard fetches under a *shadow* of the
        request (fresh rid, state=WAITING) so the controller's per-shard
        completion bookkeeping (fairness charge, scheduler notify, early
        admission) all no-op; the REAL request completes exactly once, in
        `_check_sharded`, when the last shard drains."""
        subplans = split_plan_shards(plan, self.n_shards)
        self._sharded[req.rid] = (req, subplans)
        req.fetch_started = self.now()
        for s, sp in enumerate(subplans):
            shadow = dataclasses.replace(
                req, rid=_SHADOW_RID_BASE + req.rid * 64 + s,
                token_times=[])
            # replace() copied WAITING_FOR_KV; shadows must stay inert
            # for the scheduler (see notify_fetch_done / early admit)
            shadow.state = ReqState.WAITING
            self._shadow_real[shadow.rid] = req
            sp.rid = shadow.rid
            self.ctrl.start(shadow, sp, self.now(), link=link,
                            resolutions=resolutions,
                            served_key=served_key)
        if self.fetch_mode == "sync":
            t = self._clock
            for sp in subplans:
                t = max(t, self.ctrl.drain(sp))
            self._clock = t
            self._check_sharded()

    def _check_sharded(self) -> None:
        """Aggregate per-shard progress into each real request: update
        its ready-layer prefix and fire the single completion (or miss)
        when every shard lands (or any aborts)."""
        for rid in list(self._sharded):
            req, subplans = self._sharded[rid]
            req.layers_ready = sharded_layers_ready(subplans)
            if any(sp.aborted for sp in subplans):
                del self._sharded[rid]
                self.sched.notify_fetch_miss(req, self.now())
            elif all(sp.done for sp in subplans):
                del self._sharded[rid]
                if self.fairness is not None:
                    nbytes = float(sum(
                        pc.sizes.get(pc.resolution or self.resolution, 0)
                        for sp in subplans for pc in sp.chunks))
                    self.fairness.on_fetch_done(req, nbytes)
                self.sched.notify_fetch_done(req, self.now())

    def _run_fetch_wall(self, req: Request, plan: FetchPlan) -> None:
        """Fetch synchronously, stamping real timestamps (no network
        model)."""
        with self.tracer.span("fetch", req.rid):
            req.fetch_started = self.now()
            for pc in plan.chunks:
                pc.resolution = self.resolution
                pc.t_transmit_start = pc.t_transmit_done = self.now()
                self._restore_chunk(req, plan, pc)
                pc.t_decode_done = pc.t_restored = self.now()
            req.layers_ready = plan.layers_ready()
            self.sched.notify_fetch_done(req, self.now())

    # -- chunk-wise restoration (real codec + paged scatter) -----------------
    def _restore_chunk(self, req: Request, plan: FetchPlan,
                       pc: PlannedChunk) -> None:
        """Decode one fetched chunk frame by frame into a layer-major
        staging buffer (its rANS streams in one ``rans_decode`` launch on
        the card, on the host on the CPU; reconstruction on the host), then
        restore it into every layer of its group with one upload and one
        ``kv_restore_layers`` launch.  The pages are read only after the
        chunk's restore event, so this is observably the frame-wise restore
        of the JAX engine."""
        # sharded fetches restore under shadow requests; the pages and
        # the scales belong to the real rid
        req = self._shadow_real.get(req.rid, req)
        man = plan.manifest
        ref = pc.ref
        res = pc.resolution or self.resolution
        blob = man.blobs[(ref.chunk_id, res)]
        self.stats.fetched_bytes += len(blob)
        lay = IntraLayout(self.cfg.num_kv_heads, self.cfg.head_dim,
                          *man.layout)
        codec = KVCodec(self.cfg.num_kv_heads, self.cfg.head_dim, lay)
        G, n = len(ref.layers), ref.token_end - ref.token_start
        staged = self.cache.staging_buffer(G, n)
        q = staged.numpy()
        token_ids = np.empty(n, np.int64)
        off = 0
        rans_before = codec.rans_s
        with self.tracer.span("codec decode", req.rid) as span:
            for toks, qt in codec.iter_decode_frames(blob, self.device):
                # residual + reference frame, and on the card the chunk's
                # symbols decoded ahead of the frames
                buf = qt.nbytes * 2 + codec.held_bytes
                self.stats.restore_buffer_high_water = max(
                    self.stats.restore_buffer_high_water, buf)
                k = len(toks)
                q[:, off:off + k] = qt.swapaxes(0, 1)
                token_ids[off:off + k] = toks + ref.token_start
                off += k
                self.stats.restored_tokens += k
            span.counts["rans_s"] = codec.rans_s - rans_before
        if off != n:
            raise ValueError(f"chunk {ref.chunk_id}: decoded {off} tokens, "
                             f"its manifest entry holds {n}")
        l0 = ref.layers[0]
        if tuple(ref.layers) != tuple(range(l0, l0 + G)):
            raise ValueError(f"chunk {ref.chunk_id}: layers {ref.layers} "
                             f"are not one contiguous group")
        scales = self._fetch_scales[req.rid][ref.kind][l0:l0 + G]
        with self.tracer.span("restore", req.rid, tokens=n):
            self.cache.restore_chunk(ref.kind, req.rid, ref.layers,
                                     token_ids, staged, scales)

    # -- prefill -------------------------------------------------------------
    def _prefill(self, req: Request) -> None:
        tokens = self.prompts[req.rid]
        kind, n = (("suffix prefill", len(tokens) - req.reuse_tokens)
                   if req.needs_fetch else ("plain prefill", len(tokens)))
        with self.tracer.span(kind, req.rid, tokens=n) as span, \
                dense.counted(span):
            total = len(tokens) + req.max_new_tokens
            if req.rid not in self.cache.seqs:
                self.cache.add_seq(req.rid, total)
            else:
                self.cache.ensure_capacity(req.rid, total)
            if req.needs_fetch:
                logits = self._suffix_prefill(req, tokens)
            else:
                logits, kvs = paged_model.prefill_collect_kv(
                    self.params, self.cfg,
                    torch.as_tensor(tokens[None], dtype=torch.long,
                                    device=self.device))
                for layer, (k, v) in enumerate(kvs):
                    self.cache.write_prefill(layer, req.rid, k[0], v[0])
                logits = logits[0]
                if self.virtual:
                    self._clock += self.cost.prefill_time(len(tokens))
            info = self.cache.seqs[req.rid]
            info.context_len = len(tokens)
            # the first token, with the step's deferred span counts
            nxt = self.tracer.read_back(torch.argmax(logits))[0]
            self.outputs[req.rid].append(nxt)
            req.tokens_out = 1
            req.t_first_token = self.now()
            if not self.virtual:
                span.t1 = req.t_first_token  # the span ends at the stamp
        req.token_times.append(req.t_first_token)
        if self.on_token is not None:
            self.on_token(req, nxt, req.t_first_token)
        if (req.storage_hit == "miss" and req.storage_miss_key
                and isinstance(self.store, StorageCluster)):
            # delayed write-on-miss: only now does the recomputed KV
            # exist for the donor to upload again
            self.store.notify_recompute_done(req.storage_miss_key,
                                             req.t_first_token)

    def _await_layer(self, req: Request, layer: int) -> None:
        """Async mode: block (on the virtual clock) until ``layer``'s
        prefix KV is restored; pipeline stalls are accounted as stall
        time, zero whenever the Appx A.3 condition held at admission."""
        if self.ctrl is None:
            return
        while req.fetch_done is None and req.layers_ready <= layer:
            t = self.ctrl.pump_next()
            self._check_sharded()
            if t is None:
                if req.fetch_done is not None or req.layers_ready > layer:
                    break
                raise RuntimeError(
                    f"rid={req.rid}: layer {layer} KV never arrived")
            if t > self._clock:
                self.stats.prefill_stall_time += t - self._clock
                self._clock = t

    def _suffix_prefill(self, req: Request,
                        tokens: np.ndarray) -> torch.Tensor:
        """Prefill only the non-reused suffix over the restored prefix KV
        (``paged_model.prefill_over_pages``): layer k waits for layer k's
        restore event only (layer-wise pipeline)."""
        n_pre = req.reuse_tokens
        comp = (self.cost.layer_comp_times(len(tokens) - n_pre)
                if self.virtual else [0.0] * self.cfg.num_layers)

        def before_layer(i: int) -> None:  # layer i - 1's compute, then wait
            if i:
                self._clock += comp[i - 1]
            self._await_layer(req, i)

        logits = paged_model.prefill_over_pages(
            self.params, self.cfg, torch.as_tensor(
                tokens[None, n_pre:], dtype=torch.long, device=self.device),
            n_pre, self.cache, req.rid, before_layer)
        self._clock += comp[-1]
        return logits[0]

    # -- main loop ------------------------------------------------------------
    def step(self) -> bool:
        """One engine iteration. Returns False when idle and done."""
        if self.ctrl is not None:
            self.ctrl.pump(self.now())
            self._check_sharded()
        self.sched.schedule(self.now())
        if not self.external_dispatch:
            for req in self.sched.take_fetches():
                self._start_fetch(req)
                self.sched.schedule(self.now())
        if self.prefetch is not None:
            # sglang-style tick: launch speculation for heated prefixes
            # (deferred while demand fetches hold the source link)
            self.prefetch.tick(self.now())
        # newly admitted requests need prefill
        for req in list(self.sched.running):
            if req.t_first_token is None:
                self._prefill(req)
        # one decode step for every running sequence (continuous batching)
        active = [r for r in self.sched.running
                  if r.tokens_out < r.max_new_tokens]
        if active:
            seq_ids = [r.rid for r in active]
            toks = torch.as_tensor([self.outputs[r.rid][-1] for r in active],
                                   dtype=torch.long)
            positions = torch.as_tensor(
                [len(self.prompts[r.rid]) + r.tokens_out - 1
                 for r in active], dtype=torch.int32)
            with self.tracer.span("decode step") as span, \
                    dense.counted(span):
                logits = paged_model.decode_paged(
                    self.params, self.cfg, toks, positions, self.cache,
                    seq_ids)
                nxt = self.tracer.read_back(torch.argmax(logits, dim=-1))
            if self.virtual:
                ctx = float(np.mean([len(self.prompts[r.rid]) + r.tokens_out
                                     for r in active]))
                self._clock += self.cost.decode_step_time(len(active), ctx)
            tnow = self.now()
            for i, req in enumerate(active):
                self.outputs[req.rid].append(int(nxt[i]))
                req.tokens_out += 1
                req.token_times.append(tnow)
                if self.on_token is not None:
                    self.on_token(req, int(nxt[i]), tnow)
        for req in list(self.sched.running):
            if req.tokens_out >= req.max_new_tokens:
                self.sched.finish(req, self.now())
                self.cache.free_seq(req.rid)
                self._fetch_scales.pop(req.rid, None)
                self.finished.append(req)
        # engine idle but fetches in flight: jump the virtual clock to the
        # next pipeline event so waiting requests make progress
        if self.ctrl is not None and not self.sched.running and not active:
            t = self.ctrl.next_event_time()
            if t is not None:
                self._clock = max(self._clock, t)
                self.ctrl.pump(self._clock)
                self._check_sharded()
                self.sched.schedule(self._clock)
        self.stats.steps += 1
        return bool(self.sched.running or self.sched.waiting
                    or self.sched.waiting_for_kv)

    def run(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.step():
                break
