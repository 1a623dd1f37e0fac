"""Fetch plans: the per-request chunk schedule the fetch controller walks.

Chunks are ordered layer-group-major (all token-chunks of layer group 0,
then group 1, ...), interleaving K and V of the same group, so layers
become ready front-to-back — exactly what the layer-wise
fetching-inference pipeline (Appx A.3) needs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.chunks import ChunkRef, KVManifest, layer_groups_of


@dataclasses.dataclass
class PlannedChunk:
    ref: ChunkRef
    sizes: Dict[str, int]  # resolution -> bytes
    resolution: Optional[str] = None  # chosen at fetch time (Alg. 1)
    # t_transmit_start is the FIRST attempt's start; with WAN loss the
    # chunk may be resent (attempts > 1) before t_transmit_done lands.
    attempts: int = 0
    t_transmit_start: Optional[float] = None
    t_transmit_done: Optional[float] = None
    t_decode_done: Optional[float] = None
    t_restored: Optional[float] = None


@dataclasses.dataclass
class FetchPlan:
    rid: int
    manifest: Optional[KVManifest]  # None for synthetic (simulator) plans
    chunks: List[PlannedChunk]
    n_layers_total: int
    next_to_send: int = 0
    # Set when the controller abandons the fetch (a chunk exhausted
    # max_attempts with every copy lost); the request falls back to a
    # full prefill via notify_fetch_miss and the plan never completes.
    aborted: bool = False

    def layers_ready(self) -> int:
        """Contiguous prefix of layers whose K and V are fully restored."""
        done_groups = 0
        per_group: Dict[int, List[bool]] = {}
        for pc in self.chunks:
            per_group.setdefault(pc.ref.group, []).append(
                pc.t_restored is not None)
        ready = 0
        groups = sorted(per_group)
        for g in groups:
            if all(per_group[g]):
                first = next(pc.ref.layers
                             for pc in self.chunks if pc.ref.group == g)
                ready += len(first)
            else:
                break
        return ready

    @property
    def done(self) -> bool:
        return all(pc.t_restored is not None for pc in self.chunks)


def build_plan(rid: int, manifest: KVManifest) -> FetchPlan:
    by_key: Dict[Tuple[int, int, str], ChunkRef] = {}
    for ref in manifest.refs:
        by_key[(ref.group, ref.chunk, ref.kind)] = ref
    ordered: List[PlannedChunk] = []
    groups = sorted({r.group for r in manifest.refs})
    chunks = sorted({r.chunk for r in manifest.refs})
    for g in groups:
        for c in chunks:
            for kind in ("k", "v"):
                ref = by_key.get((g, c, kind))
                if ref is None:
                    continue
                sizes = {res: len(manifest.blobs[(ref.chunk_id, res)])
                         for res in manifest.resolutions}
                ordered.append(PlannedChunk(ref=ref, sizes=sizes))
    n_layers = sum(len(g) for g in manifest.layer_groups)
    return FetchPlan(rid=rid, manifest=manifest, chunks=ordered,
                     n_layers_total=n_layers)


def split_plan_shards(plan: FetchPlan, n_shards: int) -> List[FetchPlan]:
    """Partition ``plan`` into per-shard subplans by layer group
    (``ref.group % n_shards``) for a mesh-sharded paged cache: each
    shard's fetch/decode/restore stream runs as its own flow through the
    one FetchController event loop.  The `PlannedChunk` objects are
    SHARED with the parent plan (not copied), so restore timestamps
    recorded by a shard are visible to `sharded_layers_ready` and to the
    parent plan's own ``layers_ready``/``done``.  Empty shards (more
    shards than layer groups) are dropped."""
    assert n_shards >= 1
    subs: List[FetchPlan] = []
    for s in range(n_shards):
        chunks = [pc for pc in plan.chunks if pc.ref.group % n_shards == s]
        if chunks:
            subs.append(FetchPlan(rid=plan.rid, manifest=plan.manifest,
                                  chunks=chunks,
                                  n_layers_total=plan.n_layers_total))
    return subs


def sharded_layers_ready(plans: List[FetchPlan]) -> int:
    """Contiguous ready-layer prefix across shard subplans: the union of
    their chunks is exactly the parent plan's chunk set, so this is the
    aggregate the engine gates admission on while shards restore
    independently."""
    merged = FetchPlan(
        rid=plans[0].rid if plans else -1, manifest=None,
        chunks=[pc for sp in plans for pc in sp.chunks],
        n_layers_total=plans[0].n_layers_total if plans else 0)
    return merged.layers_ready()


def synthetic_plan(rid: int, reuse_tokens: int, n_attn_layers: int,
                   tokens_per_chunk: int) -> FetchPlan:
    """Plan without a real manifest: chunk geometry only (byte sizes come
    from the controller's hooks).  Used by the cluster simulator and by
    controller unit tests."""
    groups = layer_groups_of(max(n_attn_layers, 1))
    per_group = max(1, -(-reuse_tokens // tokens_per_chunk))
    chunks: List[PlannedChunk] = []
    for g, layers in enumerate(groups):
        for c in range(per_group):
            t0 = c * tokens_per_chunk
            t1 = max(t0 + 1, min(reuse_tokens, t0 + tokens_per_chunk))
            for kind in ("k", "v"):
                chunks.append(PlannedChunk(
                    ref=ChunkRef(kind, g, c, t0, t1, tuple(layers)),
                    sizes={}))
    return FetchPlan(rid=rid, manifest=None, chunks=chunks,
                     n_layers_total=sum(len(g) for g in groups))
