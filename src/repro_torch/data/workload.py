"""Workload generation: Poisson request traces with long-context prompts
and a reuse threshold (paper §5.2: rate 0.2 req/s, >=40K-token prompts
reuse remote KV), shared-prefix corpora for the live engine, the
Zipf-over-a-prefix-trie popularity workload the storage-tier benchmarks
drive, and seeded node-churn schedules for the failover scenarios
(docs/storage_tier.md)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler import Request


def poisson_trace(rng: np.random.Generator, *, n_requests: int = 20,
                  rate: float = 0.2,
                  prompt_lens: Sequence[int] = (20_000, 200_000),
                  reuse_threshold: int = 40_000,
                  suffix_tokens: int = 1_000,
                  max_new_tokens: int = 32) -> List[Request]:
    t = 0.0
    out: List[Request] = []
    for rid in range(n_requests):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        reuse = plen - suffix_tokens if plen >= reuse_threshold else 0
        out.append(Request(rid=rid, arrival=t, prompt_len=plen,
                           reuse_tokens=max(reuse, 0),
                           prefix=f"pfx{rid}" if reuse else None,
                           max_new_tokens=max_new_tokens))
    return out


def fixed_context_trace(context_len: int, *, n_requests: int = 4,
                        gap: float = 30.0, suffix_tokens: int = 1_000,
                        max_new_tokens: int = 32) -> List[Request]:
    """Back-to-back fetching requests of one context length (Fig. 18/21)."""
    return [Request(rid=i, arrival=i * gap, prompt_len=context_len,
                    reuse_tokens=context_len - suffix_tokens,
                    prefix=f"pfx{i}", max_new_tokens=max_new_tokens)
            for i in range(n_requests)]


def wan_burst_trace(rng: np.random.Generator, context_len: int, *,
                    n_requests: int = 4, window: float = 2.0,
                    suffix_tokens: int = 1_000,
                    weights: Optional[Sequence[float]] = None,
                    max_new_tokens: int = 32) -> List[Request]:
    """A burst of fetching requests whose arrivals land (seeded-uniform,
    sorted) inside one short ``window`` — the adaptive-transport stress
    shape: flows join a contended link at staggered instants, so fair
    shares (and, with ``ramp="slowstart"``, ramp factors) shift while
    chunks are mid-flight.  Optional per-request link ``weights`` drive
    weighted-fair / DRR arbitration.  Deterministic for a given rng."""
    arrivals = np.sort(rng.uniform(0.0, window, n_requests))
    return [Request(rid=i, arrival=float(arrivals[i]),
                    prompt_len=context_len,
                    reuse_tokens=context_len - suffix_tokens,
                    prefix=f"pfx{i}", max_new_tokens=max_new_tokens,
                    weight=(float(weights[i]) if weights is not None
                            else 1.0))
            for i in range(n_requests)]


@dataclasses.dataclass(frozen=True)
class PrefixSpec:
    """One node of the reusable-prefix trie: a registered prefix of
    ``n_tokens`` tokens whose longest registered ancestor is ``parent``
    (None for roots).  Children extend their parent's token sequence, so
    a stored parent is a valid *partial* hit for a child's ask."""
    key: str
    n_tokens: int
    parent: Optional[str] = None


def prefix_trie_specs(n_roots: int, depth: int, *,
                      base_tokens: int = 40_000,
                      ext_tokens: int = 20_000) -> List[PrefixSpec]:
    """A forest of prefix chains: ``n_roots`` roots of ``base_tokens``
    tokens, each extended ``depth - 1`` times by ``ext_tokens`` (root ->
    child -> grandchild ...).  Keys are deterministic (``trie.r2.d1``) so
    seeded workloads replay identically everywhere."""
    specs: List[PrefixSpec] = []
    for r in range(n_roots):
        parent = None
        for d in range(depth):
            key = f"trie.r{r}.d{d}"
            specs.append(PrefixSpec(key=key,
                                    n_tokens=base_tokens + d * ext_tokens,
                                    parent=parent))
            parent = key
    return specs


def zipf_prefix_trace(rng: np.random.Generator,
                      specs: Sequence[PrefixSpec], *,
                      n_requests: int = 24, alpha: float = 1.1,
                      gap: float = 30.0, suffix_tokens: int = 1_000,
                      max_new_tokens: int = 32) -> List[Request]:
    """Requests whose prefix popularity follows a Zipf law over the trie:
    spec ``i`` (0-based) is drawn with probability proportional to
    ``(i + 1) ** -alpha``.  Each request asks to reuse its spec's full
    prefix; whether that resolves to a full hit, a partial (ancestor)
    hit, or a miss is the storage tier's call at fetch-dispatch time."""
    ranks = np.arange(1, len(specs) + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    out: List[Request] = []
    for rid in range(n_requests):
        spec = specs[int(rng.choice(len(specs), p=p))]
        out.append(Request(rid=rid, arrival=rid * gap,
                           prompt_len=spec.n_tokens + suffix_tokens,
                           reuse_tokens=spec.n_tokens, prefix=spec.key,
                           max_new_tokens=max_new_tokens))
    return out


def session_trace(rng: np.random.Generator,
                  specs: Sequence[PrefixSpec], *,
                  n_sessions: int = 4, continue_p: float = 0.9,
                  session_gap: float = 60.0, think_time: float = 120.0,
                  suffix_tokens: int = 1_000,
                  max_new_tokens: int = 32) -> List[Request]:
    """Session-continuation requests over the prefix trie: each session
    opens at a (uniformly drawn) trie root and, with probability
    ``continue_p`` per turn, comes back after ``think_time`` seconds
    asking for a *child* of the prefix it just reused — the multi-turn
    shape whose next ask extends the previous one, which is exactly the
    signal the prefetch predictor's session-continuation term exploits
    (a hit on P heats P's children; docs/prefetch.md).  Sessions open
    ``session_gap`` apart in expectation.  Deterministic for a given
    rng; requests are returned in arrival order with dense rids."""
    children: dict = {}
    for s in specs:
        children.setdefault(s.parent, []).append(s)
    roots = children.get(None, [])
    assert roots, "specs contain no trie roots"
    raw: List[tuple] = []
    t = 0.0
    for _ in range(n_sessions):
        t += rng.exponential(session_gap)
        spec, ta = roots[int(rng.integers(len(roots)))], t
        while True:
            raw.append((ta, spec))
            kids = children.get(spec.key, [])
            if not kids or rng.random() >= continue_p:
                break
            spec = kids[int(rng.integers(len(kids)))]
            ta += rng.exponential(think_time)
    raw.sort(key=lambda p: p[0])
    return [Request(rid=rid, arrival=ta,
                    prompt_len=spec.n_tokens + suffix_tokens,
                    reuse_tokens=spec.n_tokens, prefix=spec.key,
                    max_new_tokens=max_new_tokens)
            for rid, (ta, spec) in enumerate(raw)]


def zipf_user_population(rng: np.random.Generator,
                         specs: Sequence[PrefixSpec], *,
                         n_users: int = 12, n_requests: int = 36,
                         alpha: float = 1.2,
                         tiers: Sequence[str] = ("premium", "standard",
                                                 "free"),
                         n_abusers: int = 1, abuse_burst: int = 8,
                         abuse_at: Optional[int] = None,
                         gap: float = 8.0, suffix_tokens: int = 1_000,
                         max_new_tokens: int = 8) -> List[Request]:
    """Multi-tenant request trace: a Zipf user population with scripted
    abusive tenants (the FairServe experiment shape, SNIPPETS.md #2).

    ``n_users`` well-behaved users ``user000..`` send ``n_requests``
    background requests whose per-user traffic follows a Zipf law over
    user rank (rank ``i`` drawn with probability ``(i+1) ** -alpha``;
    ``user000`` is the heaviest) with seeded-exponential inter-arrival
    ``gap``; each request reuses a seeded-uniform prefix from ``specs``.
    SLO tiers stripe by rank (``tiers[rank % len(tiers)]``).

    ``n_abusers`` scripted abusive tenants ``abuser00..`` — always the
    *lowest* tier (``tiers[-1]``) — each inject a flood of
    ``abuse_burst`` back-to-back requests, all at the arrival instant
    of background request index ``abuse_at`` (default
    ``n_requests // 3``) and all hammering the hottest prefix
    ``specs[0]``: the starvation shape the fairness bench and the
    cross-env replay test drive (docs/fairness.md).

    Deterministic for a given rng: identical seeds replay identical
    traces everywhere.  Requests come back in arrival order (the flood
    sits contiguously right after its trigger request) with dense rids
    and ``user``/``slo_tier`` stamped."""
    assert specs and n_users >= 1 and tiers
    users = [f"user{i:03d}" for i in range(n_users)]
    tier_of = {u: tiers[i % len(tiers)] for i, u in enumerate(users)}
    ranks = np.arange(1, n_users + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    raw: List[tuple] = []
    t = 0.0
    for _ in range(n_requests):
        t += rng.exponential(gap)
        u = users[int(rng.choice(n_users, p=p))]
        spec = specs[int(rng.integers(len(specs)))]
        raw.append((t, u, tier_of[u], spec))
    cut = min(abuse_at if abuse_at is not None else n_requests // 3,
              len(raw) - 1)
    t_flood = raw[cut][0]
    flood = [(t_flood, f"abuser{a:02d}", tiers[-1], specs[0])
             for a in range(n_abusers) for _ in range(abuse_burst)]
    raw = raw[:cut + 1] + flood + raw[cut + 1:]
    return [Request(rid=rid, arrival=ta,
                    prompt_len=spec.n_tokens + suffix_tokens,
                    reuse_tokens=spec.n_tokens, prefix=spec.key,
                    max_new_tokens=max_new_tokens,
                    user=u, slo_tier=tier)
            for rid, (ta, u, tier, spec) in enumerate(raw)]


def churn_schedule(rng: np.random.Generator,
                   node_ids: Sequence[str], *,
                   n_failures: int = 1, t_start: float = 100.0,
                   gap: float = 400.0, downtime: Optional[float] = 200.0
                   ) -> tuple:
    """Seeded storage-node churn: ``n_failures`` fail events starting at
    ``t_start`` spaced ``gap`` seconds apart, each node drawn uniformly
    (never failing a node that is still down).  Returns ``(fail_at,
    recover_at)`` lists shaped for ``ServingSimulator(fail_at=...,
    recover_at=...)``; ``downtime=None`` means nodes never recover.
    Deterministic for a given rng seed, so simulator and live engine
    can replay the identical churn trace."""
    fail_at: List[tuple] = []
    recover_at: List[tuple] = []
    down_until: dict = {}
    t = t_start
    for _ in range(n_failures):
        up = [n for n in node_ids if down_until.get(n, -1.0) < t]
        if len(up) <= 1:
            break  # never fail the last alive node (the cluster —
            # and StorageCluster.fail_node — require one survivor)
        nid = up[int(rng.integers(len(up)))]
        fail_at.append((t, nid))
        if downtime is not None:
            recover_at.append((t + downtime, nid))
            down_until[nid] = t + downtime
        else:
            down_until[nid] = float("inf")
        t += gap
    return fail_at, recover_at


def shared_prefix_tokens(rng: np.random.Generator, vocab: int,
                         prefix_len: int, n_requests: int,
                         suffix_len: int) -> tuple:
    """(prefix, [full_prompt_i]) token arrays for the live engine."""
    prefix = rng.integers(0, vocab, prefix_len)
    prompts = [np.concatenate([prefix,
                               rng.integers(0, vocab, suffix_len)])
               for _ in range(n_requests)]
    return prefix, prompts
