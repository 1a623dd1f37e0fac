"""The one traffic generator: it reads a mix file (``traffic/<mix>.json``)
and draws the requests of a run from ``--seed``.

Every seed gets the same multiset of sizes and gaps: lengths are the
quantiles ``(i + 0.5) / n`` of their distribution and inter-arrival gaps
the same quantiles of an exponential, each list shuffled.  The seed
shuffles them, unless the mix names a ``schedule_seed``: then that
number does, and every seed gets the same schedule, sizes, documents and
due times in the same order, with only the token ids (and the weights)
its own.  A mix whose tail hangs on which long prompts happen to arrive
together names one, so that runs on different seeds do the same work.
An open
loop draws its ramp (the ``ceil(rate x ramp_s)`` requests before the
window) and its ``pool`` of window requests as two such parts, so the
window opens on the same multiset of requests for every seed, and the
ramp's arrivals span the same time.

Mix keys:
  ``loop``: ``"open"`` (Poisson arrivals at ``rate_per_s``) or
  ``"closed"`` (``clients`` that each send their next request when the
  last one finished).
  ``prompt_tokens`` / ``question_tokens`` / ``output_tokens``: ``[lo,
  hi]`` inclusive, drawn log-uniform.
  ``documents``: ``{"count", "tokens"}``, prefixes registered in set-up;
  a request then asks about one of them (uniform) with a fresh question.
  ``pool``: requests drawn after the ramp of an open loop, or per client
  of a closed one.
  ``schedule_seed`` (optional): the number that orders the schedule in
  place of ``--seed``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Spec:
    """One request as the generator drew it."""
    index: int
    tokens: np.ndarray  # the whole prompt, document first
    max_new_tokens: int
    doc: Optional[int] = None  # document it reuses, or None
    reuse_tokens: int = 0
    due: Optional[float] = None  # seconds after the schedule starts (open)
    client: Optional[int] = None  # closed loop


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def loguniform_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """n whole lengths in [lo, hi] at the log-uniform quantiles
    (i + 0.5) / n."""
    u = (np.arange(n) + 0.5) / n
    x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def exponential_quantiles(rate: float, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def documents(mix: dict, seed: int, vocab: int) -> List[np.ndarray]:
    doc = mix.get("documents")
    if not doc:
        return []
    rng = _rng(seed, 1)
    return [rng.integers(0, vocab, doc["tokens"], dtype=np.int64)
            for _ in range(doc["count"])]


def _draw(rng, mix: dict, n: int, n_docs: int):
    """Output lengths, prompt (or question) lengths and documents (-1 for
    none) of ``n`` requests, each list shuffled by ``rng``."""
    out_len = rng.permutation(loguniform_quantiles(*mix["output_tokens"], n))
    if n_docs:
        q_len = rng.permutation(loguniform_quantiles(*mix["question_tokens"],
                                                     n))
        which = rng.permutation(np.arange(n) % n_docs)
    else:
        q_len = rng.permutation(loguniform_quantiles(*mix["prompt_tokens"],
                                                     n))
        which = np.full(n, -1)
    return out_len, q_len, which


def requests(mix: dict, seed: int, vocab: int,
             rate_per_s: Optional[float] = None) -> List[Spec]:
    """The run's requests in the order they are sent: for an open loop
    with ``due`` times from 0 on, the ramp's first; for a closed loop
    client by client, each client's in its own order.  ``rate_per_s``
    overrides the mix's rate (the sweep)."""
    pool = int(mix["pool"])
    docs = documents(mix, seed, vocab)
    rng = _rng(mix.get("schedule_seed", seed), 2)
    if mix["loop"] == "open":
        rate = float(rate_per_s or mix["rate_per_s"])
        parts = []
        for k in (math.ceil(rate * float(mix["ramp_s"])), pool):
            parts.append(_draw(rng, mix, k, len(docs))
                         + (rng.permutation(exponential_quantiles(rate, k)),))
        out_len, q_len, which, gaps = (np.concatenate(x)
                                       for x in zip(*parts))
        n, clients = len(q_len), 1
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    else:
        clients = int(mix["clients"])
        n = pool * clients
        out_len, q_len, which = _draw(rng, mix, n, len(docs))
    tok_rng = _rng(seed, 3)
    specs = []
    for i in range(n):
        fresh = tok_rng.integers(0, vocab, int(q_len[i]), dtype=np.int64)
        doc = None if which[i] < 0 else int(which[i])
        tokens = fresh if doc is None else np.concatenate([docs[doc], fresh])
        specs.append(Spec(
            index=i, tokens=tokens, max_new_tokens=int(out_len[i]),
            doc=doc,
            reuse_tokens=0 if doc is None else len(docs[doc]),
            due=float(due[i]) if mix["loop"] == "open" else None,
            client=i % clients if mix["loop"] == "closed" else None))
    return specs


def longest_prompt(mix: dict) -> int:
    hi = mix["prompt_tokens"][1] if "prompt_tokens" in mix else (
        mix["documents"]["tokens"] + mix["question_tokens"][1])
    return int(hi)


def longest_sequence(mix: dict) -> int:
    return longest_prompt(mix) + int(mix["output_tokens"][1])


def concurrent_sequences(mix: dict, max_running: int) -> int:
    """Sequences the pages must hold at once: the running batch, and in a
    closed loop no more than its clients."""
    if mix["loop"] == "closed":
        return min(max_running, int(mix["clients"]))
    return max_running
