"""How ``correct`` is decided: once the window has closed and the engine
is freed, a sample of the requests it finished, drawn from the seed with
the longest among them, is run through the plain reference
(``reference/<arch>.py``) over each prompt and its served tokens.  The
number compared is the widest gap by which a served token's logit lies
below the reference's best at that position (``served_gap``), against
``limits/<cell>.json``.

A reuse request's prompt starts with a document: the reference works out
the stored prefix from its own prefix forward pass and the int8 round
trip, and runs the question and the served tokens over it, as the
engine's suffix prefill and decode steps do over the restored pages.
The reference routes an MoE layer's tokens in the engine's groups: the
prefill's (or suffix prefill's) tokens together, then each decode token
alone.

The control (``control.py``) puts in the served tokens' place those that
the same reference with TF32 on, one step below the configuration's
float32, puts first at each position of the same prompts and tokens, and
is judged by the same ``judge``.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from kvbench import harness
from kvbench.reference.common import precision


def sample(records, served: Dict[int, List[int]], seed: int,
           min_tokens: int, max_requests: int):
    """The finished requests compared: the longest (prompt and output),
    then others in an order drawn from the seed, until ``min_tokens``
    served tokens or ``max_requests`` requests."""
    done = [r for r in records if r.req.t_finished is not None
            and len(served[r.req.rid]) == r.spec.max_new_tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.spec.tokens)
                                       + r.spec.max_new_tokens,
                                       -r.spec.index))
    others = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % 2**63, 11])
    picked, n = [longest], longest.spec.max_new_tokens
    for i in rng.permutation(len(others)):
        if n >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(others[i])
        n += others[i].spec.max_new_tokens
    return picked


class Reference:
    """The reference for one run: weights, documents, stored prefixes."""

    def __init__(self, bench, tf32: bool = False):
        self.mod = harness.reference(bench.files.config["reference"])
        self.w, self.m = bench.weights, bench.model
        self.docs, self.device = bench.docs, bench.device
        self.tf32 = tf32
        self._prefix: Dict[int, list] = {}

    def prefix(self, doc: int):
        if doc not in self._prefix:
            toks = torch.as_tensor(self.docs[doc], device=self.device)
            with precision(self.tf32):
                self._prefix[doc] = self.mod.stored_prefix(self.w, self.m,
                                                           toks)
        return self._prefix[doc]

    def logits(self, spec, served: List[int]) -> torch.Tensor:
        """Logits at every position that served a token [n, V]."""
        toks = np.concatenate([spec.tokens, np.asarray(served[:-1],
                                                       np.int64)])
        start = spec.reuse_tokens if spec.doc is not None else 0
        pre = self.prefix(spec.doc) if spec.doc is not None else None
        n_first = len(spec.tokens) - start
        x = torch.as_tensor(toks[start:], device=self.device)
        with precision(self.tf32), torch.no_grad():
            return self.mod.logits(self.w, self.m, x, start, pre,
                                   [n_first] + [1] * (len(served) - 1),
                                   n_first - 1)


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each of ``tokens`` [n] lies below the reference's best."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(1, tokens[:, None])[:, 0]


def gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """Widest gap below the reference's best of ``tokens`` [n]."""
    return float(gaps(ref_logits, tokens).max())


def readings(bench, picked, served, chosen=None) -> dict:
    """Over the sample, at each position of each prompt and its served
    tokens: the gap below the reference's best of the token judged, the
    served one or, where ``chosen`` gives one (the control's), that one.
    The widest gap (``served_gap``), the mean gap per token
    (``served_mean_gap``) and the share of tokens judged that are not the
    reference's best (``served_mismatch_pct``)."""
    ref = Reference(bench)
    chosen = chosen or served
    widest, total, miss, n = 0.0, 0.0, 0, 0
    for r in picked:
        lg = ref.logits(r.spec, served[r.req.rid])
        g = gaps(lg, torch.as_tensor(chosen[r.req.rid], device=bench.device))
        widest = max(widest, float(g.max()))
        total += float(g.sum())
        miss += int((g > 0).sum())
        n += len(g)
    return {"served_gap": widest, "served_mean_gap": total / max(n, 1),
            "served_mismatch_pct": 100.0 * miss / max(n, 1),
            "tokens": n, "requests": len(picked)}


def judge(bench, run, served, limits: Optional[dict], seed: int,
          chosen=None) -> dict:
    """``correct`` when every number named in the cell's limits file is
    within its limit (a cell with no limits file is not correct).
    ``chosen`` puts other tokens in the served ones' place (the
    control)."""
    chk = bench.files.mix["check"]
    picked = sample(run.records, served, seed, chk["min_tokens"],
                    chk["max_requests"])
    got = readings(bench, picked, served, chosen)
    print(f"[kvbench] check: {got['requests']} requests, {got['tokens']} "
          f"served tokens against the reference", file=sys.stderr,
          flush=True)
    limits = limits or {"served_gap": {"limit": None}}
    compared = {k: {"value": got[k], "limit": v["limit"]}
                for k, v in limits.items()}
    ok = bool(picked) and all(c["limit"] is not None
                              and c["value"] <= c["limit"]
                              for c in compared.values())
    return {"correct": ok, "readings": got, "compared": compared}
