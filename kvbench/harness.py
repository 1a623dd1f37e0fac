"""One run of one cell: set-up, the measured window, the metrics and the
check of what the window served.

The entry the window drives is ``repro_torch.serving.engine.LiveEngine``
on the wall clock (``bandwidth=None``, ``fetch_mode="sync"``) over a flat
``KVStore``; the harness calls its ``submit`` and ``step`` and nothing
else while the window is open.  Requests come from the mix's schedule:
an open loop submits every request whose due time has passed before each
step, a closed loop submits a client's next request once its last one
finished.  Times to first token are taken from the due time, since
``submit`` stamps ``Request.arrival`` late whenever a step blocks.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kvbench import stats, traffic, weights as weights_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print("[kvbench]", *a, file=sys.stderr, flush=True)


# -- the files a cell is made of, found by name -------------------------------

def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str):
    """(cell, configuration entry) of ``workload`` in ``BENCHMARK.json``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, cfg


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_module(path: pathlib.Path, name: str):
    """A module from a file whose name need not be an identifier (a
    metric's name holds dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: pathlib.Path = HERE):
    return load_module(base / "metrics" / f"{name}.py",
                       "kvbench_metric_" + name.replace(".", "_"))


def reference(arch: str):
    """``reference/<arch>.py``, named by a configuration's ``reference``."""
    return importlib.import_module(f"kvbench.reference.{arch}")


@dataclasses.dataclass
class CellFiles:
    """Everything one cell reads, loaded."""
    cell: dict
    config: dict  # the configuration file
    mix: dict  # the traffic file
    limits: Optional[dict]  # limits/<cell>.json, or None before it exists
    metrics: List[dict]  # the BENCHMARK.json entries reported
    base: pathlib.Path  # where traffic/, metrics/ and limits/ are


def cell_files(bench: dict, workload: str, trace: bool,
               root: pathlib.Path = ROOT,
               base: pathlib.Path = HERE) -> CellFiles:
    """Load a cell's files: its configuration (the ``file`` of its entry,
    relative to ``root``), ``base/traffic/<mix>.json`` and
    ``base/limits/<cell>.json``."""
    cell, entry = find_cell(bench, workload)
    config = load_json(root / entry["file"])
    mix = load_json(base / "traffic" / f"{cell['traffic']}.json")
    lim_path = base / "limits" / f"{workload}.json"
    limits = load_json(lim_path) if lim_path.exists() else None
    return CellFiles(cell, config, mix, limits,
                     cell_metrics(bench, workload, trace), base)


# -- records ------------------------------------------------------------------

@dataclasses.dataclass
class Record:
    """One request of the run: what was drawn, when it was due, and the
    engine's ``Request`` (its timestamps are the program's own)."""
    spec: traffic.Spec
    due: float
    req: object
    submitted: float

    @property
    def reuse(self) -> bool:
        return self.spec.doc is not None


@dataclasses.dataclass
class Step:
    """One ``LiveEngine.step()`` call as the harness saw it from outside:
    host times, and what the requests' fields say it did."""
    t0: float
    t1: float
    prefills: List[tuple]  # (start position, tokens)
    decodes: List[int]  # context of each decoded token
    fetches: List[int]  # prefix tokens restored

    @property
    def decode_only(self) -> bool:
        return bool(self.decodes) and not self.prefills and not self.fetches


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    model: dict
    engine: dict
    mix: dict
    records: List[Record]
    steps: List[Step]
    # (open, close) on the host clock; in a traced run it closes where
    # the traced slice opens
    window: tuple
    setup_s: float
    # (layers, tokens) of each chunk a fetch of so many prefix tokens
    # restores, from the stored manifests
    restore_chunks: Dict[int, List[tuple]] = dataclasses.field(
        default_factory=dict)
    trace: Optional[object] = None  # profile.Slice of a traced run


def _snapshot(records: List[Record]):
    return {id(r): (r.req.t_first_token is None, r.req.tokens_out,
                    r.req.fetch_done is None) for r in records
            if r.req.t_finished is None}


def _what_happened(records: List[Record], before, t0, t1) -> Step:
    st = Step(t0, t1, [], [], [])
    for r in records:
        if id(r) not in before:
            continue
        no_first, out0, no_fetch = before[id(r)]
        req = r.req
        if no_fetch and req.fetch_done is not None:
            st.fetches.append(req.reuse_tokens)
        prefilled = no_first and req.t_first_token is not None
        if prefilled:
            st.prefills.append((req.reuse_tokens,
                                req.prompt_len - req.reuse_tokens))
        start = 1 if prefilled else out0
        st.decodes.extend(req.prompt_len + a
                          for a in range(max(start, 1), req.tokens_out))
    return st


# -- set-up ---------------------------------------------------------------------

def model_config(config: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name=config["name"], source=config["source"],
                       **config["model"])


def n_pages(config: dict, mix: dict) -> int:
    eng = config["engine"]
    per_seq = -(-traffic.longest_sequence(mix) // eng["page_size"])
    return traffic.concurrent_sequences(mix, eng["max_running"]) * per_seq


WARM_DOC_TOKENS = 32  # the warm-up document (reuse mixes)
WARM_NEW_TOKENS = 2


class Bench:
    """The system under test, set up for one cell and seed: weights, the
    store with the mix's documents, and the engine."""

    def __init__(self, files: CellFiles, seed: int, device: torch.device):
        from repro_torch.cluster.storage import KVStore
        from repro_torch.serving import paged_model
        self.files, self.seed, self.device = files, seed, device
        cfg, mix = files.config, files.mix
        self.model = cfg["model"]
        self.cfg = model_config(cfg)
        eng = cfg["engine"]
        self.weights = weights_mod.make_weights(self.model, cfg["weights"],
                                                seed, device)
        vocab = self.model["vocab_size"]
        self.docs = traffic.documents(mix, seed, vocab)
        self.store = KVStore()
        self.keys = []
        self.chunks: Dict[int, List[tuple]] = {}
        t0 = time.monotonic()
        warm_rng = np.random.default_rng([int(seed) % 2**63, 9])
        warm_doc = warm_rng.integers(0, vocab, WARM_DOC_TOKENS)
        for doc in self.docs + ([warm_doc] if self.docs else []):
            kv_k, kv_v = paged_model.donor_prefix_kv(self.weights, self.cfg,
                                                     doc)
            man = self.store.register_prefix(
                doc, kv_k, kv_v, resolutions=(eng["resolution"],))
            self.keys.append(man.prefix)
            self.chunks[len(doc)] = [(len(r.layers),
                                      r.token_end - r.token_start)
                                     for r in man.refs]
        self.encode_s = time.monotonic() - t0
        self.warm_doc = warm_doc if self.docs else None

    def engine(self):
        from repro_torch.serving.engine import LiveEngine
        eng = self.files.config["engine"]
        return LiveEngine(self.weights, self.cfg, self.store,
                          n_pages=n_pages(self.files.config,
                                          self.files.mix),
                          page_size=eng["page_size"],
                          max_running=eng["max_running"],
                          resolution=eng["resolution"], device=self.device)

    def warm_up(self, eng) -> None:
        """One request of the mix's kind through the window's engine:
        builds or loads the kernels' libraries and runs the fetch, the
        prefill and the decode paths once (eager PyTorch compiles no
        shape)."""
        vocab = self.model["vocab_size"]
        rng = np.random.default_rng([int(self.seed) % 2**63, 10])
        if self.warm_doc is not None:
            toks = np.concatenate([self.warm_doc, rng.integers(0, vocab, 8)])
            req = eng.submit(toks, reuse_prefix=self.keys[-1],
                             reuse_tokens=len(self.warm_doc),
                             max_new_tokens=WARM_NEW_TOKENS)
        else:
            toks = rng.integers(0, vocab, traffic.longest_prompt(
                self.files.mix))
            req = eng.submit(toks, max_new_tokens=WARM_NEW_TOKENS)
        while req.t_finished is None:
            eng.step()

    def specs(self, rate_per_s=None, pool=None):
        mix = dict(self.files.mix)
        if pool is not None:
            mix["pool"] = pool
        return traffic.requests(mix, self.seed, self.model["vocab_size"],
                                rate_per_s=rate_per_s)


# -- the window -----------------------------------------------------------------

class LoadLoop:
    """Submits the schedule's requests and steps the engine until the
    window closes, keeping a record of each request and step."""

    def __init__(self, bench: Bench, eng, specs, spans=None):
        self.bench, self.eng = bench, eng
        self.mix = bench.files.mix
        self.records: List[Record] = []
        self.steps: List[Step] = []
        self.spans = spans  # profile.Spans in a traced run
        self.closed = self.mix["loop"] == "closed"
        if self.closed:
            n = int(self.mix["clients"])
            self.queues = [[s for s in specs if s.client == c]
                           for c in range(n)]
            self.busy: List[Optional[Record]] = [None] * n
        else:
            self.pending = list(specs)  # in due order
        self.next = 0

    def _submit(self, spec, due: float) -> Record:
        kw = {}
        if spec.doc is not None:
            kw = dict(reuse_prefix=self.bench.keys[spec.doc],
                      reuse_tokens=spec.reuse_tokens)
        req = self.eng.submit(spec.tokens,
                              max_new_tokens=spec.max_new_tokens, **kw)
        rec = Record(spec, due, req, time.monotonic())
        self.records.append(rec)
        return rec

    def _submit_due(self, t0: float, now: float) -> Optional[float]:
        """Submit what is due; return the next due time, if any."""
        if self.closed:
            nxt = None
            for c, q in enumerate(self.queues):
                last = self.busy[c]
                if last is not None and last.req.t_finished is None:
                    continue
                due = t0 if last is None else last.req.t_finished
                if not q:
                    continue
                if due <= now:
                    self.busy[c] = self._submit(q.pop(0), due)
                else:
                    nxt = due if nxt is None else min(nxt, due)
            return nxt
        while self.next < len(self.pending) \
                and t0 + self.pending[self.next].due <= now:
            spec = self.pending[self.next]
            self._submit(spec, t0 + spec.due)
            self.next += 1
        if self.next < len(self.pending):
            return t0 + self.pending[self.next].due
        return None

    def run_until(self, t0: float, t_end: float, on_boundary=None) -> None:
        """Drive the schedule that starts at ``t0`` until ``t_end``.
        ``on_boundary(now)`` runs between steps (the traced slice)."""
        while True:
            now = time.monotonic()
            if on_boundary is not None:
                on_boundary(now)
            if now >= t_end:
                return
            nxt = self._submit_due(t0, now)
            if any(r.req.t_finished is None for r in self.records):
                before = _snapshot(self.records)
                t1 = time.monotonic()
                if self.spans is not None:
                    with self.spans.span("step"):
                        self.eng.step()
                else:
                    self.eng.step()
                t2 = time.monotonic()
                self.steps.append(_what_happened(self.records, before,
                                                 t1, t2))
            else:
                wake = t_end if nxt is None else min(nxt, t_end)
                if self.spans is not None:
                    with self.spans.span("generator wait"):
                        time.sleep(max(0.0, wake - time.monotonic()))
                else:
                    time.sleep(max(0.0, wake - time.monotonic()))


def lateness(records: List[Record]) -> str:
    late = [r.submitted - r.due for r in records]
    if not late:
        return "no request submitted"
    return (f"{len(late)} requests submitted, lateness from due time "
            f"p50 {np.median(late):.6f} s, max {max(late):.6f} s")


def read_metrics(metric_entries, run: Run,
                 base: pathlib.Path = HERE) -> Dict[str, dict]:
    out = {}
    for m in metric_entries:
        value = metric_reader(m["name"], base).read(run)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def device_info(device: torch.device, peak: int, count: int) -> dict:
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": count, "memory_peak_bytes": int(peak)}


@dataclasses.dataclass
class Served:
    """A cell's window served and closed, the engine freed: what the
    result and the check are made from."""
    bench: Bench
    run: Run
    served: Dict[int, List[int]]  # each request's output tokens
    metrics: Dict[str, dict]
    attempted: int
    peak: int


def serve(files: CellFiles, seed: int, seconds: float, trace: bool,
          device: torch.device, t_process: float) -> Served:
    """Set up, open the window, serve, close it, read the metrics and free
    the engine."""
    from kvbench import profile
    mix = files.mix
    log(f"cell {files.cell['name']}, seed {seed}, {seconds} s window, "
        f"trace {int(trace)}, device {device}")
    bench = Bench(files, seed, device)
    log(f"weights {weights_mod.n_params(bench.model, files.config['weights'])}"
        f" fp32 parameters; {len(bench.docs)} documents registered, "
        f"donor prefill and host encode {bench.encode_s:.3f} s, "
        f"{bench.store.stored_bytes()} bytes stored")
    eng = bench.engine()
    pool_bytes = 2 * eng.cache.k_pages.numel() * eng.cache.k_pages.element_size()
    log(f"engine: {eng.cache.n_pages} pages of {eng.cache.page_size} "
        f"tokens, {pool_bytes} bytes of pages")
    bench.warm_up(eng)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    spans = profile.Spans(eng) if trace else None
    drv = LoadLoop(bench, eng, bench.specs(), spans)
    t0 = time.monotonic()
    t_open = t0 + float(mix["ramp_s"])
    t_close = t_open + float(seconds)
    # the traced slice is the window's last trace_slice_s: the host-clock
    # per-layer metrics read the part before it, which the profiler's
    # overhead on the host has not slowed
    prof = profile.Slicer(t_close - float(mix["trace_slice_s"]), device) \
        if trace else None
    drv.run_until(t0, t_open, None)
    setup_s = t_open - t_process
    drv.run_until(t0, t_close, prof.boundary if prof else None)
    if prof is not None:
        prof.finish()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(lateness([r for r in drv.records if t_open <= r.due <= t_close]))
    for reuse in (True, False):
        t = stats.ttfts(drv.records, (t_open, t_close), reuse=reuse)
        if t:
            log(f"{'reuse' if reuse else 'plain'} TTFTs in the window "
                f"({len(t)}): {[round(x, 4) for x in t]}")
    log(f"gaps between tokens in the window: "
        f"{len(stats.gaps(drv.records, (t_open, t_close)))}")
    untraced = (t_open, prof.t0 if prof and prof.t0 else t_close)
    run = Run(bench.model, files.config["engine"], mix, drv.records,
              drv.steps, untraced, setup_s, bench.chunks,
              prof.summary(drv.steps) if prof else None)
    metrics = read_metrics(files.metrics, run, files.base)
    attempted = sum(t_open <= r.due <= t_close for r in drv.records)
    served = {r.req.rid: list(eng.outputs[r.req.rid]) for r in drv.records}
    if spans is not None:
        spans.close()
    del eng, drv.eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Served(bench, run, served, metrics, int(attempted), int(peak))


def run_cell(files: CellFiles, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float) -> dict:
    """Serve the cell's window, then check what it served.  Returns the
    result object."""
    from kvbench import check
    out = serve(files, seed, seconds, trace, device, t_process)
    verdict = check.judge(out.bench, out.run, out.served, files.limits, seed)
    result = {"correct": verdict["correct"], "attempted": out.attempted,
              "failed": 0, "metrics": out.metrics,
              "device": device_info(device, out.peak, 1)}
    if out.run.trace is not None:
        result["device"].update(busy_s=out.run.trace.busy_s,
                                window_s=out.run.trace.window_s)
        result["breakdown"] = out.run.trace.breakdown()
    result["compared"] = verdict["compared"]
    return result
