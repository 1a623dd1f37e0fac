"""The port's copies of the virtual-clock fetch pipeline (core/pipelining,
core/adaptive, cluster/network, cluster/decodepool, cluster/costmodel,
core/fetch.synthetic_plan, core/fetch_controller) against the JAX
package's originals: the same calls give the same numbers, and the
controller scenarios of tests/test_fetch_controller.py and lossy,
correlated WAN runs replay the same event logs through both
controllers."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster.costmodel as j_costmodel  # noqa: E402
import repro.cluster.decodepool as j_decodepool  # noqa: E402
import repro.cluster.network as j_network  # noqa: E402
import repro.core.adaptive as j_adaptive  # noqa: E402
import repro.core.fetch as j_fetch  # noqa: E402
import repro.core.fetch_controller as j_fc  # noqa: E402
import repro.core.pipelining as j_pipelining  # noqa: E402
import repro.core.scheduler as j_scheduler  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_config as j_reduce_config  # noqa: E402

import repro_torch.cluster.costmodel as t_costmodel  # noqa: E402
import repro_torch.cluster.decodepool as t_decodepool  # noqa: E402
import repro_torch.cluster.network as t_network  # noqa: E402
import repro_torch.core.adaptive as t_adaptive  # noqa: E402
import repro_torch.core.fetch as t_fetch  # noqa: E402
import repro_torch.core.fetch_controller as t_fc  # noqa: E402
import repro_torch.core.pipelining as t_pipelining  # noqa: E402
import repro_torch.core.scheduler as t_scheduler  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduce_config as t_reduce_config  # noqa: E402

JAX = types.SimpleNamespace(
    costmodel=j_costmodel, decodepool=j_decodepool, network=j_network,
    adaptive=j_adaptive, fetch=j_fetch, fc=j_fc, pipelining=j_pipelining,
    scheduler=j_scheduler, get_config=j_get_config,
    reduce_config=j_reduce_config)
PORT = types.SimpleNamespace(
    costmodel=t_costmodel, decodepool=t_decodepool, network=t_network,
    adaptive=t_adaptive, fetch=t_fetch, fc=t_fc, pipelining=t_pipelining,
    scheduler=t_scheduler, get_config=t_get_config,
    reduce_config=t_reduce_config)
RES = ("240p", "480p", "640p", "1080p")


def _both(fn):
    """``fn(ns)`` for the JAX package and for the port."""
    return fn(JAX), fn(PORT)


# ---------------------------------------------------------------------------
# the copied modules, call by call
# ---------------------------------------------------------------------------

def test_pipelining_matches():
    rng = np.random.default_rng(0)
    cases = [(rng.exponential(1.0, L), rng.exponential(1.0, L))
             for L in (1, 3, 9, 32) for _ in range(20)]

    def run(ns):
        return [(ns.pipelining.max_admission_buffer(dec, comp),
                 [ns.pipelining.non_blocking_ok(dec, comp, b)
                  for b in range(len(dec) + 1)]) for dec, comp in cases]

    a, b = _both(run)
    assert a == b


def test_decode_tables_match():
    a, b = _both(lambda ns: {k: dataclasses.asdict(v)
                             for k, v in ns.adaptive.TABLES.items()})
    assert a == b and {"h20", "l20", "a100"} <= set(a)
    for name, table in t_adaptive.TABLES.items():
        ref = j_adaptive.TABLES[name]
        for r in table.latency:
            for conc in range(1, 2 * table.n_decoders + 2):
                assert table.decode_latency(r, conc) == \
                    ref.decode_latency(r, conc)


def test_selection_and_pipelined_time_match():
    def run(ns):
        out = []
        for table in ns.adaptive.TABLES.values():
            for gbps in (0.1, 0.5, 1.0, 4.0, 16.0, 64.0):
                for load in range(table.n_decoders + 1):
                    for active in (None,) + RES:
                        for sizes in (None, {r: int(2e6 * (i + 1))
                                             for i, r in enumerate(RES)}):
                            bw = gbps * ns.adaptive.GBPS
                            out.append(ns.adaptive.select_resolution(
                                bw, load, table, sizes_bytes=sizes,
                                active_resolution=active))
                            out.append(tuple(ns.adaptive.pipelined_time(
                                bw, load, table, r, sizes_bytes=sizes,
                                active_resolution=active)
                                for r in table.latency))
        est = ns.adaptive.BandwidthEstimator(1e8, alpha=0.3)
        for nbytes, sec in ((1e6, 0.01), (5e6, 0.2), (3e6, 0.0), (2e6, 1.0)):
            est.observe(nbytes, sec)
            out.append(est.est)
        return out

    a, b = _both(run)
    assert a == b


def test_traces_and_rtt_estimator_match():
    def run(ns):
        net = ns.network
        traces = [net.BandwidthTrace.constant(1.0),
                  net.BandwidthTrace.steps([(0.0, 2.0), (0.5, 0.25),
                                            (1.5, 8.0)]),
                  net.BandwidthTrace.jittered(np.random.default_rng(3), 1.0,
                                              5.0, seg_len=0.1)]
        out = [repr(t) for t in traces]
        for t in traces:
            for t0 in (0.0, 0.3, 1.2):
                out.append((t.bw_at(t0), t.next_change(t0),
                            t.transmit(3e7, t0)))
        rtt = net.RttEstimator()
        out.append(rtt.rto(0.02, 10.0))
        for s in (0.1, 0.12, 0.5, 0.09, 0.11, 2.0, 0.1):
            rtt.observe(s)
            out.append((rtt.srtt, rtt.rttvar, rtt.rto(0.02, 10.0)))
        return out

    a, b = _both(run)
    assert a == b


@pytest.mark.parametrize("mode", ["bernoulli", "gilbert_elliott",
                                  "correlated", "scripted"])
def test_loss_models_match(mode):
    def run(ns):
        make = {
            "bernoulli": lambda: ns.network.LossModel.bernoulli(0.2, seed=7),
            "gilbert_elliott": lambda: ns.network.LossModel.gilbert_elliott(
                seed=7, good_to_bad=0.2, bad_to_good=0.3),
            "correlated": lambda: ns.network.LossModel.correlated(
                seed=7, slot=0.05, good_to_bad=0.2),
            "scripted": lambda: ns.network.LossModel.scripted(
                {(0, 1, 1), (1, 3, 1), (1, 3, 2)}),
        }[mode]
        loss = make()
        got = [loss.dropped(flow, seq, att, now=0.013 * (seq + 7 * flow))
               for flow in range(3) for seq in range(40)
               for att in (1, 2)]
        return got, loss.drops, loss.drop_slots, loss.attempts, \
            loss.mean_loss_rate()

    a, b = _both(run)
    assert a == b


@pytest.mark.parametrize("policy,ramp", [("fair", "instant"),
                                         ("fair", "slowstart"),
                                         ("drr", "instant"),
                                         ("drr", "slowstart")])
def test_shared_link_matches(policy, ramp):
    """Staggered flows with weights and a cancel: completion times and
    share-change notifications equal."""
    def run(ns):
        import heapq
        events, log, eid = [], [], [0]

        def push(t, fn):
            eid[0] += 1
            heapq.heappush(events, (t, eid[0], fn))

        link = ns.network.SharedLink(ns.network.BandwidthTrace.constant(1.0),
                                     policy=policy, ramp=ramp)
        link.bind(push)
        link.on_share_change(lambda t, why: log.append(("share", t, why)))
        handles = {}
        for flow, (t0, w) in enumerate(((0.0, 1.0), (0.1, 2.0), (0.25, 1.0))):
            link.open_flow(flow, w, t=t0)
            for k in range(3):
                handles[(flow, k)] = link.submit(
                    flow, 2e7 * (k + 1), t0,
                    lambda t, f=flow, k=k: log.append(("done", f, k, t)))
        link.cancel(handles[(2, 2)], 0.3)
        while events:
            t, _, fn = heapq.heappop(events)
            fn(t)
            log.append(("n", link.n_flows, link.in_flight))
        return log

    a, b = _both(run)
    assert a == b


def test_decode_pool_and_cost_model_match():
    def run(ns):
        out = []
        pool = ns.decodepool.DecodePool(ns.adaptive.H20_TABLE)
        for i, r in enumerate(RES * 3):
            out.append(pool.decode(r, 0.01 * i, size_scale=0.5 + 0.1 * i))
            out.append(pool.load_at(0.01 * i))
        out.append((pool.stats.jobs, pool.stats.busy_time,
                    pool.stats.utilization(pool.n)))
        out.append({k: dataclasses.asdict(v)
                    for k, v in ns.costmodel.CHIPS.items()})
        for name in ("lwm-7b", "yi-34b"):
            for cfg in (ns.get_config(name),
                        ns.reduce_config(ns.get_config(name))):
                for chip in ("h20", "a100"):
                    cm = ns.costmodel.EngineCostModel(
                        cfg, ns.costmodel.CHIPS[chip], 1)
                    out.append((cm.prefill_time(528), cm.prefill_time(16, 512),
                                cm.decode_step_time(3, 540.5),
                                cm.layer_comp_times(16)))
        return out

    a, b = _both(run)
    assert a == b


def test_synthetic_plan_matches():
    def run(ns):
        plan = ns.fetch.synthetic_plan(3, 25_000, 9, 10_000)
        return (plan.rid, plan.n_layers_total,
                [dataclasses.astuple(pc.ref) for pc in plan.chunks])

    a, b = _both(run)
    assert a == b


# ---------------------------------------------------------------------------
# controller scenarios of tests/test_fetch_controller.py, through both
# ---------------------------------------------------------------------------

def _sched_cls(ns):
    class _RecSched(ns.scheduler.FetchingAwareScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.t_early = None

        def notify_early_admissible(self, req, now):
            if self.t_early is None:
                self.t_early = now
            super().notify_early_admissible(req, now)
    return _RecSched


def _hooks(ns, nbytes=50e6, comp=None, sized=False, restore=0.002):
    class _Hooks(ns.fc.FetchHooks):
        def chunk_bytes(self, fetch, pc, res):
            if sized:  # encoded size scales with resolution
                return ns.adaptive.H20_TABLE.chunk_size_mb[res] * 1e6 * 0.5
            return nbytes

        def restore_seconds(self, fetch, pc):
            return restore

        def comp_times(self, req):
            return comp
    return _Hooks()


def _log(plan, req, sched, ctrl):
    """Everything the controller decided, in comparable form."""
    return dict(
        chunks=[(pc.resolution, pc.attempts, pc.t_transmit_start,
                 pc.t_transmit_done, pc.t_decode_done, pc.t_restored)
                for pc in plan.chunks],
        fetch=(req.fetch_started, req.fetch_done, req.early_admitted,
               req.layers_ready, req.state.name, plan.aborted),
        t_early=sched.t_early,
        switches=list(ctrl.resolution_switches),
        retx=(ctrl.retransmits_total, ctrl.spurious_retransmits_total),
        now=ctrl.now, high_water=ctrl.buffer_high_water)


def _drive(ns, policy="kvfetcher", *, pipelined=True, adaptive=False,
           comp=None, gbps=1.0, nbytes=50e6, reuse=30_000, n_layers=9,
           sized=False):
    """tests/test_fetch_controller.py::_drive on the given package."""
    sched = _sched_cls(ns)(policy, max_running=4)
    req = ns.scheduler.Request(rid=0, arrival=0.0, prompt_len=reuse + 2_000,
                               reuse_tokens=reuse, prefix="p")
    sched.submit(req, 0.0)
    sched.schedule(0.0)
    (fetch_req,) = sched.take_fetches()
    plan = ns.fetch.synthetic_plan(0, reuse, n_layers, 10_000)
    table = ns.adaptive.H20_TABLE
    ctrl = ns.fc.FetchController(
        sched, ns.network.BandwidthTrace.constant(gbps),
        table=table, pool=ns.decodepool.DecodePool(table),
        config=ns.fc.PipelineConfig(adaptive=adaptive,
                                    fixed_resolution="1080p",
                                    pipelined=pipelined,
                                    layerwise_admission=comp is not None,
                                    resolutions=RES),
        hooks=_hooks(ns, nbytes, comp, sized))
    ctrl.start(fetch_req, plan, 0.0)
    ctrl.pump(float("inf"))
    return _log(plan, req, sched, ctrl)


@pytest.mark.parametrize("kw", [
    {},                                            # event ordering
    {"pipelined": False},                          # serialized baseline
    {"comp": [10.0] * 9},                          # early admission
    {"comp": [1e-4] * 9},                          # no early admission
    {"adaptive": True, "sized": True, "gbps": 1.0},   # ABR, slow link
    {"adaptive": True, "sized": True, "gbps": 40.0},  # ABR, fast link
], ids=["ordering", "serialized", "early", "no_early", "abr_slow",
        "abr_fast"])
def test_controller_scenarios_match(kw):
    a, b = _both(lambda ns: _drive(ns, **kw))
    assert a == b
    assert a["fetch"][1] is not None  # the fetch completed


@pytest.mark.parametrize("policy", ["fetch_agnostic", "kvfetcher"])
def test_fetch_agnostic_hol_scenario_matches(policy):
    def run(ns):
        sched = ns.scheduler.FetchingAwareScheduler(policy, max_running=4)
        a = ns.scheduler.Request(rid=0, arrival=0.0, prompt_len=22_000,
                                 reuse_tokens=20_000, prefix="p")
        b = ns.scheduler.Request(rid=1, arrival=0.0, prompt_len=1_000)
        sched.submit(a, 0.0)
        sched.submit(b, 0.0)
        admitted0 = [r.rid for r in sched.schedule(0.0)]
        (fetch_req,) = sched.take_fetches()
        table = ns.adaptive.H20_TABLE
        ctrl = ns.fc.FetchController(
            sched, ns.network.BandwidthTrace.constant(1.0),
            table=table, pool=ns.decodepool.DecodePool(table),
            config=ns.fc.PipelineConfig(adaptive=False,
                                        fixed_resolution="1080p",
                                        layerwise_admission=False),
            hooks=_hooks(ns))
        ctrl.start(fetch_req, ns.fetch.synthetic_plan(0, 20_000, 9, 10_000),
                   0.0)
        ctrl.pump(float("inf"))
        admitted = [r.rid for r in sched.schedule(ctrl.now)]
        return admitted0, admitted, a.fetch_done, b.t_admitted, ctrl.now

    a, b = _both(run)
    assert a == b


@pytest.mark.parametrize("loss_kind,policy,ramp,rto_mode", [
    ("bernoulli", "fair", None, "adaptive"),
    ("gilbert_elliott", "drr", None, "fixed"),
    ("correlated", "fair", "slowstart", "adaptive"),
    ("correlated", "drr", "slowstart", "fixed"),
])
def test_lossy_staggered_fetches_match(loss_kind, policy, ramp, rto_mode):
    """Three fetches join a lossy link at staggered times, with ABR over
    resolution-sized chunks: timestamps, attempts, drops, drop slots,
    retransmits and resolution switches equal."""
    def run(ns):
        net = ns.network
        loss = {
            "bernoulli": lambda: net.LossModel.bernoulli(0.15, seed=11),
            "gilbert_elliott": lambda: net.LossModel.gilbert_elliott(
                seed=5, good_to_bad=0.1, bad_to_good=0.3),
            "correlated": lambda: net.LossModel.correlated(
                seed=9, slot=0.05, good_to_bad=0.15, bad_to_good=0.3),
        }[loss_kind]()
        arrivals = (0.0, 0.4, 0.9)
        sched = _sched_cls(ns)("kvfetcher", max_running=4)
        reqs = []
        for rid, t in enumerate(arrivals):
            r = ns.scheduler.Request(rid=rid, arrival=t, prompt_len=31_000,
                                     reuse_tokens=30_000, prefix=f"p{rid}")
            sched.submit(r, t)
            reqs.append(r)
        sched.schedule(0.0)
        table = ns.adaptive.H20_TABLE
        link = net.make_link(net.BandwidthTrace.jittered(
            np.random.default_rng(2), 16.0, 60.0, seg_len=0.2),
            policy=policy, loss=loss, ramp=ramp)
        ctrl = ns.fc.FetchController(
            sched, link, table=table, pool=ns.decodepool.DecodePool(table),
            config=ns.fc.PipelineConfig(adaptive=True, resolutions=RES,
                                        rto_mode=rto_mode),
            hooks=_hooks(ns, sized=True, comp=[0.5] * 9))
        plans = []
        for r in sched.take_fetches():
            ctrl.pump(r.arrival)
            plans.append(ns.fetch.synthetic_plan(r.rid, 30_000, 9, 10_000))
            ctrl.start(r, plans[-1], r.arrival)
        ctrl.pump(float("inf"))
        return ([_log(p, r, sched, ctrl) for p, r in zip(plans, reqs)],
                loss.drops, loss.drop_slots, loss.attempts)

    a, b = _both(run)
    assert a == b
    logs, drops = a[0], a[1]
    # the scenario exercises what it claims to: loss, ABR down-switches
    # at flow joins, early admission
    assert drops and logs[0]["switches"]
    assert all(log["fetch"][2] for log in logs)


# ---------------------------------------------------------------------------
# the virtual-clock LiveEngine: twins of tests/test_fetch_controller.py's
# live-engine tests, held against the JAX engine on the same store
# ---------------------------------------------------------------------------

def _live_net(ns, latency=0.04):
    """tests/test_fetch_controller.py::_live_net on the given package."""
    table = ns.adaptive.DecodeTable(
        name="live-test", n_decoders=2,
        latency={r: (latency, latency * 1.25) for r in RES},
        penalty={"240p": 0.01, "480p": 0.008, "640p": 0.004, "1080p": 0.0},
        chunk_size_mb={r: 0.004 for r in RES})
    return table, ns.network.BandwidthTrace.constant(0.0006)  # ~75 kB/s


def _engine_log(eng, reqs):
    """What the two engines must agree on exactly."""
    return dict(outputs=[eng.outputs[r.rid] for r in reqs],
                token_times=[list(r.token_times) for r in reqs],
                early=[r.early_admitted for r in reqs],
                stall=eng.stats.prefill_stall_time,
                switches=list(eng.ctrl.resolution_switches),
                restored=eng.stats.restored_tokens,
                fetched=eng.stats.fetched_bytes)


def _stores(port_params, cfg, prefix, **kw):
    """The port's donor KV for ``prefix`` in the port's KVStore and (the
    same arrays) in the JAX one."""
    from repro.cluster.storage import KVStore as JaxKVStore
    from repro_torch.cluster.storage import KVStore
    from repro_torch.core.chunks import prefix_key
    from repro_torch.serving import paged_model
    kv_k, kv_v = paged_model.donor_prefix_kv(port_params, cfg, prefix)
    ours, ref = KVStore(), JaxKVStore()
    ours.register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=16, **kw)
    ref.register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=16, **kw)
    return ours, ref, prefix_key(prefix)


def _engines(jax_params, port_params, cfg, ours, ref, **kw):
    """(JAX LiveEngine, port LiveEngine) with the same knobs; ``kw`` maps
    each knob to a factory of its value from a package namespace."""
    from repro.serving.engine import LiveEngine as JaxLiveEngine
    from repro_torch.serving.engine import LiveEngine
    return (JaxLiveEngine(jax_params, cfg, ref,
                          **{k: f(JAX) for k, f in kw.items()}),
            LiveEngine(port_params, cfg, ours, device="cpu",
                       **{k: f(PORT) for k, f in kw.items()}))


@pytest.fixture(scope="module")
def port_params(tiny_cfg, tiny_params):
    import jax
    from repro_torch.params import from_numpy
    return from_numpy(jax.tree.map(np.asarray, tiny_params), tiny_cfg,
                      device="cpu")


@pytest.mark.parametrize("link", [
    {},
    {"link_policy": "drr", "link_ramp": "slowstart"},
    {"rto_mode": "fixed", "adaptive": False},
], ids=["fair", "drr_slowstart", "fixed_rto_pinned"])
def test_async_engine_matches_sync_and_is_faster_and_jax(link, tiny_cfg,
                                                         tiny_params,
                                                         port_params):
    """Twin of test_fetch_controller.py's
    test_async_engine_matches_sync_and_is_faster: the port's engine
    keeps every property, and gives the JAX engine's tokens, virtual
    token times, stall time and switch events exactly."""
    cfg = tiny_cfg
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    full = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)])
    plain = rng.integers(0, cfg.vocab_size, 12)
    ours, ref, key = _stores(port_params, cfg, prefix,
                             resolutions=("240p", "480p", "1080p"))
    results = {}
    for mode in ("async", "sync"):
        logs = []
        for eng in _engines(
                tiny_params, port_params, cfg, ours, ref,
                fetch_mode=lambda ns, m=mode: m,
                bandwidth=lambda ns: _live_net(ns)[1],
                decode_table=lambda ns: _live_net(ns)[0],
                **{k: (lambda ns, v=v: v) for k, v in link.items()}):
            r_fetch = eng.submit(full, reuse_prefix=key, reuse_tokens=48,
                                 max_new_tokens=3)
            r_plain = eng.submit(plain, max_new_tokens=3)
            eng.run()
            assert eng.stats.restored_tokens == 48 * 2  # k and v restored
            logs.append(_engine_log(eng, [r_fetch, r_plain]))
        assert logs[1] == logs[0], mode
        results[mode] = (r_fetch, r_plain, logs[1]["outputs"])
    fa, pa, out_a = results["async"]
    fs, ps, out_s = results["sync"]
    assert out_a == out_s  # lossless at the system level
    assert fa.ttft < fs.ttft  # pipelining wins TTFT on a slow link
    assert pa.ttft < 0.1 * fa.ttft  # the plain request is never blocked


def test_engine_early_admission_no_stall_matches_jax():
    """Twin of test_fetch_controller.py's
    test_engine_early_admission_no_stall: a multi-group model with huge
    modeled compute is admitted early and never stalls, losslessly, as
    in the JAX engine."""
    import jax
    from repro.cluster.costmodel import CHIPS as JAX_CHIPS
    from repro.cluster.costmodel import EngineCostModel as JaxCost
    from repro.configs import get_config, reduce_config
    from repro.models import transformer as tf
    from repro_torch.cluster.costmodel import CHIPS, EngineCostModel
    from repro_torch.cluster.storage import KVStore
    from repro_torch.params import from_numpy
    from repro_torch.serving.engine import LiveEngine

    cfg = reduce_config(get_config("lwm-7b"), num_layers=6)  # 2 groups
    jax_params = tf.init_params(cfg, jax.random.PRNGKey(0))
    params = from_numpy(jax.tree.map(np.asarray, jax_params), cfg,
                        device="cpu")
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, cfg.vocab_size, 64)
    full = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 6)])
    ours, ref, key = _stores(params, cfg, prefix, resolutions=("240p",))
    # absurdly low MFU -> per-layer compute dwarfs decode -> admit early
    costs = {id(JAX): JaxCost(cfg, JAX_CHIPS["h20"], 1, mfu=1e-12),
             id(PORT): EngineCostModel(cfg, CHIPS["h20"], 1, mfu=1e-12)}
    logs = []
    for eng in _engines(jax_params, params, cfg, ours, ref,
                        policy=lambda ns: "kvfetcher",
                        fetch_mode=lambda ns: "async",
                        bandwidth=lambda ns: _live_net(ns, 0.001)[1],
                        decode_table=lambda ns: _live_net(ns, 0.001)[0],
                        cost=lambda ns: costs[id(ns)]):
        req = eng.submit(full, reuse_prefix=key, reuse_tokens=64,
                         max_new_tokens=2)
        eng.run()
        assert req.early_admitted
        assert eng.stats.prefill_stall_time == 0.0
        logs.append(_engine_log(eng, [req]))
    assert logs[1] == logs[0]
    # lossless: same generations as a no-reuse engine on the same model
    plain = LiveEngine(params, cfg, KVStore(), device="cpu")
    rr = plain.submit(full, max_new_tokens=2)
    plain.run()
    assert logs[1]["outputs"] == [plain.outputs[rr.rid]]
