"""The port's LiveEngine on the CPU: the torch twin of
tests/test_live_engine.py::test_engine_reuse_matches_full_prefill, run
against the port's own KVStore and held against the JAX LiveEngine on the
same submits; each knob of the virtual-clock pipeline held against the
JAX engine; the mesh-sharded engine's per-shard flows held against the
JAX engine's; the refusal of the JAX package's stores."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster.storage import KVStore as JaxKVStore  # noqa: E402
from repro.serving.engine import LiveEngine as JaxLiveEngine  # noqa: E402

from repro_torch.cluster.storage import KVStore  # noqa: E402
from repro_torch.core.chunks import prefix_key  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import LiveEngine  # noqa: E402

STORE_KW = dict(tokens_per_chunk=16, resolutions=("240p",))


@pytest.fixture(scope="module")
def torch_params(tiny_cfg, tiny_params):
    return from_numpy(jax.tree.map(np.asarray, tiny_params), tiny_cfg,
                      device="cpu")


@pytest.fixture(scope="module")
def stores(tiny_cfg, torch_params):
    """Factory: the port's donor KV for ``prefix``, registered in the
    port's KVStore and (the same arrays) in the JAX one."""
    def _make(prefix, **kw):
        kv_k, kv_v = paged_model.donor_prefix_kv(torch_params, tiny_cfg,
                                                 prefix)
        ours, ref = KVStore(), JaxKVStore()
        ours.register_prefix(prefix, kv_k, kv_v, **{**STORE_KW, **kw})
        ref.register_prefix(prefix, kv_k, kv_v, **{**STORE_KW, **kw})
        assert ours.stored_bytes() == ref.stored_bytes()
        return ours, ref, prefix_key(prefix)
    return _make


def _serve(engine, submits):
    reqs = [engine.submit(toks, **kw) for toks, kw in submits]
    engine.run()
    assert all(r.t_first_token is not None for r in reqs)
    assert len(engine.finished) == len(reqs)
    return [engine.outputs[r.rid] for r in reqs]


@pytest.mark.parametrize("policy", ["kvfetcher", "fetch_agnostic"])
def test_engine_reuse_matches_full_prefill_and_jax(policy, tiny_cfg,
                                                   tiny_params, torch_params,
                                                   stores):
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, tiny_cfg.vocab_size, 48)
    full = np.concatenate([prefix, rng.integers(0, tiny_cfg.vocab_size, 8)])
    ours, ref, key = stores(prefix)
    reuse = dict(reuse_prefix=key, reuse_tokens=48, max_new_tokens=4)

    eng_a = LiveEngine(torch_params, tiny_cfg, KVStore(), policy=policy,
                       device="cpu")
    (out_a,) = _serve(eng_a, [(full, dict(max_new_tokens=4))])
    eng_b = LiveEngine(torch_params, tiny_cfg, ours, policy=policy,
                       device="cpu")
    (out_b,) = _serve(eng_b, [(full, reuse)])
    assert eng_b.stats.restored_tokens == 48 * 2  # k and v
    assert eng_b.stats.fetched_bytes > 0
    assert out_a == out_b  # lossless at the system level
    assert eng_b.stats.restore_buffer_high_water < 1_000_000

    jax_b = JaxLiveEngine(tiny_params, tiny_cfg, ref, policy=policy)
    (want,) = _serve(jax_b, [(full, reuse)])
    assert out_b == want
    assert eng_b.stats.restored_tokens == jax_b.stats.restored_tokens
    assert eng_b.stats.fetched_bytes == jax_b.stats.fetched_bytes
    assert eng_b.stats.restore_buffer_high_water == \
        jax_b.stats.restore_buffer_high_water


def test_engine_mixed_batch_matches_jax(tiny_cfg, tiny_params, torch_params,
                                        stores):
    """One reuse and one plain request decode in the same batch."""
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, tiny_cfg.vocab_size, 32)
    ours, ref, key = stores(prefix)
    rng2 = np.random.default_rng(3)
    submits = [
        (np.concatenate([prefix, rng2.integers(0, tiny_cfg.vocab_size, 4)]),
         dict(reuse_prefix=key, reuse_tokens=32, max_new_tokens=3)),
        (rng2.integers(0, tiny_cfg.vocab_size, 16), dict(max_new_tokens=3)),
    ]
    streamed = []
    eng = LiveEngine(torch_params, tiny_cfg, ours, max_running=4,
                     device="cpu",
                     on_token=lambda r, t, _: streamed.append((r.rid, t)))
    got = _serve(eng, submits)
    jax_eng = JaxLiveEngine(tiny_params, tiny_cfg, ref, max_running=4)
    assert got == _serve(jax_eng, submits)
    assert eng.stats.restored_tokens == jax_eng.stats.restored_tokens == 64
    assert eng.stats.fetched_bytes == jax_eng.stats.fetched_bytes
    assert sorted(streamed) == sorted((rid, t) for rid, out in enumerate(got)
                                      for t in out)


@pytest.fixture(scope="module")
def sharded_model():
    """A reduced lwm-7b of 8 layers (3 layer groups, so the shards really
    split) in both packages from one JAX init, and the port's donor KV of
    a 48-token prefix; a suffix and a plain prompt."""
    from repro import configs as jax_configs
    from repro.models import transformer as jax_tf

    from repro_torch import configs

    cfg = configs.reduce_config(configs.get_config("lwm-7b"), num_layers=8)
    jcfg = jax_configs.reduce_config(jax_configs.get_config("lwm-7b"),
                                     num_layers=8)
    jp = jax_tf.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    kv = paged_model.donor_prefix_kv(params, cfg, prefix)
    return dict(cfg=cfg, jcfg=jcfg, jp=jp, params=params, prefix=prefix,
                kv=kv, suffix=rng.integers(0, cfg.vocab_size, 8),
                plain=rng.integers(0, cfg.vocab_size, 8))


def _packages():
    """(JAX modules, port modules) of a sharded engine run."""
    import types

    import repro.cluster.fairness as j_fair
    import repro.cluster.network as j_net
    import repro.cluster.storage as j_storage
    import repro_torch.cluster.fairness as t_fair
    import repro_torch.cluster.network as t_net
    import repro_torch.cluster.storage as t_storage
    return tuple(types.SimpleNamespace(
        LiveEngine=eng, StorageCluster=st.StorageCluster,
        StorageNode=st.StorageNode, BandwidthTrace=net.BandwidthTrace,
        FairScheduler=fair.FairScheduler)
        for eng, st, net, fair in ((JaxLiveEngine, j_storage, j_net, j_fair),
                                   (LiveEngine, t_storage, t_net, t_fair)))


def _sharded_run(m, params, cfg, model, *, fetch_mode, mesh_shards,
                 fairness=False, **kw):
    """One reuse and one plain request through a one-node cluster on the
    virtual clock; the reuse request's restored rows are read at its
    first token."""
    cluster = m.StorageCluster([m.StorageNode("n0")])
    cluster.register_prefix(model["prefix"], *model["kv"],
                            tokens_per_chunk=16, resolutions=("240p",))
    fair = m.FairScheduler(max_inflight=1) if fairness else None
    pages = {}

    def on_token(req, tok, t):
        if len(req.token_times) == 1 and req.reuse_tokens:
            ps = eng.cache.page_size
            bt = np.asarray(eng.cache.seqs[req.rid].block_table)
            idx = np.arange(req.reuse_tokens)
            rows = bt[idx // ps] * ps + idx % ps
            for kind, a in (("k", eng.cache.k_pages),
                            ("v", eng.cache.v_pages)):
                a = np.asarray(a)
                pages[kind] = a.reshape(a.shape[0], -1, *a.shape[3:])[:,
                                                                      rows]

    eng = m.LiveEngine(params, cfg, cluster, fetch_mode=fetch_mode,
                       bandwidth=m.BandwidthTrace.constant(0.0006),
                       mesh_shards=mesh_shards, fairness=fair,
                       on_token=on_token, **kw)
    users = dict(user="alice", slo_tier="premium") if fairness else {}
    others = dict(user="bob", slo_tier="standard") if fairness else {}
    reqs = [eng.submit(np.concatenate([model["prefix"], model["suffix"]]),
                       reuse_prefix="by-tokens", reuse_tokens=48,
                       max_new_tokens=3, **users),
            eng.submit(model["plain"], max_new_tokens=3, **others)]
    eng.run()
    assert eng.n_shards == mesh_shards
    assert not eng._sharded  # every shard completed and untracked
    log = dict(outputs=[eng.outputs[r.rid] for r in reqs],
               times=[list(r.token_times) for r in reqs],
               fetch=[(r.fetch_started, r.fetch_done, r.layers_ready,
                       r.storage_hit) for r in reqs],
               stats=dataclasses.asdict(eng.stats),
               events=list(cluster.events),
               fair=list(fair.events) if fairness else None)
    return log, pages, cluster


def _check_sharded_twin(sharded_model, monkeypatch, fetch_mode, mesh_shards,
                        fairness=False):
    """The port's sharded engine on a (1, 1) CPU mesh against the JAX
    engine with ``mesh=None`` and the same ``mesh_shards`` (the JAX
    engine's own mesh path fails in its Pallas kernel on the CPU, so it
    runs the per-shard flows without laying the pages out)."""
    import repro_torch.paged.cache as cache_mod
    import repro_torch.serving.engine as engine_mod
    from repro_torch.launch.mesh import make_debug_mesh

    model = sharded_model
    calls, splits = [], []
    restore = cache_mod.kv_restore_layers
    monkeypatch.setattr(cache_mod, "kv_restore_layers",
                        lambda *a, **k: calls.append(1) or restore(*a, **k))
    split = engine_mod.split_plan_shards
    monkeypatch.setattr(engine_mod, "split_plan_shards",
                        lambda *a: splits.append(split(*a)) or splits[-1])
    jax_m, ours = _packages()
    want, want_pages, _ = _sharded_run(
        jax_m, model["jp"], model["jcfg"], model, fetch_mode=fetch_mode,
        mesh_shards=mesh_shards, fairness=fairness)
    mesh = make_debug_mesh((1, 1), device="cpu")
    got, got_pages, cluster = _sharded_run(
        ours, model["params"], model["cfg"], model, fetch_mode=fetch_mode,
        mesh_shards=mesh_shards, fairness=fairness, mesh=mesh, device="cpu")
    assert got == want
    assert got["fetch"][0][1] is not None and got["fetch"][0][3] == "full"
    for kind in ("k", "v"):
        assert np.array_equal(got_pages[kind], want_pages[kind]), kind
    man = next(iter(cluster.catalog.values())).manifest
    assert len(calls) == len(man.refs) == 3 * 3 * 2  # one per chunk
    (subs,) = splits
    assert len(subs) == min(mesh_shards, 3) and all(sp.chunks for sp in subs)
    return got


@pytest.mark.parametrize("mesh_shards", [2, 3])
@pytest.mark.parametrize("fetch_mode", ["sync", "async"])
def test_mesh_sharded_engine_matches_jax(fetch_mode, mesh_shards,
                                         sharded_model, monkeypatch):
    """Twin of test_fleet.py::test_mesh_sharded_engine_matches_unsharded:
    per-shard fetch plans through the one controller, with equal tokens,
    token times, fetch times, stats and cluster events, restored pages
    bit-equal and one ``kv_restore_layers`` call per chunk."""
    _check_sharded_twin(sharded_model, monkeypatch, fetch_mode, mesh_shards)


def test_mesh_sharded_engine_charges_fairness_once_as_jax(sharded_model,
                                                          monkeypatch):
    """Shadow requests leave the fairness bookkeeping alone: the real
    request is charged once, when its last shard lands, and the fairness
    log equals the JAX engine's."""
    got = _check_sharded_twin(sharded_model, monkeypatch, "async", 3,
                              fairness=True)
    # (user, rid, kind, counter): one charge of alice's whole fetch
    fetched = [e for e in got["fair"] if e[2] == "fetched"]
    assert len(fetched) == 1 and fetched[0][:2] == ("alice", 0)
    assert fetched[0][3] > 0


def test_external_dispatch_matches_jax(tiny_cfg, tiny_params, torch_params,
                                       monkeypatch):
    """``external_dispatch=True``: ``step()`` takes no fetch itself; the
    caller drains the fair backlog and hands each fetch to
    ``dispatch_fetch``, or to ``local_restore`` for a prefix it has
    already fetched (a real restore at zero virtual network time, one
    ``kv_restore_layers`` call per chunk).  The port's engine and the
    JAX engine, driven the same way, give equal tokens, token times,
    hit kinds and fairness and cluster events."""
    import repro.cluster.costmodel as j_cost
    import repro.cluster.fairness as j_fair
    import repro.cluster.network as j_net
    import repro.cluster.storage as j_storage
    import repro.core.adaptive as j_adaptive
    import repro_torch.cluster.costmodel as t_cost
    import repro_torch.cluster.fairness as t_fair
    import repro_torch.cluster.network as t_net
    import repro_torch.cluster.storage as t_storage
    import repro_torch.core.adaptive as t_adaptive
    import repro_torch.paged.cache as cache_mod

    restores = []
    real = cache_mod.kv_restore_layers
    monkeypatch.setattr(cache_mod, "kv_restore_layers",
                        lambda *a, **kw: restores.append(1) or real(*a,
                                                                    **kw))
    rng = np.random.default_rng(21)
    prefixes = [rng.integers(0, tiny_cfg.vocab_size, n) for n in (48, 32)]
    suffix = rng.integers(0, tiny_cfg.vocab_size, 8)
    kvs = [paged_model.donor_prefix_kv(torch_params, tiny_cfg, p)
           for p in prefixes]
    # (user, tier, prefix index): the third ask repeats the first prefix
    script = [("bob", "free", 0), ("alice", "premium", 1),
              ("bob", "free", 0), ("alice", "premium", 0)]
    runs = []
    for (engine_cls, params, kw, storage, fair, net, adaptive, cost) in (
            (JaxLiveEngine, tiny_params, {}, j_storage, j_fair, j_net,
             j_adaptive, j_cost),
            (LiveEngine, torch_params, {"device": "cpu"}, t_storage, t_fair,
             t_net, t_adaptive, t_cost)):
        cluster = storage.StorageCluster(
            [storage.StorageNode("n0"), storage.StorageNode("n1")],
            replication=1, heal="manual")
        keys = [cluster.register_prefix(p, k, v, **STORE_KW).key
                for p, (k, v) in zip(prefixes, kvs)]
        fairness = fair.FairScheduler(max_inflight=1)
        eng = engine_cls(
            params, tiny_cfg, cluster, policy="kvfetcher", max_running=8,
            fetch_mode="sync", bandwidth=net.BandwidthTrace.constant(0.0006),
            decode_table=adaptive.DecodeTable(
                name="dispatch-toy", n_decoders=1,
                latency={"240p": (0.06,)}, penalty={"240p": 0.0},
                chunk_size_mb={"240p": 0.002}),
            use_table_sizes=True, adaptive=False, resolution="240p",
            resolutions=("240p",),
            cost=cost.EngineCostModel(tiny_cfg, cost.CHIPS["h20"], 2),
            fairness=fairness, external_dispatch=True, **kw)
        reqs = [eng.submit(np.concatenate([prefixes[i], suffix]),
                           reuse_prefix=keys[i],
                           reuse_tokens=len(prefixes[i]), max_new_tokens=3,
                           user=user, slo_tier=tier, rid=10 + 7 * n)
                for n, (user, tier, i) in enumerate(script)]
        eng.step()
        assert all(r.fetch_started is None for r in reqs), \
            "step() dispatched a fetch itself"
        fetched, local, n_restores = set(), [], {}
        for _ in range(1000):
            work = eng.step()
            ready = fairness.take()
            for req in ready:
                before = len(restores)
                if req.prefix in fetched:
                    req.storage_hit = "local"
                    eng.local_restore(req)
                    eng.sched.schedule(eng.now())
                    local.append(req.rid)
                else:
                    eng.dispatch_fetch(req)
                    fetched.add(req.prefix)
                n_restores[req.rid] = len(restores) - before
            if not work and not ready:
                break
        assert len(eng.finished) == len(reqs)
        runs.append(dict(
            tokens={r.rid: eng.outputs[r.rid] for r in reqs},
            times={r.rid: list(r.token_times) for r in reqs},
            fetch={r.rid: (r.fetch_started, r.fetch_done) for r in reqs},
            hits={r.rid: (r.storage_hit, r.storage_node) for r in reqs},
            local=local, fairness=list(fairness.events),
            cluster=list(cluster.events)))
        if engine_cls is LiveEngine:
            chunks = {k: len(cluster.catalog[k].manifest.refs) for k in keys}
            assert {r.rid: n_restores[r.rid] for r in reqs} == \
                {r.rid: chunks[r.prefix] for r in reqs}
            assert not eng._fetch_scales, "the scales were not freed"
    jax_run, port_run = runs
    for what in jax_run:
        assert port_run[what] == jax_run[what], what
    assert sorted(port_run["local"]) == [24, 31]
    # a local restore takes no virtual network time
    for rid in port_run["local"]:
        assert port_run["fetch"][rid][0] == port_run["fetch"][rid][1]
    assert {k for _, _, k, _ in port_run["fairness"]} >= \
        {"arrive", "dispatch", "fetched", "serve"}


RES = ("240p", "480p", "640p", "1080p")


def _table(mod):
    return mod.DecodeTable(
        name="live-test", n_decoders=2,
        latency={r: (0.04, 0.05) for r in RES},
        penalty={"240p": 0.01, "480p": 0.008, "640p": 0.004, "1080p": 0.0},
        chunk_size_mb={r: 0.004 for r in RES})


#: each knob of the virtual-clock pipeline, as a factory of its value from
#: (adaptive module, network module, costmodel module, config)
VIRTUAL_KNOBS = {
    "bandwidth": lambda a, n, c, cfg: n.BandwidthTrace.constant(0.0006),
    "loss": lambda a, n, c, cfg: n.LossModel.bernoulli(0.3, seed=4),
    "link_policy": lambda a, n, c, cfg: "drr",
    "link_ramp": lambda a, n, c, cfg: "slowstart",
    "rto_mode": lambda a, n, c, cfg: "fixed",
    "use_table_sizes": lambda a, n, c, cfg: True,
    "adaptive": lambda a, n, c, cfg: True,
    "resolutions": lambda a, n, c, cfg: ("480p", "1080p"),
    "decode_table": lambda a, n, c, cfg: _table(a),
    "cost": lambda a, n, c, cfg: c.EngineCostModel(cfg, c.CHIPS["a100"], 2),
    "fetch_mode": lambda a, n, c, cfg: "async",
}


@pytest.mark.parametrize("knob", sorted(VIRTUAL_KNOBS))
def test_engine_takes_virtual_clock_knob_as_jax(knob, tiny_cfg, tiny_params,
                                                torch_params, stores):
    """Each knob of the virtual-clock pipeline is live: on a trace, with
    the knob set, the port's engine gives the JAX engine's tokens,
    virtual token times, stall time, switch events and restore counts."""
    import repro.cluster.costmodel as j_cost
    import repro.cluster.network as j_net
    import repro.core.adaptive as j_adaptive
    import repro_torch.cluster.costmodel as t_cost
    import repro_torch.cluster.network as t_net
    import repro_torch.core.adaptive as t_adaptive

    rng = np.random.default_rng(7)
    prefix = rng.integers(0, tiny_cfg.vocab_size, 32)
    full = np.concatenate([prefix, rng.integers(0, tiny_cfg.vocab_size, 4)])
    plain = rng.integers(0, tiny_cfg.vocab_size, 8)
    ours, ref, key = stores(prefix, resolutions=("240p", "480p", "1080p"))
    logs = []
    for eng_cls, params, store, mods, kw in (
            (JaxLiveEngine, tiny_params, ref, (j_adaptive, j_net, j_cost),
             {}),
            (LiveEngine, torch_params, ours, (t_adaptive, t_net, t_cost),
             {"device": "cpu"})):
        knobs = {"bandwidth": VIRTUAL_KNOBS["bandwidth"](*mods, tiny_cfg)}
        if knob in ("adaptive", "resolutions", "use_table_sizes"):
            knobs["decode_table"] = _table(mods[0])  # what they steer
        knobs[knob] = VIRTUAL_KNOBS[knob](*mods, tiny_cfg)
        eng = eng_cls(params, tiny_cfg, store, **knobs, **kw)
        reqs = [eng.submit(full, reuse_prefix=key, reuse_tokens=32,
                           max_new_tokens=2),
                eng.submit(plain, max_new_tokens=2)]
        eng.run()
        assert all(r.t_first_token is not None for r in reqs)
        logs.append(dict(
            outputs=[eng.outputs[r.rid] for r in reqs],
            token_times=[list(r.token_times) for r in reqs],
            stall=eng.stats.prefill_stall_time,
            switches=list(eng.ctrl.resolution_switches),
            retransmits=eng.ctrl.retransmits_total,
            restored=eng.stats.restored_tokens,
            fetched=eng.stats.fetched_bytes))
    assert logs[1] == logs[0]
    assert logs[1]["restored"] == 32 * 2
    if knob == "loss":
        assert logs[1]["retransmits"] > 0


@pytest.mark.parametrize("knob,value", [
    ("fetch_mode", "async"), ("loss", object()), ("link_policy", "drr"),
    ("link_ramp", "slowstart"),
])
def test_wall_clock_engine_refuses_wan_options_as_jax(knob, value, tiny_cfg,
                                                      tiny_params,
                                                      torch_params):
    """Without a bandwidth trace the WAN options are refused, as by the
    JAX engine (which asserts)."""
    with pytest.raises(AssertionError, match="need a bandwidth trace"):
        JaxLiveEngine(tiny_params, tiny_cfg, JaxKVStore(), **{knob: value})
    with pytest.raises(ValueError, match="need a bandwidth trace"):
        LiveEngine(torch_params, tiny_cfg, KVStore(), device="cpu",
                   **{knob: value})


def test_engine_refuses_other_stores(tiny_cfg, torch_params):
    """The JAX package's stores are not the port's: both are refused."""
    from repro.cluster.storage import StorageCluster as JaxStorageCluster
    from repro.cluster.storage import StorageNode as JaxStorageNode
    for store in (JaxKVStore(),
                  JaxStorageCluster([JaxStorageNode("n0")])):
        with pytest.raises(TypeError, match="repro_torch.cluster.storage"):
            LiveEngine(torch_params, tiny_cfg, store, device="cpu")


def test_entry_points_raise_without_a_card_unless_told_cpu(tiny_cfg,
                                                           torch_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.paged.cache import PagedKVCache
    from repro_torch.params import init_params
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LiveEngine(torch_params, tiny_cfg, KVStore())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(tiny_cfg, n_pages=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tiny_cfg, torch.Generator())


#: (arch, layers, prefix length, suffix length) of the MoE engine twins:
#: deepseek with its dense first layer and a one-layer remainder group
#: (4 layers: groups of 3 and 1), mixtral with prompts past its reduced
#: 64-token window
MOE_ENGINES = [("deepseek-moe-16b", 4, 48, 8), ("mixtral-8x22b", 2, 64, 16)]


@pytest.mark.parametrize("arch,layers,n_pre,n_suf", MOE_ENGINES)
def test_moe_engine_matches_jax(arch, layers, n_pre, n_suf):
    """Reduced MoE models served by the port's engine and the JAX one from
    the same weights and donor KV: a reuse request (its suffix routes as
    one group, whose capacity drops choices at full width), a plain one
    and a second reuse request, batched in decode.  The port routes as
    the JAX package does (``configs.jax_routing``)."""
    from repro import configs as jax_configs
    from repro.models import transformer as jax_tf

    from repro_torch import configs

    cfg = configs.jax_routing(configs.reduce_config(configs.get_config(arch),
                                                    num_layers=layers))
    jcfg = jax_configs.reduce_config(jax_configs.get_config(arch),
                                     num_layers=layers)
    jp = jax_tf.init_params(jcfg, jax.random.PRNGKey(4))
    params = from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab_size, n_pre)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    ours, ref = KVStore(), JaxKVStore()
    for store in (ours, ref):
        man = store.register_prefix(prefix, kv_k, kv_v, **STORE_KW)
    if arch == "deepseek-moe-16b":
        assert [len(g) for g in man.layer_groups] == [3, 1]
    reuse = dict(reuse_prefix=prefix_key(prefix), reuse_tokens=n_pre,
                 max_new_tokens=4)
    submits = [
        (np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n_suf)]),
         reuse),
        (rng.integers(0, cfg.vocab_size, n_pre + n_suf),
         dict(max_new_tokens=4)),
        (np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n_suf)]),
         reuse),
    ]
    eng = LiveEngine(params, cfg, ours, max_running=4, device="cpu")
    got = _serve(eng, submits)
    jax_eng = JaxLiveEngine(jp, jcfg, ref, max_running=4)
    assert got == _serve(jax_eng, submits)
    assert eng.stats.restored_tokens == jax_eng.stats.restored_tokens \
        == 2 * 2 * len(man.layer_groups) * n_pre
    assert eng.stats.fetched_bytes == jax_eng.stats.fetched_bytes > 0
