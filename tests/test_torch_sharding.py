"""The port's sharding and launch layer on the CPU, against the JAX
package: the rule engine (twins of tests/test_sharding_rules.py, resolved
by both packages), DTensor placements on a real one-rank ``DeviceMesh``,
``shard_hint``, the logical axes of whole trees (leaf coverage, and leaf
for leaf equal to JAX's through the weight bridge's layout), the
per-shard fetch plans, the meshes, the paged cache's DTensor views and
the training launcher's production branch."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import (  # noqa: E402
    DTensor, Replicate, Shard)

from repro import configs as jax_configs  # noqa: E402
from repro.core import fetch as jax_fetch  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.sharding import axes as jax_axes  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import fetch  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.paged.cache import PagedKVCache  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.axes import (  # noqa: E402
    batch_axes, cache_axes, param_axes)
from repro_torch.tree import leaves, tree_map  # noqa: E402


class FakeMesh:
    """Duck-typed mesh: the resolver reads only .shape (a dict)."""
    def __init__(self, shape):
        self.shape = shape


def _resolve(axes, dims, mesh_shape, overlay=None):
    """The spec of both packages' resolvers for one tensor; they must
    agree."""
    specs = []
    for mod in (jax_rules, rules):
        mesh = FakeMesh(mesh_shape)
        prev = (mod._STATE.mesh, mod._STATE.rules)
        merged = dict(mod.DEFAULT_RULES)
        if overlay:
            merged.update(overlay)
        mod._STATE.mesh, mod._STATE.rules = mesh, merged
        try:
            specs.append(tuple(mod.logical_to_pspec(axes, dims, mesh)))
        finally:
            mod._STATE.mesh, mod._STATE.rules = prev
    assert specs[1] == specs[0]
    return specs[1]


def test_rule_tables_equal_jax():
    assert rules.DEFAULT_RULES == jax_rules.DEFAULT_RULES
    assert rules.CONTEXT_PARALLEL_OVERLAY == \
        jax_rules.CONTEXT_PARALLEL_OVERLAY


def test_divisibility_fallback():
    # kv_heads=8 cannot shard over model=16 -> replicated
    spec = _resolve(("batch", "cache_seq", "kv_heads", None),
                    (128, 32768, 8, 128), {"data": 16, "model": 16})
    assert spec == ("data", None, None, None)


def test_round_based_priority_gives_model_to_kv_first():
    overlay = {"cache_seq": [None, "model"]}
    spec = _resolve(("batch", "cache_seq", "kv_heads", None),
                    (128, 32768, 16, 128), {"data": 16, "model": 16},
                    overlay)
    assert spec == ("data", None, "model", None)
    spec = _resolve(("batch", "cache_seq", "kv_heads", None),
                    (128, 32768, 8, 128), {"data": 16, "model": 16},
                    overlay)
    assert spec == ("data", "model", None, None)


def test_multipod_fsdp_tuple_axis():
    spec = _resolve(("vocab", "embed"), (256000, 18432),
                    {"pod": 2, "data": 16, "model": 16})
    assert spec == ("model", ("pod", "data"))


def test_axis_taken_once():
    spec = _resolve(("heads", "mlp"), (64, 49152),
                    {"data": 16, "model": 16})
    assert spec.count("model") == 1


def test_small_dims_never_crash():
    spec = _resolve(("batch", "seq", "embed_act"), (2, 8, 64),
                    {"data": 16, "model": 16})
    assert spec == (None, None, None)


@pytest.fixture(scope="module")
def cpu_mesh():
    return mesh_lib.make_debug_mesh((1, 1), device="cpu")


def test_placements_on_a_cpu_mesh(cpu_mesh):
    """Every dim divides a mesh axis of size 1, so each logical axis with
    a rule takes its first candidate."""
    with rules.activate(cpu_mesh):
        assert rules.active_mesh() is cpu_mesh
        assert rules.placements(("layers", None, None, "kv_heads", None),
                                (32, 128, 16, 32, 128)) == \
            (Replicate(), Shard(3))
        assert rules.placements(("batch", "cache_seq", "kv_heads", None),
                                (2, 64, 4, 8)) == (Shard(0), Shard(2))
        assert rules.placements(("embed", "heads", None),
                                (64, 4, 16)) == (Shard(0), Shard(1))
    assert rules.active_mesh() is None
    # no rule context: no rule, every dim replicated (JAX's P(None, ...))
    assert rules.placements(("batch", "kv_heads"), (2, 4),
                            mesh=cpu_mesh) == (Replicate(), Replicate())
    pod = mesh_lib.make_debug_mesh((1, 1, 1), ("pod", "data", "model"),
                                   device="cpu")
    with rules.activate(pod):
        assert rules.logical_to_pspec(("vocab", "embed"), (64, 32)) == \
            ("model", ("pod", "data"))
        # a tuple entry shards its tensor dim on each of its mesh dims
        assert rules.placements(("vocab", "embed"), (64, 32)) == \
            (Shard(1), Shard(1), Shard(0))


def test_shard_hint(cpu_mesh):
    x = torch.zeros(2, 3)
    assert rules.shard_hint(x, ("batch",)) is x  # no context: no check
    with rules.activate(cpu_mesh):
        with pytest.raises(ValueError,
                           match="shard_hint: 2 axes for rank-3 array"):
            rules.shard_hint(torch.zeros(2, 3, 4), ("batch", "embed"))
        assert rules.shard_hint(x, ("batch", "embed_act")) is x
        d = DTensor.from_local(torch.arange(32.0).reshape(4, 8), cpu_mesh,
                               (Replicate(), Replicate()), run_check=False)
        out = rules.shard_hint(d, ("batch", "mlp"))
        assert out.placements == (Shard(0), Shard(1))
        assert torch.equal(out.full_tensor(),
                           torch.arange(32.0).reshape(4, 8))


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _meta_params(cfg):
    return init_params(cfg, torch.Generator(), device="meta")


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x22b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "deepseek-moe-16b",
                                  "hubert-xlarge", "qwen1.5-110b"])
def test_param_axes_cover_every_leaf(arch):
    params = _meta_params(configs.reduce_config(configs.get_config(arch)))
    fits = leaves(tree_map(lambda x, a: _is_axes(a) and len(a) == x.ndim,
                           params, param_axes(params)))
    assert fits and all(fits)


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_cache_axes_cover_every_leaf(arch):
    cache = tf.init_cache(configs.reduce_config(configs.get_config(arch)),
                          2, 64, device="meta")
    fits = leaves(tree_map(lambda x, a: _is_axes(a) and len(a) == x.ndim,
                           cache, cache_axes(cache)))
    assert fits and all(fits)


def test_batch_axes():
    batch = {"tokens": torch.zeros(2, 8), "labels": torch.zeros(2, 8),
             "patch_embeds": torch.zeros(2, 4, 16)}
    assert batch_axes(batch) == jax_axes.batch_axes(
        {k: np.zeros(v.shape) for k, v in batch.items()}) == {
        "tokens": ("batch", None), "labels": ("batch", None),
        "patch_embeds": ("batch", None, None)}


def _bridged(jtree, n_cycles: int, pattern_len: int):
    """JAX's axes tree in the port's layout (``params.from_numpy``): the
    prefix, each cycle's layers without the leading "layers" axis, the
    rest, as one ``layers`` list."""
    def unstack(node):
        if isinstance(node, dict):
            return {k: unstack(v) for k, v in node.items()}
        assert node[0] == "layers", node
        return node[1:]

    out = {k: v for k, v in jtree.items()
           if k not in ("prefix", "cycles", "rest")}
    layers = list(jtree["prefix"])
    if jtree["cycles"] is not None:
        one = [unstack(jtree["cycles"][f"l{j}"]) for j in range(pattern_len)]
        layers += one * n_cycles
    out["layers"] = layers + list(jtree["rest"])
    return out


@pytest.mark.parametrize("arch", sorted(configs.list_configs()))
def test_param_axes_equal_jax_leaf_for_leaf(arch):
    cfg = configs.reduce_config(configs.get_config(arch))
    jcfg = jax_configs.reduce_config(jax_configs.get_config(arch))
    shapes = jax.eval_shape(lambda k: jax_tf.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    n_cycles = (0 if shapes["cycles"] is None
                else shapes["cycles"]["l0"]["ln1"].shape[0])
    want = _bridged(jax_axes.param_axes(shapes), n_cycles,
                    len(cfg.layer_pattern))
    got = param_axes(_meta_params(cfg))
    assert len(got["layers"]) == cfg.num_layers
    assert got == want


def _refs(subplans):
    return [[(pc.ref.kind, pc.ref.group, pc.ref.chunk) for pc in sp.chunks]
            for sp in subplans]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5])
def test_split_plan_shards_matches_jax(n_shards):
    """Synthetic plans of 3 layer groups (8 layers: 5 shards leave two
    empty) and of 5 (13 layers), restored chunk by chunk in a seeded
    order: equal subplans and equal ready-layer prefixes after every
    restore."""
    rng = np.random.default_rng(n_shards)
    for n_layers, reuse in ((8, 48), (13, 40)):
        ours = fetch.synthetic_plan(3, reuse, n_layers, 16)
        ref = jax_fetch.synthetic_plan(3, reuse, n_layers, 16)
        subs = fetch.split_plan_shards(ours, n_shards)
        jsubs = jax_fetch.split_plan_shards(ref, n_shards)
        assert _refs(subs) == _refs(jsubs)
        n_groups = len({pc.ref.group for pc in ours.chunks})
        assert len(subs) == min(n_shards, n_groups)
        # the subplans share the parent's chunks, and cover each once
        shared = [id(pc) for sp in subs for pc in sp.chunks]
        assert sorted(shared) == sorted(id(pc) for pc in ours.chunks)
        assert fetch.sharded_layers_ready(subs) == 0
        for i, k in enumerate(rng.permutation(len(ours.chunks))):
            ours.chunks[k].t_restored = ref.chunks[k].t_restored = float(i)
            got = fetch.sharded_layers_ready(subs)
            assert got == jax_fetch.sharded_layers_ready(jsubs) \
                == ours.layers_ready()
        assert got == n_layers and all(sp.done for sp in subs)
    assert fetch.sharded_layers_ready([]) == \
        jax_fetch.sharded_layers_ready([]) == 0


def test_debug_mesh_on_the_cpu():
    a = mesh_lib.make_debug_mesh((1, 1), device="cpu")
    b = mesh_lib.make_debug_mesh((1, 1), device="cpu")
    for m in (a, b):
        assert m.mesh_dim_names == ("data", "model")
        assert rules.mesh_sizes(m) == {"data": 1, "model": 1}
        assert m.device_type == "cpu"
    with pytest.raises(RuntimeError, match="world size 1"):
        mesh_lib.make_debug_mesh((2, 2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh_lib.make_debug_mesh((1, 1))


def test_production_mesh_raises_naming_the_count(cpu_mesh):
    with pytest.raises(RuntimeError, match="needs 256 devices, found 1"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 devices, found 1"):
        mesh_lib.make_production_mesh(multi_pod=True)


def test_train_production_branch(cpu_mesh, monkeypatch, capsys):
    """Below 256 cards the branch exits naming the count; past the check
    it lays every parameter leaf of the full-size config out on the
    production mesh (here the one-rank CPU mesh stands in for it)."""
    with pytest.raises(SystemExit,
                       match=r"needs a >=256-card mesh \(1 cards visible\)"):
        train_launcher.main(["--arch", "nemotron-4-340b"])
    monkeypatch.setattr(mesh_lib, "device_count", lambda: 256)
    monkeypatch.setattr(mesh_lib, "make_production_mesh", lambda: cpu_mesh)
    train_launcher.main(["--arch", "nemotron-4-340b"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    cfg = configs.get_config("nemotron-4-340b")
    shapes, layout = train_launcher.production_layout(cfg, cpu_mesh)
    n = len(leaves(shapes))
    assert line == (f"laid out nemotron-4-340b at train_4k on mesh "
                    f"{{'data': 1, 'model': 1}}: {n} parameter leaves, "
                    f"{n - 2 * cfg.num_layers - 1} sharded; materialize "
                    f"the shards and train")
    layer = layout["layers"][0]
    assert layer["attn"]["wq"] == (Shard(0), Shard(1))  # embed, heads
    assert layer["mlp"]["wo"] == (Shard(1), Shard(0))  # embed, mlp
    assert layer["ln1"] == (Replicate(), Replicate())


def test_paged_cache_dtensor_views_share_the_pages(cpu_mesh):
    """A restore through the plain pages is visible through the DTensor
    views, which share their storage; a cache refuses placements that
    would split its pages over more than one rank."""
    cfg = configs.reduce_config(configs.get_config("lwm-7b"))
    cache = PagedKVCache(cfg, n_pages=4, device="cpu")
    with rules.activate(cpu_mesh):
        pl = rules.placements(("layers", None, None, "kv_heads", None),
                              cache.k_pages.shape)
    assert pl == (Replicate(), Shard(3))
    cache.shard(cpu_mesh, pl)
    for view, pages in ((cache.k_dtensor, cache.k_pages),
                        (cache.v_dtensor, cache.v_pages)):
        assert view.placements == pl
        assert view.to_local().data_ptr() == pages.data_ptr()
    cache.add_seq(0, 20)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    q = torch.randint(0, 256, (2, 5, K, hd), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0))
    scales = torch.rand(2, K, generator=torch.Generator().manual_seed(1))
    cache.restore_chunk("k", 0, (0, 1), np.arange(3, 8), q, scales)
    rows = torch.as_tensor(cache.slots_for(0, np.arange(3, 8)))
    want = (q.float() - 128) * scales[:, None, :, None]
    seen = cache.k_dtensor.to_local().view(cfg.num_layers, -1, K, hd)
    assert torch.equal(seen[:2, rows], want)
    assert torch.equal(cache.k_dtensor.full_tensor(), cache.k_pages)
    with pytest.raises(ValueError, match="one rank"):
        cache.shard(FakeMesh((1, 2)), (Replicate(), Shard(3)))
