"""The port's dry run on the CPU: the specs against the JAX package's
(shapes, dtypes, overlays, micro-batching, descriptions and scan trips for
every assigned arch x shape x production mesh), the skip decisions of all
80 combinations, the trace of every assigned arch's reduced config on a
fake (2, 2) mesh, ``ssd_scan``'s custom ops, and the fake group's
teardown.  Nothing here traces a full-size config; the JAX package is
imported only inside the tests that compare with it."""
import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.tensor import DTensor, Shard  # noqa: E402
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication)

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.roofline.trace import recording  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

ARCHS = configs.ASSIGNED_ARCHS
SHAPES = list(configs.INPUT_SHAPES)
MESHES = {"single": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """The JAX functions read only ``mesh.shape`` (a dict)."""
    def __init__(self, shape):
        self.shape = shape


@pytest.fixture
def no_group():
    """No default process group around the test (another test of this
    worker may have left its one-rank group), and none after it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch, shape, mesh_kind):
    import jax.numpy as jnp
    from repro import configs as jax_configs
    from repro.launch import specs as jax_specs
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    s, js = configs.INPUT_SHAPES[shape], jax_configs.INPUT_SHAPES[shape]
    for ours, theirs in ((specs.train_batch_specs(cfg, s),
                          jax_specs.train_batch_specs(jcfg, js, jnp.bfloat16)),
                         (specs.prefill_arg_specs(cfg, s),
                          jax_specs.prefill_arg_specs(jcfg, js,
                                                      jnp.bfloat16))):
        assert list(ours) == list(theirs)
        for k, t in ours.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(theirs[k].shape), k
            assert str(t.dtype).removeprefix("torch.") == \
                str(theirs[k].dtype), k
    mesh = FakeMesh(MESHES[mesh_kind])
    assert specs.decode_overlay(cfg, s, mesh) == \
        jax_specs.decode_overlay(jcfg, js, mesh)
    assert specs.default_accum(cfg, s, mesh) == \
        jax_specs.default_accum(jcfg, js, mesh)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_recipes_describe_as_jax(arch, mesh_kind, no_group):
    """``build_dryrun`` at full width on the production mesh (fake shards:
    nothing allocated, nothing traced): its description and scan trips
    are what the JAX package's ``default_accum`` and ``layer_plan``
    give."""
    from repro import configs as jax_configs
    from repro.launch import specs as jax_specs
    from repro.models import transformer as jax_tf
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    multi = mesh_kind == "multipod"
    with mesh_lib.fake_group(512 if multi else 256):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi, device="cpu")
        for shape in SHAPES:
            s = configs.INPUT_SHAPES[shape]
            if not cfg.shape_supported(s)[0]:
                continue
            with rules.activate(mesh,
                                overlay=specs.decode_overlay(cfg, s, mesh)):
                recipe = specs.build_dryrun(cfg, s, mesh)
            cycles = max(jax_tf.layer_plan(jcfg)[1], 1)
            if s.kind == "train":
                accum = jax_specs.default_accum(
                    jcfg, jax_configs.INPUT_SHAPES[shape],
                    FakeMesh(MESHES[mesh_kind]))
                want = (f"train_step accum={accum}", cycles * accum)
            elif s.kind == "prefill":
                want = ("prefill_step", cycles)
            else:
                want = ("serve_step (1 new token, cached context)", cycles)
            assert (recipe.description, recipe.scan_trips) == want, shape
            leaves = [t for t in torch.utils._pytree.tree_leaves(recipe.args)
                      if isinstance(t, torch.Tensor)]
            assert leaves and all(isinstance(t, DTensor) for t in leaves)
            assert all(t.device_mesh is mesh for t in leaves)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_run_one_skips_as_jax(arch, shape, mesh_kind, tmp_path, monkeypatch):
    """Every combination's skip decision, checked without a trace: a
    skipped one returns at once with the JAX package's reason, and no
    other reaches the trace here."""
    from repro import configs as jax_configs
    jok, jwhy = jax_configs.get_config(arch).shape_supported(
        jax_configs.INPUT_SHAPES[shape])

    class Traced(Exception):
        pass

    def fake_group(n):
        raise Traced(n)

    monkeypatch.setattr(mesh_lib, "fake_group", fake_group)
    if jok:
        with pytest.raises(Traced, match="512" if mesh_kind == "multipod"
                           else "256"):
            dryrun.run_one(arch, shape, mesh_kind, out_dir=str(tmp_path),
                           verbose=False, device="cpu")
        assert not (tmp_path / f"{arch}.{shape}.{mesh_kind}.json").exists()
        return
    rec = dryrun.run_one(arch, shape, mesh_kind, out_dir=str(tmp_path),
                         verbose=False, device="cpu")
    assert rec == {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "status": "skipped", "reason": jwhy}
    with open(tmp_path / f"{arch}.{shape}.{mesh_kind}.json") as f:
        assert json.load(f) == rec


def test_sweep_counts_80_66_14():
    n_ok = sum(configs.get_config(a).shape_supported(
        configs.INPUT_SHAPES[s])[0] for a in ARCHS for s in SHAPES)
    assert (len(ARCHS) * len(SHAPES) * 2, 2 * n_ok) == (80, 66)


REDUCED = {"train": InputShape("train_r", 128, 8, "train"),
           "prefill": InputShape("prefill_r", 128, 4, "prefill"),
           "decode": InputShape("decode_r", 128, 4, "decode")}


@pytest.mark.parametrize("kind", list(REDUCED))
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_trace_on_a_fake_2x2_mesh(arch, kind, no_group, monkeypatch):
    cfg = configs.reduce_config(configs.get_config(arch))
    shape = REDUCED[kind]
    if not cfg.shape_supported(shape)[0]:
        assert arch == "hubert-xlarge" and kind == "decode"
        return
    logits = []
    head = tf.lm_logits
    monkeypatch.setattr(tf, "lm_logits",
                        lambda *a: logits.append(head(*a)) or logits[-1])
    with mesh_lib.fake_group(4):
        mesh = mesh_lib.make_debug_mesh((2, 2), device="cpu")
        with rules.activate(mesh,
                            overlay=specs.decode_overlay(cfg, shape, mesh)):
            recipe = specs.build_dryrun(cfg, shape, mesh)
            with recording(recipe.fake_mode) as tr, implicit_replication():
                recipe.fn(*recipe.args)
            want = rules.placements(("batch", "seq", "vocab"),
                                    logits[0].shape)
    assert logits and all(isinstance(t, DTensor) for t in logits)
    assert all(t.placements == want for t in logits)
    assert tr.flops > 0 and sum(tr.calls.values()) > 0
    # one scan per Mamba2 layer and micro-batch (again in the backward's
    # recompute); decode steps the state without it
    n_ssm = cfg.layer_kinds().count("ssm")
    micro = int(recipe.description.split("accum=")[1]) if kind == "train" \
        else 1
    fwd = {"train": 2, "prefill": 1, "decode": 0}[kind] * n_ssm * micro
    assert tr.calls["repro_torch::ssd_scan_fwd"] == fwd
    assert tr.calls["repro_torch::ssd_scan_bwd"] == (
        n_ssm * micro if kind == "train" else 0)


def test_run_one_records_a_reduced_trace(no_group, tmp_path, monkeypatch):
    """``run_one`` end to end on the production mesh, with a reduced
    config and shape standing in for the full ones."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: configs.reduce_config(
        configs.get_config(a)))
    monkeypatch.setitem(dryrun.INPUT_SHAPES, "prefill_32k",
                        InputShape("prefill_32k", 128, 32, "prefill"))
    rec = dryrun.run_one("mamba2-2.7b", "prefill_32k", "single",
                         out_dir=str(tmp_path), verbose=False, device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256 and rec["description"] == "prefill_step"
    assert set(rec["memory"]) == {"temp_size_in_bytes",
                                  "argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "alias_size_in_bytes"}
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["custom_op_calls"] == {"repro_torch::ssd_scan_fwd": 2}
    assert rec["collectives"]["in_loop"] == 0.0
    assert rec["roofline"]["scan_trips"] == 1 and rec["scan_trips"] == 2
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert "device_memory" not in rec and not dist.is_initialized()


def test_main_prints_the_tally(tmp_path, capsys):
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(tmp_path), "--device",
                 "cpu"])
    assert capsys.readouterr().out.strip() == \
        "done: 0 ok, 2 skipped, 0 errors"


# -- ssd_scan as custom ops ---------------------------------------------------

def _scan_args(s, seed=0):
    g = torch.Generator().manual_seed(seed)

    def f(*shape):
        return torch.randn(*shape, generator=g)

    return (f(2, s, 4, 32), -F.softplus(f(2, s, 4)), f(2, s, 1, 16),
            f(2, s, 1, 16))


@pytest.mark.parametrize("s", [128, 100])
def test_ssd_scan_fake_matches_the_reference(s):
    args = _scan_args(s)
    want = ssd_scan_ref(*args, chunk=64)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in args]
        got = torch.ops.repro_torch.ssd_scan_fwd(*fake, 64)
        dy, dst = torch.empty_like(fake[0]), fake[0].new_empty(2, 4, 32, 16)
        grads = torch.ops.repro_torch.ssd_scan_bwd(*fake, dy, dst, 64)
    for g, w in zip(got, want):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    for g, a in zip(grads, args):
        assert (g.shape, g.dtype) == (a.shape, torch.float32)


@pytest.mark.parametrize("s", [128, 100])
def test_ssd_scan_ops_pass_opcheck_on_cpu(s):
    args = _scan_args(s)
    torch.library.opcheck(torch.ops.repro_torch.ssd_scan_fwd.default,
                          args + (64,))
    g = torch.Generator().manual_seed(1)
    dy, dst = torch.randn(2, s, 4, 32, generator=g), torch.randn(
        2, 4, 32, 16, generator=g)
    torch.library.opcheck(torch.ops.repro_torch.ssd_scan_bwd.default,
                          args + (dy, dst, 64))


def test_ssd_scan_fake_repeats_the_kernel_checks():
    x, a, B, C = _scan_args(128)
    x64, a_short = x.double(), a[:, :-1].contiguous()
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        with pytest.raises(TypeError, match="float32"):
            torch.ops.repro_torch.ssd_scan_fwd(
                mode.from_tensor(x64), *(mode.from_tensor(t)
                                         for t in (a, B, C)), 64)
        with pytest.raises(ValueError, match="do not match"):
            torch.ops.repro_torch.ssd_scan_fwd(
                *(mode.from_tensor(t) for t in (x, a_short, B, C)), 64)


@pytest.mark.parametrize("s", [128, 100, 2048])
def test_ssd_scan_flop_formulas_are_the_counts(s):
    from torch.utils.flop_counter import FlopCounterMode
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        args = [mode.from_tensor(t) for t in _scan_args(min(s, 128))]
        if s == 2048:  # the bound's shape of PERF.md (b 1, nh 80, hd 64)
            args = [torch.empty(1, s, 80, 64), torch.empty(1, s, 80),
                    torch.empty(1, s, 1, 128), torch.empty(1, s, 1, 128)]
        b, sl, nh, hd = args[0].shape
        S = args[2].shape[3]
        with FlopCounterMode(display=False) as fc:
            torch.ops.repro_torch.ssd_scan_fwd(*args, 64)
        assert fc.get_total_flops() == ssd_ops.scan_flops(b, sl, nh, hd, 1,
                                                          S, 64)
        dy, dst = torch.empty_like(args[0]), torch.empty(b, nh, hd, S)
        with FlopCounterMode(display=False) as fc:
            torch.ops.repro_torch.ssd_scan_bwd(*args, dy, dst, 64)
        assert fc.get_total_flops() == ssd_ops.scan_bwd_flops(
            b, sl, nh, hd, 1, S, 64)
    if s == 2048:
        assert round(ssd_ops.scan_flops(1, s, 80, 64, 1, 128, 64) / 1e9,
                     2) == 6.07
        assert round(ssd_ops.scan_bwd_flops(1, s, 80, 64, 1, 128, 64) / 1e9,
                     2) == 17.53


# -- the fake group ------------------------------------------------------------

def test_fake_group_is_torn_down(no_group):
    with mesh_lib.fake_group(512):
        assert dist.get_world_size() == 512
        with pytest.raises(RuntimeError, match="world size 512 exists"):
            with mesh_lib.fake_group(256):
                pass
        mesh = mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
        assert rules.mesh_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
    assert not dist.is_initialized()
    mesh = mesh_lib.make_debug_mesh((1, 1), device="cpu")
    assert rules.mesh_sizes(mesh) == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="world size 1 exists"):
        with mesh_lib.fake_group(256):
            pass


def test_production_mesh_defaults_to_the_card(no_group):
    with mesh_lib.fake_group(256):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                mesh_lib.make_production_mesh()


def test_rule_context_reaches_other_threads(no_group):
    """The backward of CUDA tensors runs on an autograd device thread: a
    local region there still sees the step's rule context."""
    import threading
    seen = []
    with mesh_lib.fake_group(4):
        mesh = mesh_lib.make_debug_mesh((2, 2), device="cpu")
        with rules.activate(mesh, overlay={"cache_seq": [None, "model"]}):
            t = threading.Thread(target=lambda: seen.append(
                (rules.active_mesh(), rules.placements(
                    ("batch", "cache_seq"), (4, 8)))))
            t.start()
            t.join()
    assert seen == [(mesh, (Shard(0), Shard(1)))]
