"""The port's roofline against the JAX package's: the analytic FLOP
counts, the report's arithmetic under the H100's constants, and the
trace recorder's counters held to hand counts on a fake (2, 2) mesh,
and the report's table."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    DTensor, Partial, Replicate, Shard)
import torch.distributed.tensor as dtensor  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.roofline.trace import recording  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

SHAPES = list(configs.INPUT_SHAPES)


@pytest.fixture
def no_group():
    """No default process group around the test (another test of this
    worker may have left its one-rank group), and none after it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", configs.list_configs())
def test_analytic_and_model_flops_equal_jax(name, shape):
    from repro import configs as jax_configs
    from repro.roofline import analysis as jax_analysis
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    s, js = configs.INPUT_SHAPES[shape], jax_configs.INPUT_SHAPES[shape]
    np.testing.assert_allclose(analysis.analytic_flops(cfg, s),
                               jax_analysis.analytic_flops(jcfg, js),
                               rtol=1e-12)
    np.testing.assert_allclose(analysis.model_flops(cfg, s),
                               jax_analysis.model_flops(jcfg, js),
                               rtol=1e-12)


# tests/test_roofline.py's inputs, then the same without the bytes split,
# a decode with no loop split, and a prefill whose collectives dominate
REPORT_CASES = [
    ("yi-9b", "train_4k", {"flops": 1e12, "bytes accessed": 1e12},
     {"total": 1e9, "in_loop": 1e9, "outside": 0.0}, 10,
     {"bytes_in_loop": 1e11, "bytes_outside": 5e10}),
    ("yi-9b", "train_4k", {"flops": 1e12, "bytes accessed": 1e12},
     {"total": 1e9, "in_loop": 1e9, "outside": 0.0}, 10, None),
    ("mixtral-8x22b", "decode_32k", {"flops": 1e9, "bytes accessed": 4e12},
     {"total": 2e8}, 1, None),
    ("mamba2-2.7b", "prefill_32k", {"flops": 3e13, "bytes accessed": 1e11},
     {"total": 5e10, "in_loop": 4e10, "outside": 1e10}, 64,
     {"bytes_in_loop": 1e9, "bytes_outside": 2e9}),
]


@pytest.mark.parametrize("case", range(len(REPORT_CASES)))
def test_roofline_report_scales_jax_by_the_constants(case):
    from repro import configs as jax_configs
    from repro.roofline import analysis as jax_analysis
    name, shape, cost, coll, trips, split = REPORT_CASES[case]
    got = analysis.roofline_report(
        configs.get_config(name), configs.INPUT_SHAPES[shape], cost, coll,
        256, scan_trips=trips, bytes_split=split)
    want = jax_analysis.roofline_report(
        jax_configs.get_config(name), jax_configs.INPUT_SHAPES[shape], cost,
        coll, 256, scan_trips=trips, bytes_split=split)
    ratio = {"compute_s": jax_analysis.PEAK_FLOPS / analysis.PEAK_FLOPS,
             "memory_s": jax_analysis.HBM_BW / analysis.HBM_BW,
             "collective_s": jax_analysis.LINK_BW / analysis.LINK_BW}
    for term, r in ratio.items():
        np.testing.assert_allclose(got[term], want[term] * r, rtol=1e-12)
    terms = {t: got[t] for t in ratio}
    assert got["dominant"] == max(terms, key=terms.get) == want["dominant"]
    for key in ("model_flops_total", "model_flops_per_device",
                "analytic_flops_per_device", "scan_trips",
                "useful_flops_ratio", "hlo_flops_per_device",
                "hlo_bytes_per_device", "hlo_flops_raw",
                "collective_bytes"):
        assert got[key] == want[key], key


def test_h100_constants():
    assert analysis.PEAK_FLOPS == 989e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.LINK_BW == 50e9
    assert (analysis.DEVICE, analysis.POWER_LIMIT_W) == (
        "NVIDIA H100 80GB HBM3", 700)


def test_trace_counts_a_sharded_product_pair_by_hand(no_group):
    """x [m, k] on the data axis times w1 [k, n] on the model axis, then
    times w2 [n, k] split on its rows: each product runs on this rank's
    shards (2 m k n / 4 FLOPs each), and the second leaves partial sums
    that one all-reduce of the local result completes."""
    m, k, n = 64, 32, 48
    with mesh_lib.fake_group(4):
        mesh = mesh_lib.make_debug_mesh((2, 2), device="cpu")
        fake = torch._subclasses.fake_tensor.FakeTensorMode()
        with fake:
            x = dtensor.empty((m, k), device_mesh=mesh,
                              placements=(Shard(0), Replicate()))
            w1 = dtensor.empty((k, n), device_mesh=mesh,
                               placements=(Replicate(), Shard(1)))
            w2 = dtensor.empty((n, k), device_mesh=mesh,
                               placements=(Replicate(), Shard(0)))
        with recording(fake) as tr:
            h = x @ w1
            out = h @ w2
            assert out.placements == (Shard(0), Partial())
            out = out.redistribute(mesh, (Shard(0), Replicate()))
        assert isinstance(out, DTensor)
    assert tr.flops == 2 * (2 * m * k * n / 4)
    coll = analysis.collective_bytes_from_trace(tr)
    assert coll["counts"] == {"all-gather": 0, "all-reduce": 1,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    assert coll["all-reduce"] == coll["total"] == coll["outside"] \
        == (m // 2) * k * 4
    assert coll["in_loop"] == 0.0
    # two products of fresh results: [m/2, n/2] and [m/2, k], read + write
    split = analysis.bytes_split_from_trace(tr)
    assert split == {"bytes_in_loop": 0.0,
                     "bytes_outside": 2.0 * 4 * (m // 2 * n // 2
                                                 + m // 2 * k)}


def test_trace_sees_local_shapes_under_a_rule_context(no_group):
    """A product through ``rules.einsum``: the FSDP weight is gathered,
    the output laid out by its logical axes, FLOPs counted per device."""
    b, s, d, f = 8, 16, 32, 64
    with mesh_lib.fake_group(4):
        mesh = mesh_lib.make_debug_mesh((2, 2), device="cpu")
        fake = torch._subclasses.fake_tensor.FakeTensorMode()
        with rules.activate(mesh):
            with fake:
                x = dtensor.empty((b, s, d), device_mesh=mesh,
                                  placements=rules.placements(
                                      ("batch", "seq", "embed_act"),
                                      (b, s, d)))
                w = dtensor.empty((d, f), device_mesh=mesh,
                                  placements=rules.placements(
                                      ("embed", "mlp"), (d, f)))
            with recording(fake) as tr:
                h = rules.einsum("bsd,df->bsf", x, w,
                                 ("batch", "seq", None), (None, "mlp"),
                                 ("batch", "seq", "mlp"))
                assert h.placements == (Shard(0), Shard(2))
                assert h.to_local().shape == (b // 2, s, f // 2)
    assert tr.flops == 2 * (b // 2) * s * d * (f // 2)
    # the weight's FSDP dim gathered over "data": one all-gather of its
    # local [d, f/2] result
    assert tr.collective_counts["all-gather"] == 1
    assert tr.collectives["all-gather"] == d * (f // 2) * 4


def test_report_table_equals_jax(tmp_path):
    """The same records render the same table in both packages, and
    ``load`` reads a directory of them."""
    from repro.roofline import report as jax_report
    from repro_torch.roofline import report
    recs = [{"arch": "yi-9b", "shape": "train_4k", "mesh": "single",
             "status": "ok", "description": "train_step accum=4",
             "memory": {"argument_size_in_bytes": 3e9,
                        "temp_size_in_bytes": 5e9,
                        "alias_size_in_bytes": 1e9},
             "roofline": {"compute_s": 0.5, "memory_s": 2e-4,
                          "collective_s": 0.0, "dominant": "compute_s",
                          "useful_flops_ratio": 0.8}},
            {"arch": "hubert-xlarge", "shape": "decode_32k",
             "mesh": "single", "status": "skipped",
             "reason": "encoder-only: no autoregressive decode"},
            {"arch": "yi-9b", "shape": "decode_32k", "mesh": "multipod",
             "status": "ok", "description": "serve_step (1 new token)",
             "memory": {}, "roofline": {
                 "compute_s": 1e-6, "memory_s": 3.0, "collective_s": 2e-3,
                 "dominant": "memory_s", "useful_flops_ratio": 0.1}}]
    for mesh in ("single", "multipod"):
        assert report.table(recs, mesh) == jax_report.table(recs, mesh)
    for r in recs:
        (tmp_path / f"{r['arch']}.{r['shape']}.{r['mesh']}.json").write_text(
            json.dumps(r))
    assert sorted(report.load(str(tmp_path)), key=str) == sorted(recs,
                                                                 key=str)
    assert report.DEFAULT_DIR.endswith("dryrun_results_torch")
