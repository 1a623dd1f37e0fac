"""The dense 3xTF32 product (``kernels/dense_3xtf32``) and its routing
function on the CPU: the emulation of the kernel's split against fp64 at
yi-9b's and deepseek-moe-16b's widths, which products the routing sends to
the kernel and which to ``torch.einsum``, and prefills that it leaves
unchanged on the CPU.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).  Imports nothing of JAX."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.cluster.storage import KVStore
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.kernels.dense_3xtf32 import ops as dense
from repro_torch.kernels.dense_3xtf32.ref import (
    dense_3xtf32_emulated, dense_ref, tf32_round)
from repro_torch.kernels.ssd_scan.ref import tf32_truncate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.params import init_params
from repro_torch.serving import paged_model, tracing
from repro_torch.serving.engine import LiveEngine
from repro_torch.sharding import rules

#: (K, N) of the products on the path: yi-9b's q (and o), k or v, SwiGLU
#: wi and MLP wo; deepseek-moe-16b's q/k/v, router, layer 0's MLP wo and
#: its shared experts' wo
WIDTHS = [(4096, 4096), (4096, 512), (4096, 22016), (11008, 4096),
          (2048, 2048), (2048, 64), (10944, 2048), (2816, 2048)]


def _rel(y: torch.Tensor, ref: torch.Tensor) -> float:
    """rms error of y against ref, over ref's rms"""
    return ((y.double() - ref).pow(2).mean().sqrt()
            / ref.pow(2).mean().sqrt()).item()


def _operands(M, K, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(M, K, generator=g),
            torch.randn(K, N, generator=g) / K ** 0.5)


@pytest.mark.parametrize("K,N", WIDTHS)
def test_split_stays_near_fp64(K, N):
    """The kernel's three products of TF32 parts, summed exactly, stay
    within 2e-7 (rms, relative) of the fp64 product: the split's own
    error, under the 3.4e-7 that an fp32 product's rounding leaves on the
    CPU.  One TF32 product (what ``allow_tf32`` does) is 1,000 times
    further off; the emulation in fp32 is as close as the fp32 product."""
    x, w = _operands(16, K, N)
    ref = x.double() @ w.double()
    xh, wh = tf32_truncate(x), tf32_round(w)
    xl, wl = tf32_round(x - xh), tf32_truncate(w - wh)
    split = (xl.double() @ wh.double() + xh.double() @ wl.double()
             + xh.double() @ wh.double())
    assert _rel(split, ref) < 2e-7
    assert _rel(xh.double() @ wh.double(), ref) > 1e-4
    (emulated,) = dense_3xtf32_emulated(x, [w])
    assert _rel(emulated, ref) < 2 * _rel(x @ w, ref)


def test_tf32_round_keeps_ten_bits_rounding_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    x = torch.tensor([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), one + 3 * ulp / 2, 3.0, 0.0])
    want = torch.tensor([one, one, one, one + ulp, -one, one + 2 * ulp, 3.0,
                         0.0])
    assert torch.equal(tf32_round(x), want)
    v = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    h = tf32_round(v)
    assert ((h.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((v - h).abs() <= v.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("eq", ["bsd,dhk->bshk", "bshk,hkd->bsd",
                                "bsd,dcf->bscf", "bsf,fd->bsd",
                                "bsd,de->bse"])
def test_contracted_dims(eq):
    assert dense.contracted(eq) == (2 if eq.startswith("bshk") else 1)


@pytest.mark.parametrize("eq", ["bkgd,bskd->bkgs", "bkgs,bskd->bkgd",
                                "bsd,dhk->bhsk"])
def test_other_products_are_not_dense(eq):
    assert dense.contracted(eq) == 0


@pytest.fixture
def on_cpu(monkeypatch):
    """Route CPU tensors as the card's, into the emulation, recording each
    call's operands; returns the list of calls."""
    calls = []

    def kernel(x, ws):
        calls.append((tuple(x.shape), [tuple(w.shape) for w in ws]))
        assert x.is_contiguous() and all(w.is_contiguous() for w in ws)
        dense.launches += 1
        return dense_3xtf32_emulated(x, ws)

    monkeypatch.setattr(dense, "DEVICE_TYPE", "cpu")
    monkeypatch.setattr(dense, "_sm_count", lambda device: 1)
    monkeypatch.setattr(dense, "dense_3xtf32", kernel)
    return calls


def test_cpu_products_take_einsum():
    x, w = _operands(dense.MIN_ROWS, 64, 32)
    p0, l0 = dense.products, dense.launches
    y = dense.einsum("sd,df->sf", x, w)
    assert torch.equal(y, torch.einsum("sd,df->sf", x, w))
    assert (dense.products - p0, dense.launches - l0) == (1, 0)


def test_qkv_in_one_call_with_weights_as_they_lie(on_cpu):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, dense.MIN_ROWS, 64, generator=g)
    ws = [torch.randn(64, h, 8, generator=g) for h in (8, 2, 2)]
    out = dense.einsums("bsd,dhk->bshk", x, ws)
    assert on_cpu == [((dense.MIN_ROWS, 64), [(64, 64), (64, 16), (64, 16)])]
    for y, w in zip(out, ws):
        want = torch.einsum("bsd,dhk->bshk", x, w)
        assert y.shape == want.shape
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    # the output projection contracts two dims: [s, h k] x [h k, d]
    o = torch.randn(1, dense.MIN_ROWS, 8, 8, generator=g).transpose(2, 3)
    wo = torch.randn(8, 8, 64, generator=g)
    y = dense.einsum("bshk,hkd->bsd", o, wo)
    assert on_cpu[-1] == ((dense.MIN_ROWS, 64), [(64, 64)])
    torch.testing.assert_close(y, torch.einsum("bshk,hkd->bsd", o, wo),
                               rtol=1e-5, atol=1e-4)


def test_routing_sends_the_rest_to_einsum(on_cpu, monkeypatch):
    """Fewer than MIN_ROWS rows, an operand that requires grad, fp64, a
    weight that is not contiguous, a launch with blocks for fewer than
    half the SMs, a DTensor, and any product while a mesh is active take
    torch.einsum; the counts say so."""
    x, w = _operands(dense.MIN_ROWS, 64, 32)
    eq = "sd,df->sf"
    cases = {
        "rows": (x[:-1], w),
        "grad x": (x.clone().requires_grad_(), w),
        "grad w": (x, w.clone().requires_grad_()),
        "fp64": (x.double(), w.double()),
        "strided w": (x, torch.randn(32, 64).T),
    }
    for name, (a, b) in cases.items():
        p0, l0 = dense.products, dense.launches
        y = dense.einsum(eq, a, b)
        assert torch.equal(y, torch.einsum(eq, a, b)), name
        assert (dense.products - p0, dense.launches - l0) == (1, 0), name
    # MIN_ROWS rows x one column tile: a block per 64 tokens, too few for
    # more than twice as many SMs
    blocks = -(-dense.MIN_ROWS // 64)
    with monkeypatch.context() as m:
        m.setattr(dense, "_sm_count", lambda device: 2 * blocks + 1)
        assert torch.equal(dense.einsum(eq, x, w), x @ w)
        m.setattr(dense, "_sm_count", lambda device: 2 * blocks)
        dense.einsum(eq, x, w)
        assert len(on_cpu) == 1
        on_cpu.clear()
    assert on_cpu == []
    started = not dist.is_initialized()
    try:
        mesh = mesh_lib.make_debug_mesh((1, 1), device="cpu")
        dx, dw = (DTensor.from_local(t, mesh, (Replicate(), Replicate()),
                                     run_check=False) for t in (x, w))
        assert torch.equal(dense.einsum(eq, dx, dw).to_local(), x @ w)
        with rules.activate(mesh):
            assert torch.equal(dense.einsum(eq, x, w), x @ w)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    assert on_cpu == []
    dense.einsum(eq, x, w)
    assert on_cpu == [((dense.MIN_ROWS, 64), [(64, 32)])]


def _plain_einsums(eq, x, ws):
    return tuple(torch.einsum(eq, x, w) for w in ws)


def _serve(cfg, params, prompt):
    """The tokens a CPU LiveEngine serves for one plain request."""
    eng = LiveEngine(params, cfg, KVStore(), device="cpu")
    req = eng.submit(prompt.numpy(), max_new_tokens=4)
    eng.run()
    return eng.outputs[req.rid]


@pytest.mark.parametrize("arch", ["lwm-7b", "deepseek-moe-16b"])
def test_cpu_prefill_unchanged(arch, monkeypatch):
    """A CPU prefill gives the logits and K/V of the products as
    torch.einsum ran them before the routing, bit for bit, and a CPU
    LiveEngine the same tokens; routed into the emulation (as the card
    would), every product of the layers goes to the kernel and the logits
    stay within fp32 rounding."""
    cfg = reduce_config(get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 40)))
    logits, kvs = paged_model.prefill_collect_kv(params, cfg, tokens)
    with monkeypatch.context() as m:
        m.setattr(dense, "einsums", _plain_einsums)
        before, kvs_before = paged_model.prefill_collect_kv(params, cfg,
                                                            tokens)
    assert torch.equal(logits, before)
    for (k, v), (kb, vb) in zip(kvs, kvs_before):
        assert torch.equal(k, kb) and torch.equal(v, vb)
    with monkeypatch.context() as m:
        m.setattr(dense, "einsums", _plain_einsums)
        want = _serve(cfg, params, tokens[0])
    assert _serve(cfg, params, tokens[0]) == want

    calls = []
    monkeypatch.setattr(dense, "DEVICE_TYPE", "cpu")
    monkeypatch.setattr(dense, "_sm_count", lambda device: 1)
    monkeypatch.setattr(dense, "MIN_ROWS", 8)
    monkeypatch.setattr(dense, "dense_3xtf32", lambda x, ws: (
        calls.append(len(ws)) or dense_3xtf32_emulated(x, ws)))
    p0 = dense.products
    routed, _ = paged_model.prefill_collect_kv(params, cfg, tokens)
    assert len(calls) == dense.products - p0 > 0
    torch.testing.assert_close(routed, before, rtol=1e-4, atol=1e-5)


def test_engine_spans_count_products_on_cpu():
    """A CPU engine's plain prefill runs 4 products a layer (q/k/v in one,
    the output projection, the MLP's two), none on the kernel; so does
    each of its decode steps, whose output projection is routed too."""
    cfg = reduce_config(get_config("lwm-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tr = tracing.Tracer()
    eng = LiveEngine(params, cfg, KVStore(), device="cpu", tracer=tr)
    eng.submit(np.random.default_rng(4).integers(0, cfg.vocab_size, 24),
               max_new_tokens=3)
    eng.run()
    (span,) = tr.spans("plain prefill")
    assert span.counts["products"] == 4 * cfg.num_layers
    assert span.counts["tc_products"] == 0
    steps = tr.spans("decode step")
    assert len(steps) == 2
    for s in steps:
        assert s.counts["products"] == 4 * cfg.num_layers
        assert s.counts["tc_products"] == 0


@pytest.mark.parametrize("b", [1, 3, 16])
def test_decode_output_projection_is_the_unrouted_product(b):
    """At yi-9b's widths (32 heads of 128, d 4096) a decode step's output
    projection through the routing, spelled as the prefills spell it, is
    ``torch.einsum("bhk,hkd->bd")`` bit for bit."""
    g = torch.Generator().manual_seed(b)
    out = torch.randn(b, 32, 128, generator=g)
    wo = torch.randn(32, 128, 4096, generator=g) / 64
    got = dense.einsum("bshk,hkd->bsd", out[:, None], wo)
    assert torch.equal(got[:, 0], torch.einsum("bhk,hkd->bd", out, wo))


@pytest.mark.parametrize("M,tiles,want", [
    (256, 40, (1, 80)), (256, 32, (0, 128)), (160, 40, (0, 120)),
    (1020, 40, (1, 320)), (1024, 1, (0, 16)), (1024, 16, (1, 128))])
def test_plan_takes_the_tiles_of_fewer_waves(M, tiles, want):
    """64-token tiles where their waves over 132 SMs take less time, a
    wave of them counted as 2/3 of one of 128-token tiles."""
    assert dense.plan(M, tiles, 132) == want


def test_dense_op_on_cpu_is_the_plain_product():
    x, w = _operands(5, 12, 8)
    assert torch.equal(dense.dense_3xtf32(x, [w])[0], dense_ref(x, [w])[0])
