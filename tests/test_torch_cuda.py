"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: each test skips on a machine without a CUDA device.
Imports neither jax nor the JAX package, so it runs on a machine with
only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.cluster.network import BandwidthTrace  # noqa: E402
from repro_torch.cluster.storage import KVStore  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ASSIGNED_ARCHS, get_config, reduce_config)
from repro_torch.data.pipeline import DataConfig, batches  # noqa: E402
from repro_torch.kernels.kv_restore import ops as kv_ops  # noqa: E402
from repro_torch.kernels.kv_restore.ref import (  # noqa: E402
    kv_restore_layers_ref, kv_restore_ref)
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)
from repro_torch.kernels.rans_decode import ops as rans_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.kernels.token_delta import ops as td_ops  # noqa: E402
from repro_torch.kernels.token_delta.ref import (  # noqa: E402
    token_delta_decode_frame_ref, token_delta_decode_frames_ref,
    token_delta_encode_ref)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.paged import cache as paged_cache  # noqa: E402
from repro_torch.core import entropy  # noqa: E402
from repro_torch.core.chunks import prefix_key  # noqa: E402
from repro_torch.core.codec import KVCodec  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serving import paged_model, tracing  # noqa: E402
from repro_torch.serving.engine import LiveEngine  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamW, constant_schedule)
from repro_torch.training.steps import (  # noqa: E402
    TrainState, make_train_step)
from repro_torch.tree import flatten, tree_map  # noqa: E402

from _rans_cases import (DISTS, cases, chunk_blob,  # noqa: E402
                         chunk_streams, symbols)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _restore_case(n, H, D, R, dtype, slots, seed, device):
    rng = np.random.default_rng(seed)
    pages = torch.from_numpy(rng.standard_normal((R, H, D)).astype(
        np.float32)).to(device, dtype)
    q = torch.from_numpy(rng.integers(0, 256, (n, H, D)).astype(
        np.uint8)).to(device)
    scales = torch.from_numpy((rng.random(H) + 0.05).astype(
        np.float32)).to(device)
    return pages, q, scales, torch.tensor(slots, dtype=torch.int32,
                                          device=device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n,H,D,slots", [
    (8, 32, 128, [3, 0, -1, 9, 17, -1, 4, 30]),  # lwm-7b 240p frame
    (3, 8, 10, [2, -1, 0]),                       # rows not 16-byte sized
])
def test_kv_restore_kernel_bit_equal(cuda, dtype, n, H, D, slots):
    pages, q, scales, sl = _restore_case(n, H, D, 32, getattr(torch, dtype),
                                         slots, 0, cuda)
    want = kv_restore_ref(pages.clone(), q, scales, sl)
    before = kv_ops.launches
    got = kv_ops.kv_restore(pages, q, scales, sl)
    torch.cuda.synchronize()
    assert kv_ops.launches == before + 1 and got is pages
    assert torch.equal(got, want)


def test_kv_restore_kernel_unaligned_tokens(cuda):
    pages, q, scales, sl = _restore_case(5, 4, 16, 16, torch.float32,
                                         [1, 2, 3, 4, 5], 1, cuda)
    buf = torch.empty(q.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = buf[1:].view(q.shape)  # contiguous, 1 byte off alignment
    shifted.copy_(q)
    want = kv_restore_ref(pages.clone(), q, scales, sl)
    kv_ops.kv_restore(pages, shifted, scales, sl)
    torch.cuda.synchronize()
    assert torch.equal(pages, want)


def test_kv_restore_kernel_rejects_bad_arguments(cuda):
    pages, q, scales, sl = _restore_case(2, 4, 16, 8, torch.float32,
                                         [0, 1], 2, cuda)
    with pytest.raises(TypeError):
        kv_ops.kv_restore(pages, q, scales, sl.long())
    with pytest.raises(ValueError):
        kv_ops.kv_restore(pages, q, scales.cpu(), sl)
    with pytest.raises(ValueError):
        kv_ops.kv_restore(pages, q[:, :2], scales, sl)


def _layers_case(G, n, H, D, L, R, dtype, slots, seed, device):
    rng = np.random.default_rng(seed)
    pages = torch.from_numpy(rng.standard_normal((L, R, H, D)).astype(
        np.float32)).to(device, dtype)
    layers = [int(x) for x in rng.choice(L, size=G, replace=False)]
    q = torch.from_numpy(rng.integers(0, 256, (G, n, H, D)).astype(
        np.uint8)).to(device)
    scales = torch.from_numpy((rng.random((G, H)) + 0.05).astype(
        np.float32)).to(device)
    return pages, layers, q, scales, torch.tensor(slots, dtype=torch.int32,
                                                  device=device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("n,H,D,slots", [
    # lwm-7b's 16-token chunk: slot 0 beside dropped tokens
    (16, 32, 128, [5, 0, -1, 9, 17, -1, 4, 30, 31, 2, -1, 11, 12, 13, 1, 3]),
    (3, 8, 10, [2, -1, 0]),  # rows not 16-byte sized: the scalar path
])
def test_kv_restore_layers_kernel_bit_equal(cuda, dtype, G, n, H, D, slots):
    pages, layers, q, scales, sl = _layers_case(
        G, n, H, D, 4, 32, getattr(torch, dtype), slots, G, cuda)
    want = kv_restore_layers_ref(pages.clone(), layers, q, scales, sl)
    before = kv_ops.launches
    got = kv_ops.kv_restore_layers(pages, layers, q, scales, sl)
    torch.cuda.synchronize()
    assert kv_ops.launches == before + 1 and got is pages
    assert torch.equal(got, want)


def test_kv_restore_layers_kernel_unaligned_tokens(cuda):
    pages, layers, q, scales, sl = _layers_case(
        3, 5, 4, 16, 3, 16, torch.float32, [1, 2, 3, 4, 5], 1, cuda)
    buf = torch.empty(q.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = buf[1:].view(q.shape)  # contiguous, 1 byte off alignment
    shifted.copy_(q)
    want = kv_restore_layers_ref(pages.clone(), layers, q, scales, sl)
    kv_ops.kv_restore_layers(pages, layers, shifted, scales, sl)
    torch.cuda.synchronize()
    assert torch.equal(pages, want)


def test_kv_restore_layers_kernel_rejects_bad_arguments(cuda):
    pages, layers, q, scales, sl = _layers_case(
        2, 2, 4, 16, 3, 8, torch.float32, [0, 1], 2, cuda)
    before = kv_ops.launches
    with pytest.raises(TypeError):
        kv_ops.kv_restore_layers(pages, layers, q, scales, sl.long())
    with pytest.raises(ValueError):
        kv_ops.kv_restore_layers(pages, [0, 3], q, scales, sl)  # L = 3
    with pytest.raises(ValueError):
        kv_ops.kv_restore_layers(pages, layers, q, scales.cpu(), sl)
    with pytest.raises(ValueError):
        kv_ops.kv_restore_layers(pages, layers, q[:, :1], scales, sl)
    with pytest.raises(ValueError):
        kv_ops.kv_restore_layers(pages, layers[:1], q, scales, sl)
    assert kv_ops.launches == before


def test_restore_chunk_on_the_card_matches_the_cpu(cuda):
    """PagedKVCache.restore_chunk through the pinned staging ring (more
    chunks than buffers, so buffers are reused) against the CPU cache."""
    cfg = reduce_config(get_config("lwm-7b"), num_layers=5)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(3)
    caches = [paged_cache.PagedKVCache(cfg, n_pages=12, page_size=8,
                                       device=d) for d in ("cpu", cuda)]
    for c in caches:
        c.add_seq(0, 40)
    caches[1].reserve_staging(3, 16)
    for t0 in (0, 16, 24, 8):
        n = 16 if t0 < 24 else 8
        for kind, layers in (("k", (0, 1, 2)), ("v", (3, 4)), ("k", (3, 4))):
            q = rng.integers(0, 256, (len(layers), n, K, hd)).astype(np.uint8)
            sc = (rng.random((len(layers), K)) + 0.05).astype(np.float32)
            for c in caches:
                staged = c.staging_buffer(len(layers), n)
                staged.copy_(torch.from_numpy(q))
                c.restore_chunk(kind, 0, layers, np.arange(t0, t0 + n),
                                staged, torch.from_numpy(sc).to(c.device))
    torch.cuda.synchronize()
    assert caches[1].staging.tokens[0].is_pinned()
    assert torch.equal(caches[0].k_pages, caches[1].k_pages.cpu())
    assert torch.equal(caches[0].v_pages, caches[1].v_pages.cpu())


@pytest.mark.parametrize("H,K,hd,ps,lens,pad", [
    (32, 32, 128, 16, [530, 17, 64], False),  # lwm-7b
    (56, 8, 128, 16, [530, 1, 300], True),    # yi-34b GQA, padded tables
    (8, 2, 32, 8, [13, 40], False),
])
def test_paged_attention_kernel_matches_plain(cuda, H, K, hd, ps, lens, pad):
    rng = np.random.default_rng(0)
    B = len(lens)
    bps = max(-(-n // ps) for n in lens) + 1
    P = B * bps + 3
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    q, kp, vp = f(B, H, hd), f(P, ps, K, hd), f(P, ps, K, hd)
    bt = rng.permutation(P)[:B * bps].reshape(B, bps).astype(np.int32)
    if pad:
        for b, n in enumerate(lens):
            bt[b, -(-n // ps):] = 0
    bt = torch.from_numpy(bt).to(cuda)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    want = paged_attention_ref(q, kp, vp, bt, cl)
    before = pa_ops.launches
    got = pa_ops.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert pa_ops.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4


def test_paged_attention_kernel_marks_bad_pages_nan(cuda):
    q = torch.randn(1, 4, 32, device=cuda)
    kp = torch.randn(4, 8, 2, 32, device=cuda)
    bt = torch.tensor([[1, 9]], dtype=torch.int32, device=cuda)  # 9 >= P
    cl = torch.tensor([12], dtype=torch.int32, device=cuda)
    out = pa_ops.paged_attention(q, kp, kp, bt, cl)
    assert torch.isnan(out).all()


def _paged_case(H, K, hd, ps, lens, bps, seed, device):
    rng = np.random.default_rng(seed)
    B = len(lens)
    P = B * bps + 3
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    q, kp, vp = f(B, H, hd), f(P, ps, K, hd), f(P, ps, K, hd)
    bt = rng.permutation(P)[:B * bps].reshape(B, bps).astype(np.int32)
    return q, kp, vp, bt, torch.tensor(lens, dtype=torch.int32,
                                       device=device)


@pytest.mark.parametrize("H,K,hd,ps,lens,bps,splits", [
    (8, 2, 64, 16, [4000, 2500], 250, ">1"),   # long: many splits
    (32, 32, 128, 16, [300] * 12, 19, "1"),    # B*K = 384: one split
    (56, 8, 128, 16, [530, 7, 1, 40], 34, ">1"),  # short sequences:
                                                # empty splits
    (8, 2, 32, 8, [1], 4, ">1"),               # ctx = 1
    (16, 2, 128, 16, [543, 543, 543], 36, ">1"),  # g = 8, lwm-like ctx
    (40, 2, 64, 16, [200, 90], 13, ">1"),      # g = 20: three head tiles
], ids=["long", "one_split", "empty_splits", "ctx1", "g8", "g20"])
def test_paged_attention_split_kernel_matches_plain(cuda, H, K, hd, ps, lens,
                                                    bps, splits):
    q, kp, vp, bt, cl = _paged_case(H, K, hd, ps, lens, bps, 7, cuda)
    bt = torch.from_numpy(bt).to(cuda)
    n_split = pa_ops.plan_splits(len(lens), H, K, bps, pa_ops._sm_count(
        q.device))
    assert (n_split > 1) == (splits == ">1")
    want = paged_attention_ref(q, kp, vp, bt, cl)
    before = pa_ops.launches
    got = pa_ops.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert pa_ops.launches == before + 1
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= 1e-4


def test_paged_attention_kernel_bad_page_in_a_later_split(cuda):
    """A bad table entry that only the last split reads still turns every
    head of its sequence into NaN; the other sequence is untouched."""
    q, kp, vp, bt, cl = _paged_case(8, 2, 32, 8, [60, 60], 8, 3, cuda)
    n_split = pa_ops.plan_splits(2, 8, 2, 8, pa_ops._sm_count(q.device))
    assert n_split >= 2
    bt[0, 7] = kp.shape[0] + 5  # page 7 of 8: the last split's
    bt = torch.from_numpy(bt).to(cuda)
    out = pa_ops.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert torch.isnan(out[0]).all()
    want = paged_attention_ref(q[1:], kp, vp, bt[1:], cl[1:])
    assert (out[1:] - want).abs().max().item() <= 1e-4


def test_engine_on_the_card_matches_the_cpu(cuda):
    cfg = reduce_config(get_config("lwm-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = {k: v for k, v in params.items() if k != "layers"}
    gpu_params = {k: v.to(cuda) for k, v in gpu_params.items()}
    gpu_params["layers"] = [
        {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
             if isinstance(v, dict) else v.to(cuda)) for k, v in lp.items()}
        for lp in params["layers"]]
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    full = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)])
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    outs = []
    for dev, p in (("cpu", params), (cuda, gpu_params)):
        store = KVStore()
        store.register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=16,
                              resolutions=("240p",))
        eng = LiveEngine(p, cfg, store, device=dev)
        r = eng.submit(full, reuse_prefix=prefix_key(prefix),
                       reuse_tokens=48, max_new_tokens=4)
        before = kv_ops.launches
        eng.run()
        assert r.t_first_token is not None
        # one kv_restore launch per fetched chunk on the card
        chunks = len(store.lookup(prefix_key(prefix)).refs)
        assert kv_ops.launches - before == (0 if dev == "cpu" else chunks)
        outs.append(eng.outputs[r.rid])
    assert outs[0] == outs[1]


def test_engine_spans_are_ranges_of_a_trace_of_the_card(cuda):
    """Inside a profiler session of the card the engine's spans are
    ``record_function`` ranges beside the device's records: one
    ``restore`` range, on the host and on the card, and one ``kv_restore``
    kernel per fetched chunk."""
    cfg = reduce_config(get_config("lwm-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    params = tree_map(lambda t: t.to(cuda), params)

    def serve(tr):
        store = KVStore()
        store.register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=16,
                              resolutions=("240p",))
        eng = LiveEngine(params, cfg, store, device=cuda, tracer=tr)
        eng.submit(np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                        8)]),
                   reuse_prefix=prefix_key(prefix), reuse_tokens=48,
                   max_new_tokens=4)
        eng.submit(rng.integers(0, cfg.vocab_size, 24), max_new_tokens=4)
        eng.run()
        return len(store.lookup(prefix_key(prefix)).refs)

    serve(tracing.Tracer())  # builds the kernels outside the session
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        chunks = serve(tracing.Tracer())
        torch.cuda.synchronize()
    events = prof.events()
    names = {e.name for e in events}
    assert {"fetch", "codec decode", "restore", "suffix prefill",
            "plain prefill", "decode step"} <= names
    host, card = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for dev in (host, card):  # the range again on the card's timeline
        assert len([e for e in events if e.name == "restore"
                    and e.device_type == dev]) == chunks
    assert len([e for e in events if e.device_type == card
                and "kv_restore" in e.name]) == chunks


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n,lanes", cases())
def test_rans_decode_kernel_equals_the_host_decoder(cuda, dist, n, lanes):
    blob = entropy.encode(symbols(dist, n, seed=n * 7 + lanes), lanes)
    before = rans_ops.launches
    (got,) = rans_ops.rans_decode_streams([blob], cuda)
    assert rans_ops.launches == before + (n > 0)  # an empty stream: none
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), entropy.decode(blob))


def test_rans_decode_kernel_decodes_a_chunk_in_one_launch(cuda):
    """A yi-9b-shaped chunk's six streams, then streams of 1, 32, 1,000 and
    256 lanes (one empty) in one launch of blocks as wide as the widest."""
    mixed = [entropy.encode(symbols(d, n, seed=n), lanes) for d, n, lanes in
             (("uniform", 300, 1), ("skewed", 0, 32), ("skewed", 70_001, 32),
              ("uniform", 9_999, 1000), ("single", 5_000, 256))]
    for streams in (chunk_streams(chunk_blob(28)), mixed):
        before = rans_ops.launches
        got = rans_ops.rans_decode_streams(streams, cuda)
        assert rans_ops.launches == before + 1
        for s, g in zip(streams, got):
            np.testing.assert_array_equal(g.numpy(), entropy.decode(s))


def test_rans_decode_kernel_rejects_bad_arguments(cuda):
    data = symbols("skewed", 5_000, 2)
    with pytest.raises(ValueError, match="lanes"):
        rans_ops.rans_decode_streams([entropy.encode(data, 2048)], cuda)
    blob = entropy.encode(data, 256)
    with pytest.raises(ValueError, match="truncated"):
        rans_ops.rans_decode_streams([blob[:-1]], cuda)
    on_card = torch.from_numpy(np.frombuffer(blob, np.uint8).copy()).to(cuda)
    with pytest.raises(ValueError, match="host"):
        rans_ops.rans_decode_streams([on_card], cuda)
    # a word dropped from the stream: the block reads other than its words
    s = entropy.parse_stream(blob)
    short = bytearray(blob[:entropy.HEADER_BYTES])
    short[521:525] = (s.words.size - 1).to_bytes(4, "little")
    short += s.words[1:].tobytes() + s.states.tobytes()
    with pytest.raises(ValueError, match="words"):
        rans_ops.rans_decode_streams([bytes(short)], cuda)
    p = rans_ops.pack([s])
    dev_in = p.host_in.to(cuda)
    with pytest.raises(ValueError, match="output"):
        rans_ops.launch(dev_in, torch.empty(p.out_bytes, dtype=torch.uint8),
                        1, p.threads)


def test_engine_fetch_decodes_every_chunk_on_the_card(cuda):
    """A reuse fetch on the card: one ``rans_decode`` launch a chunk, the
    pages it restores equal to the CPU engine's (numpy decode), and each
    chunk's ``rans_s`` inside its ``codec decode`` span."""
    cfg = reduce_config(get_config("lwm-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, 80)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    prompt = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)])
    restored = []
    for dev in ("cpu", cuda):
        store = KVStore()
        store.register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=32,
                              resolutions=("240p",))
        tr = tracing.Tracer()
        eng = LiveEngine(tree_map(lambda t: t.to(dev), params), cfg, store,
                         device=dev, tracer=tr)
        r = eng.submit(prompt, reuse_prefix=prefix_key(prefix),
                       reuse_tokens=len(prefix), max_new_tokens=8)
        before = rans_ops.launches
        while r.fetch_done is None:
            eng.step()
        man = store.lookup(prefix_key(prefix))
        chunks = len(man.refs)
        assert rans_ops.launches - before == (0 if dev == "cpu" else chunks)
        if dev != "cpu":
            # the high water counts each chunk's symbols decoded ahead
            codec = KVCodec(cfg.num_kv_heads, cfg.head_dim)
            held = max(sum(entropy.parse_stream(s).n
                           for s in codec.rans_streams(b))
                       for b in man.blobs.values())
            assert eng.stats.restore_buffer_high_water > held
        spans = tr.spans("codec decode")
        assert len(spans) == chunks
        for sp in spans:
            assert 0.0 < sp.counts["rans_s"] <= sp.seconds
        rows = torch.as_tensor(eng.cache.slots_for(
            r.rid, np.arange(len(prefix))), device=eng.device).long()
        restored.append([eng.cache.layer_rows(pages, layer)[rows].cpu()
                         for pages in (eng.cache.k_pages, eng.cache.v_pages)
                         for layer in range(cfg.num_layers)])
        eng.run()
    for a, b in zip(*restored):
        assert torch.equal(a, b)


def test_storage_tier_on_the_card_matches_the_cpu(cuda):
    """A reduced partial hit, then a miss after the ancestor's node
    fails, through a StorageCluster: one kv_restore launch per fetched
    chunk on the card, tokens equal to the CPU run's."""
    from repro_torch.cluster.storage import StorageCluster, StorageNode
    cfg = reduce_config(get_config("lwm-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = {k: v.to(cuda) for k, v in params.items() if k != "layers"}
    gpu_params["layers"] = [
        {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
             if isinstance(v, dict) else v.to(cuda)) for k, v in lp.items()}
        for lp in params["layers"]]
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, 72)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prompt[:32])
    logs = []
    for dev, p in (("cpu", params), (cuda, gpu_params)):
        cluster = StorageCluster([StorageNode("n0"), StorageNode("n1")],
                                 replication=1, heal="manual")
        entry = cluster.register_prefix(prompt[:32], kv_k, kv_v,
                                        tokens_per_chunk=16,
                                        resolutions=("240p",))
        eng = LiveEngine(p, cfg, cluster, device=dev)
        before = kv_ops.launches
        r1 = eng.submit(prompt, reuse_prefix="by-tokens", reuse_tokens=64,
                        max_new_tokens=4)
        eng.run()
        assert (r1.storage_hit, r1.reuse_tokens) == ("partial", 32)
        chunks = len(entry.manifest.refs)
        assert kv_ops.launches - before == (0 if dev == "cpu" else chunks)
        eng.fail_node(r1.storage_node)
        before = kv_ops.launches
        r2 = eng.submit(prompt, reuse_prefix="by-tokens", reuse_tokens=32,
                        max_new_tokens=4)
        eng.run()
        assert r2.storage_hit == "miss" and kv_ops.launches == before
        logs.append(([eng.outputs[r.rid] for r in (r1, r2)],
                     list(cluster.events)))
    assert logs[0] == logs[1]

def _scan_inputs(b, s, nh, hd, G, S, seed, device):
    rng = np.random.default_rng(seed)

    def f(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(device)

    return (f((b, s, nh, hd), 0.3), -f((b, s, nh), 0.1).abs(),
            f((b, s, G, S), 0.3), f((b, s, G, S), 0.3))


SCAN_SHAPES = [
    (1, 40, 2, 8, 1, 4, 64),          # Q = s = 40, not a power of two
    (1, 100, 2, 8, 1, 4, 32),         # padded to 128
    (2, 64, 4, 16, 2, 8, 32),         # two groups
    (1, 130, 4, 64, 2, 128, 128),     # Q > 64: two row tiles per chunk
    (1, 2048, 80, 64, 1, 128, 64),    # mamba2-2.7b prefill
    (2, 2048, 80, 64, 1, 128, 64),    # the path's shape at b = 2
    (1, 2064, 80, 64, 1, 128, 64),    # padded: 2064 = 32.25 chunks
    (1, 256, 8, 64, 2, 128, 64),      # G = 2, nh = 8: two-block clusters
    (1, 300, 8, 64, 2, 128, 128),     # chunk 128: two pieces of 64
    (1, 72, 3, 24, 3, 16, 64),        # hd not a multiple of 16: one slice
    (1, 256, 4, 128, 1, 128, 64),     # 128-wide heads, state 128
]


@pytest.mark.parametrize("b,s,nh,hd,G,S,chunk", SCAN_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, b, s, nh, hd, G, S, chunk):
    args = _scan_inputs(b, s, nh, hd, G, S, s, cuda)
    want_y, want_st = ssd_scan_ref(*args, chunk=chunk)
    before = ssd_ops.launches
    y, st = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    assert y.shape == want_y.shape and st.shape == want_st.shape
    # fp32 sums in another order: 2e-4 of the largest magnitude
    for got, want in ((y, want_y), (st, want_st)):
        err = (got - want).abs().max().item()
        assert err <= 2e-4 * want.abs().max().item(), err


@pytest.mark.parametrize("b,s,nh,hd,G,S,chunk", SCAN_SHAPES)
def test_ssd_scan_bwd_kernel_matches_plain(cuda, b, s, nh, hd, G, S, chunk):
    """The backward kernel (through the op's autograd Function) against
    ``ssd_scan_bwd_ref`` on the card, from the forward test's inputs and a
    seeded dy and non-zero dstate: 2e-4 of each gradient's largest
    magnitude (fp32 sums in another order)."""
    args = _scan_inputs(b, s, nh, hd, G, S, s, cuda)
    rng = np.random.default_rng(s + 1)
    dy = torch.from_numpy(rng.standard_normal((b, s, nh, hd)).astype(
        np.float32)).to(cuda)
    ds = torch.from_numpy(rng.standard_normal((b, nh, hd, S)).astype(
        np.float32)).to(cuda)
    want = ssd_scan_bwd_ref(*args, dy, ds, chunk=chunk)
    leaves = [t.clone().requires_grad_() for t in args]
    before = (ssd_ops.launches, ssd_ops.bwd_launches)
    y, st = ssd_ops.ssd_scan(*leaves, chunk=chunk)
    got = torch.autograd.grad((y, st), leaves, (dy, ds))
    torch.cuda.synchronize()
    assert (ssd_ops.launches, ssd_ops.bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = (g - w).abs().max().item()
        assert err <= 2e-4 * w.abs().max().item(), err


def test_ssd_scan_kernel_rejects_bad_arguments(cuda):
    xdt, a_log, Bm, Cm = _scan_inputs(1, 32, 2, 8, 1, 4, 0, cuda)
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(xdt.double(), a_log, Bm, Cm, chunk=32)
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(xdt, a_log, Bm.bfloat16(), Cm, chunk=32)
    with pytest.raises(ValueError):
        ssd_ops.ssd_scan(xdt.transpose(2, 3).contiguous().transpose(2, 3),
                         a_log, Bm, Cm, chunk=32)
    with pytest.raises(ValueError):
        ssd_ops.ssd_scan(xdt, a_log, Bm[:, :, :1].expand(1, 32, 3, 4)
                         .contiguous(), Cm, chunk=32)


def test_ssd_scan_forward_after_a_shorter_backward(cuda):
    """The backward sets the C.B^T kernel's shared-memory limit to what its
    pieces need; a forward of longer chunks afterwards still launches and
    matches the plain version."""
    short = _scan_inputs(2, 32, 4, 32, 1, 16, 0, cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    ssd_ops.ssd_scan_bwd(*short, torch.randn(2, 32, 4, 32, device=cuda,
                                             generator=g),
                         torch.randn(2, 4, 32, 16, device=cuda, generator=g),
                         chunk=64)
    xdt, a_log, Bm, Cm = _scan_inputs(2, 128, 4, 32, 1, 16, 1, cuda)
    y, st = ssd_ops.ssd_scan(xdt, a_log, Bm, Cm, chunk=64)
    want_y, want_st = ssd_scan_ref(*(t.cpu() for t in (xdt, a_log, Bm, Cm)),
                                   chunk=64)
    for got, want in ((y, want_y), (st, want_st)):
        err = (got.cpu() - want).abs().max().item()
        assert err <= 2e-4 * want.abs().max().item(), err


@pytest.mark.parametrize("s", [128, 100])
def test_ssd_scan_ops_pass_opcheck_on_the_card(cuda, s):
    """The two custom ops through ``torch.library.opcheck`` on CUDA
    inputs: the fake implementation against the kernels' outputs (shapes,
    dtypes, strides of a padded length), the schema, and dispatch; each
    call launches its kernel."""
    xdt, a_log, Bm, Cm = _scan_inputs(2, s, 4, 32, 1, 16, 0, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(2, s, 4, 32, device=cuda, generator=g)
    dstate = torch.randn(2, 4, 32, 16, device=cuda, generator=g)
    ssd_ops.launches = ssd_ops.bwd_launches = 0
    torch.library.opcheck(torch.ops.repro_torch.ssd_scan_fwd.default,
                          (xdt, a_log, Bm, Cm, 64))
    torch.library.opcheck(torch.ops.repro_torch.ssd_scan_bwd.default,
                          (xdt, a_log, Bm, Cm, dy, dstate, 64))
    assert ssd_ops.launches > 0 and ssd_ops.bwd_launches > 0


def test_mamba2_on_the_card_matches_the_cpu(cuda):
    cfg = reduce_config(get_config("mamba2-2.7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = {k: v.to(cuda) for k, v in params.items() if k != "layers"}
    gpu_params["layers"] = [
        {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
             if isinstance(v, dict) else v.to(cuda)) for k, v in lp.items()}
        for lp in params["layers"]]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 100))
    outs = []
    for dev, p in (("cpu", params), (cuda, gpu_params)):
        before = ssd_ops.launches
        logits, cache = tf.prefill(p, cfg, tokens=torch.from_numpy(
            prompt).to(dev))
        assert ssd_ops.launches == before + (cfg.num_layers
                                              if dev != "cpu" else 0)
        toks = [int(logits[0, -1].argmax())]
        for i in range(5):
            logits, cache = tf.decode_step(
                p, cfg, torch.tensor([toks[-1]], device=dev), 100 + i, cache)
            toks.append(int(logits[0].argmax()))
        outs.append(toks)
    assert outs[0] == outs[1]


TOKEN_DELTA_SHAPES = [
    (4, 240, 432),     # 240p planes, H*W a multiple of 16
    (5, 5, 77),        # H*W = 385: unaligned reference, a ragged tail
    (3, 3, 50),        # a vector straddles the end of frame 0
    (1, 1, 7),         # less than one vector
    (8, 1080, 1920),   # 1080p planes
]


@pytest.mark.parametrize("shape", TOKEN_DELTA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_token_delta_kernels_bit_equal(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    video = torch.randint(0, 256, shape, generator=g, device=cuda,
                          dtype=torch.uint8)
    n_enc, n_dec = td_ops.encode_launches, td_ops.decode_launches
    zres = td_ops.token_delta_encode(video)
    assert torch.equal(zres, token_delta_encode_ref(video))
    prev = torch.zeros(shape[1:], dtype=torch.uint8, device=cuda)
    for f in range(shape[0]):  # the chained one-frame decode
        frame = td_ops.token_delta_decode_frame(prev, zres[f])
        assert torch.equal(frame, token_delta_decode_frame_ref(prev,
                                                               zres[f]))
        assert torch.equal(frame, video[f])
        prev = frame
    torch.cuda.synchronize()
    assert td_ops.encode_launches == n_enc + 1
    assert td_ops.decode_launches == n_dec + shape[0]


def test_token_delta_kernels_on_unaligned_views(cuda):
    """Views that start one byte into their storage take the scalar path
    and still agree bit for bit."""
    base = torch.randint(0, 256, (3 * 64 * 64 + 1,), dtype=torch.uint8,
                         device=cuda)
    video = base[1:].view(3, 64, 64)
    assert video.data_ptr() % 16 != 0 and video.is_contiguous()
    assert torch.equal(td_ops.token_delta_encode(video),
                       token_delta_encode_ref(video))
    prev, zres = base[1:4097].view(64, 64), base[4097:8193].view(64, 64)
    assert torch.equal(td_ops.token_delta_decode_frame(prev, zres),
                       token_delta_decode_frame_ref(prev, zres))


def test_token_delta_kernels_reject_bad_arguments(cuda):
    video = torch.zeros((2, 8, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        td_ops.token_delta_encode(video.to(torch.int32))
    with pytest.raises(ValueError):
        td_ops.token_delta_encode(video.transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        td_ops.token_delta_encode(video[0])  # not [F, H, W]
    with pytest.raises(TypeError):
        td_ops.token_delta_decode_frame(video[0].float(), video[1])
    with pytest.raises(ValueError):
        td_ops.token_delta_decode_frame(video[0], video[1, :4])  # shapes
    with pytest.raises(ValueError):
        td_ops.token_delta_decode_frame(video[0].cpu(), video[1])
    with pytest.raises(ValueError):
        td_ops.token_delta_decode_frame(video[0], video[1].t())


@pytest.mark.parametrize("prev_kind", ["zero", "random"])
@pytest.mark.parametrize("shape", TOKEN_DELTA_SHAPES + [
    (40, 128, 416),    # the path's stack: group 0's 240p plane
    (129, 64, 64),     # more frames than one round of segments (128)
], ids=lambda s: "x".join(map(str, s)))
def test_token_delta_decode_frames_bit_equal(cuda, shape, prev_kind):
    """One launch decodes the whole stack, bit-equal to the plain version
    (the one-frame decode chained over the frames)."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + 1)
    zres = torch.randint(0, 256, shape, generator=g, device=cuda,
                         dtype=torch.uint8)
    prev = (torch.zeros(shape[1:], dtype=torch.uint8, device=cuda)
            if prev_kind == "zero" else
            torch.randint(0, 256, shape[1:], generator=g, device=cuda,
                          dtype=torch.uint8))
    n_dec = td_ops.decode_launches
    got = td_ops.token_delta_decode_frames(prev, zres)
    torch.cuda.synchronize()
    assert td_ops.decode_launches == n_dec + 1
    assert torch.equal(got, token_delta_decode_frames_ref(prev, zres))


def test_token_delta_decode_frames_on_unaligned_views(cuda):
    """Views that start one byte into their storage, and a frame size that
    is not a multiple of 16, take the scalar path and still agree bit for
    bit."""
    base = torch.randint(0, 256, (20 * 64 * 64 + 64 * 64 + 1,),
                         dtype=torch.uint8, device=cuda)
    prev = base[1:4097].view(64, 64)
    zres = base[4097:].view(20, 64, 64)
    assert prev.data_ptr() % 16 != 0 and zres.data_ptr() % 16 != 0
    assert torch.equal(td_ops.token_delta_decode_frames(prev, zres),
                       token_delta_decode_frames_ref(prev, zres))
    # aligned, H*W = 385
    odd = base[16:16 + 20 * 385].view(20, 5, 77)
    odd_prev = base[16 + 20 * 385:16 + 21 * 385].view(5, 77)
    assert odd.data_ptr() % 16 == 0
    assert torch.equal(td_ops.token_delta_decode_frames(odd_prev, odd),
                       token_delta_decode_frames_ref(odd_prev, odd))


def test_token_delta_decode_frames_rejects_bad_arguments(cuda):
    zres = torch.zeros((3, 8, 16), dtype=torch.uint8, device=cuda)
    prev = torch.zeros((8, 16), dtype=torch.uint8, device=cuda)
    n_dec = td_ops.decode_launches
    with pytest.raises(TypeError):
        td_ops.token_delta_decode_frames(prev, zres.to(torch.int32))
    with pytest.raises(TypeError):
        td_ops.token_delta_decode_frames(prev.float(), zres)
    with pytest.raises(ValueError):
        td_ops.token_delta_decode_frames(prev[:4], zres)  # prev shape
    with pytest.raises(ValueError):
        td_ops.token_delta_decode_frames(prev, zres[0])  # not [F, H, W]
    with pytest.raises(ValueError):
        td_ops.token_delta_decode_frames(prev.cpu(), zres)  # device
    with pytest.raises(ValueError):
        td_ops.token_delta_decode_frames(prev, zres.transpose(0, 1))
    assert td_ops.token_delta_decode_frames(prev, zres[:0]).shape == (
        0, 8, 16)
    assert td_ops.decode_launches == n_dec  # no launch for F = 0


def test_virtual_clock_engine_on_the_card_matches_the_cpu(cuda):
    """The async virtual-clock engine gives the same tokens and the same
    virtual token times on the card (kernels) as on the CPU."""
    from repro_torch.core.adaptive import DecodeTable
    cfg = reduce_config(get_config("lwm-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = {k: v.to(cuda) for k, v in params.items() if k != "layers"}
    gpu_params["layers"] = [
        {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
             if isinstance(v, dict) else v.to(cuda)) for k, v in lp.items()}
        for lp in params["layers"]]
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    full = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)])
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    res = ("240p", "480p")
    table = DecodeTable(name="test", n_decoders=2,
                        latency={r: (0.04, 0.05) for r in res},
                        penalty={r: 0.0 for r in res},
                        chunk_size_mb={r: 0.004 for r in res})
    logs = []
    for dev, p in (("cpu", params), (cuda, gpu_params)):
        store = KVStore()
        store.register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=16,
                              resolutions=("240p",))
        eng = LiveEngine(p, cfg, store, device=dev, fetch_mode="async",
                         bandwidth=BandwidthTrace.constant(0.0006),
                         decode_table=table)
        r = eng.submit(full, reuse_prefix=prefix_key(prefix),
                       reuse_tokens=48, max_new_tokens=4)
        before = kv_ops.launches
        eng.run()
        chunks = len(store.lookup(prefix_key(prefix)).refs)
        assert kv_ops.launches - before == (0 if dev == "cpu" else chunks)
        logs.append((eng.outputs[r.rid], r.token_times,
                     eng.stats.restored_tokens))
    assert logs[0] == logs[1]


def _fleet_run(dev, params, cfg, prefixes, suffix, kvs):
    """A reduced LiveFleet of 4 engines behind the affinity router, one
    FairScheduler and a two-node cluster whose first prefix's node fails
    after the first dispatch: fetched full hits, local restores of the
    hot prefix, and one miss.  Returns what must agree across devices
    and the kv_restore launches against the chunks restored."""
    from repro_torch.cluster.costmodel import CHIPS, EngineCostModel
    from repro_torch.cluster.fairness import FairScheduler
    from repro_torch.cluster.fleet import LiveFleet
    from repro_torch.cluster.storage import StorageCluster, StorageNode
    from repro_torch.core.adaptive import DecodeTable
    cluster = StorageCluster([StorageNode("n0"), StorageNode("n1")],
                             replication=1, heal="manual")
    keys = [cluster.register_prefix(p, *kv, tokens_per_chunk=16,
                                    resolutions=("240p",)).key
            for p, kv in zip(prefixes, kvs)]
    doomed = cluster.primary_node(keys[0]).node_id
    fair = FairScheduler(max_inflight=1)
    fleet = LiveFleet(
        params, cfg, cluster, n_nodes=4,
        bandwidth=BandwidthTrace.constant(0.0006), fairness=fair,
        local_kv_tokens=128, churn_at_dispatch=[(1, "fail", doomed)],
        engine_kw=dict(n_pages=32, max_running=8, resolution="240p",
                       decode_table=DecodeTable(
                           name="fleet-toy", n_decoders=1,
                           latency={"240p": (0.06,)},
                           penalty={"240p": 0.0},
                           chunk_size_mb={"240p": 0.002}),
                       use_table_sizes=True, adaptive=False,
                       resolutions=("240p",),
                       cost=EngineCostModel(cfg, CHIPS["h20"], 2)),
        device=dev)
    # the doomed node's other prefix is asked once, last: it misses
    other = next(i for i, k in enumerate(keys[1:], 1)
                 if cluster.primary_node(k).node_id == doomed)
    script = [("alice", "premium", 0), ("bob", "free", 0),
              ("alice", "premium", 3 - other), ("bob", "free", 0),
              ("alice", "premium", 0), ("bob", "free", other)]
    for user, tier, i in script:
        fleet.submit(np.concatenate([prefixes[i], suffix]),
                     prefix_key=keys[i], reuse_tokens=len(prefixes[i]),
                     max_new_tokens=3, user=user, slo_tier=tier)
    before = kv_ops.launches
    fleet.run()
    done = [r for e in fleet.engines for r in e.finished]
    assert len(done) == len(script)
    chunks = sum(len(cluster.catalog[r.prefix].manifest.refs) for r in done
                 if r.storage_hit in ("full", "local"))
    hits = {r.rid: r.storage_hit for r in done}
    assert "local" in hits.values() and "miss" in hits.values()
    return (dict(outputs={r.rid: fleet.engines[fleet.placement[r.rid]]
                          .outputs[r.rid] for r in done},
                 hits=hits, router=list(fleet.router.events),
                 fairness=list(fair.events), cluster=list(cluster.events),
                 times={r.rid: list(r.token_times) for r in done}),
            kv_ops.launches - before, chunks)


def test_live_fleet_on_the_card_matches_the_cpu(cuda):
    """A reduced LiveFleet (4 engines, one copy of the weights) on the
    card gives the tokens, token times and router, fairness and cluster
    events of the same fleet on the CPU; on the card every fetched and
    every locally restored chunk is one kv_restore launch."""
    cfg = reduce_config(get_config("lwm-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu_params = {k: v.to(cuda) for k, v in params.items() if k != "layers"}
    gpu_params["layers"] = [
        {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
             if isinstance(v, dict) else v.to(cuda)) for k, v in lp.items()}
        for lp in params["layers"]]
    rng = np.random.default_rng(4)
    prefixes = [rng.integers(0, cfg.vocab_size, n) for n in (48, 32, 32)]
    suffix = rng.integers(0, cfg.vocab_size, 8)
    kvs = [paged_model.donor_prefix_kv(params, cfg, p) for p in prefixes]
    cpu_log, cpu_launches, _ = _fleet_run("cpu", params, cfg, prefixes,
                                          suffix, kvs)
    card_log, card_launches, chunks = _fleet_run(cuda, gpu_params, cfg,
                                                 prefixes, suffix, kvs)
    assert cpu_launches == 0 and card_launches == chunks > 0
    assert card_log == cpu_log


def _sharded_engine_run(dev, params, cfg, prefix, kv, suffix, mesh,
                        fetch_mode):
    """A reuse and a plain request through a mesh-sharded engine
    (``mesh_shards=3``) over a one-node cluster on the virtual clock:
    what must agree across devices, the restored rows at the reuse
    request's first token, and the kv_restore launches against the
    chunks restored."""
    from repro_torch.cluster.storage import StorageCluster, StorageNode
    cluster = StorageCluster([StorageNode("n0")])
    man = cluster.register_prefix(prefix, *kv, tokens_per_chunk=16,
                                  resolutions=("240p",)).manifest
    pages = {}

    def on_token(req, tok, t):
        if len(req.token_times) == 1 and req.reuse_tokens:
            rows = torch.as_tensor(eng.cache.slots_for(
                req.rid, np.arange(req.reuse_tokens)), device=eng.device)
            for kind, a in (("k", eng.cache.k_pages),
                            ("v", eng.cache.v_pages)):
                pages[kind] = a.view(a.shape[0], -1, *a.shape[3:])[
                    :, rows.long()].cpu()

    eng = LiveEngine(params, cfg, cluster, device=dev, fetch_mode=fetch_mode,
                     bandwidth=BandwidthTrace.constant(0.0006), mesh=mesh,
                     mesh_shards=3, on_token=on_token)
    reqs = [eng.submit(np.concatenate([prefix, suffix]),
                       reuse_prefix="by-tokens", reuse_tokens=len(prefix),
                       max_new_tokens=4),
            eng.submit(suffix, max_new_tokens=4)]
    before = kv_ops.launches
    eng.run()
    launches = kv_ops.launches - before
    assert not eng._sharded and eng.n_shards == 3
    assert eng.cache.k_dtensor.to_local().data_ptr() == \
        eng.cache.k_pages.data_ptr()
    return (dict(outputs=[eng.outputs[r.rid] for r in reqs],
                 times=[list(r.token_times) for r in reqs],
                 fetch=[r.fetch_done for r in reqs],
                 events=list(cluster.events)),
            pages, launches, len(man.refs))


@pytest.mark.parametrize("fetch_mode", ["sync", "async"])
def test_mesh_sharded_engine_on_the_card_matches_the_cpu(cuda, fetch_mode):
    """A reduced lwm-7b of 8 layers (3 layer groups) served by the
    mesh-sharded engine on a (1, 1) mesh on the card (nccl, one rank)
    and on the CPU: equal tokens, token times and cluster events,
    restored pages bit-equal, and on the card one kv_restore launch per
    fetched chunk."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    cfg = reduce_config(get_config("lwm-7b"), num_layers=8)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, cfg.vocab_size, 48)
    suffix = rng.integers(0, cfg.vocab_size, 8)
    kv = paged_model.donor_prefix_kv(params, cfg, prefix)
    started = not dist.is_initialized()
    try:
        card_mesh = make_debug_mesh((1, 1), device=cuda)
        cpu_mesh = make_debug_mesh((1, 1), device="cpu")
        cpu = _sharded_engine_run("cpu", params, cfg, prefix, kv, suffix,
                                  cpu_mesh, fetch_mode)
        card = _sharded_engine_run(cuda, _to(params, cuda), cfg, prefix, kv,
                                   suffix, card_mesh, fetch_mode)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    assert card[0] == cpu[0]
    for kind in ("k", "v"):
        assert torch.equal(card[1][kind], cpu[1][kind]), kind
    assert cpu[2] == 0 and card[2] == card[3] == 3 * 3 * 2


@pytest.mark.parametrize("G", [3, 1])
def test_kv_restore_layers_at_deepseek_shapes(cuda, G):
    """deepseek-moe-16b's fetched chunk: 16 tokens, H 16, D 128, in a group
    of 3 layers and in its one-layer remainder group."""
    slots = [5, 0, -1, 9, 17, -1, 4, 30, 31, 2, -1, 11, 12, 13, 1, 3]
    pages, layers, q, scales, sl = _layers_case(
        G, 16, 16, 128, 28, 32, torch.float32, slots, 10 + G, cuda)
    want = kv_restore_layers_ref(pages.clone(), layers, q, scales, sl)
    before = kv_ops.launches
    got = kv_ops.kv_restore_layers(pages, layers, q, scales, sl)
    torch.cuda.synchronize()
    assert kv_ops.launches == before + 1
    assert torch.equal(got, want)


def test_paged_attention_at_deepseek_shapes(cuda):
    """deepseek-moe-16b's decode step: three sequences at context 543,
    H = K = 16 heads of dim 128, block tables 34 pages wide."""
    q, kp, vp, bt, cl = _paged_case(16, 16, 128, 16, [543] * 3, 34, 9, cuda)
    bt = torch.from_numpy(bt).to(cuda)
    want = paged_attention_ref(q, kp, vp, bt, cl)
    before = pa_ops.launches
    got = pa_ops.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    assert pa_ops.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_moe_on_the_card_matches_the_cpu(cuda):
    """deepseek's routing (64 experts, top 6, 2 shared, capacity factor
    1.25) at a narrow width: the same experts chosen on both devices, in
    both grouping forms, and the outputs within 1e-5."""
    import dataclasses

    from repro_torch.models import moe
    cfg = dataclasses.replace(
        reduce_config(get_config("deepseek-moe-16b")), num_experts=64,
        experts_per_token=6, num_shared_experts=2, moe_capacity_factor=1.25,
        d_model=64, d_ff=32)
    p = init_params(dataclasses.replace(cfg, num_layers=2),
                    torch.Generator().manual_seed(0),
                    device="cpu")["layers"][1]["moe"]
    x = torch.randn(3, 16, 64, generator=torch.Generator().manual_seed(1))
    for xs in (x, x[:, :1], x[:1]):  # prefill, paged decode, suffix group
        _, _, tope = moe.route(p, xs, cfg)
        _, _, tope_d = moe.route(_to(p, cuda), xs.to(cuda), cfg)
        assert torch.equal(tope, tope_d.cpu())
        out, aux = moe.apply_moe(p, xs, cfg)
        out_d, aux_d = moe.apply_moe(_to(p, cuda), xs.to(cuda), cfg)
        assert (out_d.cpu() - out).abs().max().item() <= 1e-5
        assert abs(float(aux_d) - float(aux)) <= 1e-6


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "recurrentgemma-9b"])
def test_ring_cache_decode_on_the_card_matches_the_cpu(cuda, arch):
    """A 72-token prompt overflows the reduced 64-token window: the ring
    cache's prefill and decode on the card against the CPU."""
    cfg = reduce_config(get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 76)))
    outs = []
    for dev, p in (("cpu", params), (cuda, _to(params, cuda))):
        cache = tf.init_cache(cfg, 2, 76, device=dev)
        logits, cache = tf.prefill(p, cfg, tokens=toks[:, :72].to(dev),
                                   cache=cache)
        steps = [logits[:, 0]]
        for i in range(72, 76):
            logits, cache = tf.decode_step(p, cfg, toks[:, i].to(dev), i,
                                           cache)
            steps.append(logits)
        outs.append(torch.stack(steps).cpu())
    scale = outs[0].abs().max().item()
    assert (outs[1] - outs[0]).abs().max().item() <= 2e-4 * scale


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One train step of each reduced assigned arch from weights drawn on
    the CPU, on both devices: loss and grad norm within 2e-4 relative,
    the updated parameters within tests/test_training.py's envelope for
    Adam (atol 5e-3 at lr 1e-3); reduced mamba2 through both kernels."""
    cfg = reduce_config(get_config(arch))
    opt = AdamW(lr=constant_schedule(1e-3))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in next(batches(
        cfg, DataConfig(batch_size=2, seq_len=32, seed=3))).items()}
    out = []
    for dev in ("cpu", cuda):
        # a copy on each device: the step updates it in place
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        state = TrainState(p, opt.init(p),
                           torch.zeros((), dtype=torch.int32, device=dev))
        before = (ssd_ops.launches, ssd_ops.bwd_launches)
        state, m = make_train_step(cfg, opt)(
            state, {k: v.to(dev) for k, v in batch.items()})
        n = cfg.num_layers if dev != "cpu" and arch == "mamba2-2.7b" else 0
        # remat: each layer's forward runs twice, its backward once
        assert (ssd_ops.launches - before[0],
                ssd_ops.bwd_launches - before[1]) == (2 * n, n)
        out.append((m, tree_map(lambda t: t.cpu(), state.params)))
    (m0, p0), (m1, p1) = out
    for k in ("loss", "grad_norm"):
        assert abs(float(m1[k]) - float(m0[k])) <= 2e-4 * abs(float(m0[k]))
    for (path, a), (_, b) in zip(flatten(p0), flatten(p1)):
        assert (a - b).abs().max().item() <= 5e-3, path


def test_kv_restore_refuses_grad(cuda):
    pages, q, scales, sl = _restore_case(8, 4, 16, 32, torch.float32,
                                         list(range(8)), 0, cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        kv_ops.kv_restore(pages.requires_grad_(), q, scales, sl)
    with pytest.raises(RuntimeError, match="no gradient"):
        kv_ops.kv_restore_layers(pages.detach()[None], [0], q[None],
                                 scales[None].requires_grad_(), sl)
    with torch.no_grad():
        kv_ops.kv_restore(pages, q, scales, sl)


def test_paged_attention_refuses_grad(cuda):
    q = torch.randn(2, 4, 32, device=cuda)
    kp = torch.randn(4, 16, 4, 32, device=cuda)
    vp = torch.randn_like(kp)
    bt = torch.arange(4, dtype=torch.int32, device=cuda).reshape(2, 2)
    cl = torch.tensor([20, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        pa_ops.paged_attention(q.requires_grad_(), kp, vp, bt, cl)
    with torch.no_grad():
        pa_ops.paged_attention(q, kp, vp, bt, cl)


def test_token_delta_refuses_grad(cuda):
    """Its tensors are uint8 and cannot require grad; a float tensor that
    does is refused for its gradient before its dtype."""
    video = torch.randint(0, 256, (3, 5, 7), dtype=torch.uint8, device=cuda)
    wants_grad = video.float().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        td_ops.token_delta_encode(wants_grad)
    with pytest.raises(RuntimeError, match="no gradient"):
        td_ops.token_delta_decode_frames(video[0], wants_grad)
    assert torch.equal(td_ops.token_delta_encode(video),
                       token_delta_encode_ref(video))


# -- the grouped expert kernels (kernels/moe_experts) --------------------------

def _moe_inputs(cuda, n, seed, E=64, k=6, d=2048, ff=1408):
    """deepseek-moe-16b's expert widths: x [n, d], k distinct experts a
    token with softmax-sized weights, wi [E, d, 2, ff], wo [E, ff, d]."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, d, device=cuda, generator=g)
    ids = torch.stack([torch.randperm(E, device=cuda, generator=g)[:k]
                       for _ in range(n)])
    w = torch.rand(n, k, device=cuda, generator=g) / k
    wi = torch.randn(E, d, 2, ff, device=cuda, generator=g) * d ** -0.5
    wo = torch.randn(E, ff, d, device=cuda, generator=g) * ff ** -0.5
    return x, ids, w, wi, wo


def _moe_close(got, want):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("n", [1, 3, 16, 256, 1024],
                         ids=["decode B=1", "decode B=3", "suffix 16",
                              "suffix 256", "prefill 1024"])
def test_moe_experts_kernel_matches_the_plain_path(cuda, n):
    """The sort, gate-up and down launches against the plain loop over
    the chosen experts, at each variant (skinny, tiled 32, tiled 64);
    the count of experts chosen read back."""
    from repro_torch.kernels.moe_experts import ops as moe_ops
    from repro_torch.kernels.moe_experts.ref import moe_experts_ref
    x, ids, w, wi, wo = _moe_inputs(cuda, n, n)
    before = moe_ops.launches
    got, used = moe_ops.moe_experts(x, ids, w, wi, wo)
    want, want_used = moe_experts_ref(x, ids, w, wi, wo)
    assert moe_ops.launches == before + 1
    _moe_close(got, want)
    assert int(used) == int(want_used) == len(torch.unique(ids))


def test_moe_experts_with_every_token_on_one_expert(cuda):
    """64 tokens all choosing expert 5 first: its rows span several tiles
    of every variant's size."""
    from repro_torch.kernels.moe_experts import ops as moe_ops
    from repro_torch.kernels.moe_experts.ref import moe_experts_ref
    for n in (64, 300):
        x, ids, w, wi, wo = _moe_inputs(cuda, n, 7)
        ids[:, 1:] = torch.where(ids[:, 1:] == 5, ids[:, :1], ids[:, 1:])
        ids[:, 0] = 5
        got, used = moe_ops.moe_experts(x, ids.contiguous(), w, wi, wo)
        want, want_used = moe_experts_ref(x, ids, w, wi, wo)
        _moe_close(got, want)
        assert int(used) == int(want_used)


def test_moe_experts_reads_no_expert_no_token_chose(cuda):
    """At a batch-1 decode step the 58 experts not chosen are NaN: the
    kernels never read them, so the output equals the clean one's."""
    from repro_torch.kernels.moe_experts import ops as moe_ops
    x, ids, w, wi, wo = _moe_inputs(cuda, 1, 3)
    clean, _ = moe_ops.moe_experts(x, ids, w, wi, wo)
    unchosen = torch.ones(64, dtype=torch.bool, device=cuda)
    unchosen[ids[0]] = False
    wi[unchosen] = float("nan")
    wo[unchosen] = float("nan")
    got, used = moe_ops.moe_experts(x, ids, w, wi, wo)
    assert torch.equal(got, clean) and int(used) == 6


def test_moe_layer_on_the_card_never_synchronises(cuda):
    """The dropless layer with its span on the card: no host
    synchronisation inside (CUDA's sync debug mode raises on one); the
    span's expert count arrives with the tokens' readback."""
    import dataclasses

    from repro_torch.models import moe
    cfg = dataclasses.replace(reduce_config(get_config("deepseek-moe-16b")),
                              num_experts=64, experts_per_token=6,
                              num_shared_experts=2)
    p = _to(init_params(dataclasses.replace(cfg, num_layers=2),
                        torch.Generator().manual_seed(0),
                        device="cpu")["layers"][1]["moe"], cuda)
    x = torch.randn(3, 1, cfg.d_model, device=cuda)
    moe.apply_moe_dropless(p, x, cfg)  # builds the kernels' library
    torch.cuda.synchronize()
    tr = tracing.Tracer()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.apply_moe_dropless(p, x, cfg, tr)
        (span,) = tr.spans("moe")
        assert "experts" not in span.counts
    finally:
        torch.cuda.set_sync_debug_mode("default")
    toks = tr.read_back(torch.argmax(out[:, 0], dim=-1))
    assert len(toks) == 3 and 6 <= span.counts["experts"] <= 18
    cpu = moe.apply_moe_dropless(_to(p, "cpu"), x.cpu(), cfg)
    assert (out.cpu() - cpu).abs().max().item() <= 1e-5 * cpu.abs().max()


def test_moe_experts_refuses_grad_and_odd_widths(cuda):
    from repro_torch.kernels.moe_experts import ops as moe_ops
    x, ids, w, wi, wo = _moe_inputs(cuda, 2, 1, E=8, k=2, d=128, ff=64)
    with pytest.raises(RuntimeError, match="no gradient"):
        moe_ops.moe_experts(x.requires_grad_(), ids, w, wi, wo)
    x = x.detach()
    with pytest.raises(ValueError, match="multiples of 64"):
        moe_ops.moe_experts(x, ids, w, wi[..., :48].contiguous(),
                            wo[:, :48].contiguous())


def _dense_err(y, ref):
    """relative Frobenius norm of y - ref, ref in fp64"""
    return ((y.double() - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("M", [64, 291, 1020, 3576])
@pytest.mark.parametrize("K,widths", [
    (4096, (4096, 512, 512)),  # yi-9b's q/k/v in one launch
    (4096, (4096,)),           # yi-9b's o
    (4096, (22016,)),          # yi-9b's SwiGLU wi
    (11008, (4096,)),          # yi-9b's MLP wo
    (2048, (2048, 2048, 2048)),  # deepseek-moe-16b's q/k/v
    (10944, (2048,)),          # deepseek-moe-16b's layer-0 MLP wo
], ids=["yi q/k/v", "yi o", "yi wi", "yi mlp wo", "ds q/k/v", "ds mlp wo"])
def test_dense_3xtf32_against_fp64_and_the_plain_product(cuda, M, K,
                                                         widths):
    """One launch for every weight; each output's error against an fp64
    product at most twice that of the plain version, torch.matmul in
    fp32 (TF32 off), and within 1e-5 of its largest magnitude."""
    from repro_torch.kernels.dense_3xtf32 import ops as dense_ops
    from repro_torch.kernels.dense_3xtf32.ref import dense_ref
    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn(M, K, device=cuda, generator=g)
    ws = [torch.randn(K, N, device=cuda, generator=g) * K ** -0.5
          for N in widths]
    before = dense_ops.launches
    got = dense_ops.dense_3xtf32(x, ws)
    assert dense_ops.launches == before + 1
    for y, p, w in zip(got, dense_ref(x, ws), ws):
        ref = x.double() @ w.double()
        assert _dense_err(y, ref) <= 2 * _dense_err(p, ref)
        assert (y - p).abs().max().item() <= 1e-5 * p.abs().max().item()


def test_dense_3xtf32_edges(cuda):
    """Rows, depth and widths that fill no tile: every output element
    written, none past the edges."""
    from repro_torch.kernels.dense_3xtf32 import ops as dense_ops
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(13, 36, device=cuda, generator=g)
    ws = [torch.randn(36, n, device=cuda, generator=g) for n in (12, 8, 132)]
    got = dense_ops.dense_3xtf32(x, ws)
    for y, w in zip(got, ws):
        ref = x.double() @ w.double()
        assert _dense_err(y, ref) <= 2 * _dense_err(x @ w, ref) + 1e-7


def test_dense_3xtf32_refuses_grad_and_odd_widths(cuda):
    from repro_torch.kernels.dense_3xtf32 import ops as dense_ops
    x = torch.randn(8, 64, device=cuda)
    w = torch.randn(64, 32, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        dense_ops.dense_3xtf32(x.clone().requires_grad_(), [w])
    with pytest.raises(ValueError, match="multiple of 4"):
        dense_ops.dense_3xtf32(x, [torch.randn(64, 30, device=cuda)])
    with pytest.raises(ValueError, match="contiguous"):
        dense_ops.dense_3xtf32(x, [w.T.contiguous().T])


def test_dense_routing_on_the_card(cuda):
    """A plain prefill of 264 tokens at a width that fills the card
    (d 2048, ff 5632; the output projection's and MLP wo's 16 column
    tiles give 80 blocks of 64 tokens, at least half of an H100's 132
    SMs): every dense product of its layers goes to the kernel, one launch
    each (q/k/v in one), and the first token's logits stay within 2e-4 of
    the largest of the CPU's, which runs torch.einsum; its decode steps
    route as many products and launch none."""
    import dataclasses

    from repro_torch.kernels.dense_3xtf32 import ops as dense_ops
    cfg = dataclasses.replace(reduce_config(get_config("lwm-7b")),
                              d_model=2048, num_heads=16, num_kv_heads=16,
                              head_dim=128, d_ff=5632)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, 264)))
    want, _ = paged_model.prefill_collect_kv(params, cfg, tokens)
    card = _to(params, cuda)
    p0, l0 = dense_ops.products, dense_ops.launches
    got, _ = paged_model.prefill_collect_kv(card, cfg, tokens.to(cuda))
    assert (dense_ops.products - p0 == dense_ops.launches - l0
            == 4 * cfg.num_layers)
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= 2e-4 * scale
    tr = tracing.Tracer()
    eng = LiveEngine(card, cfg, KVStore(), device=cuda, tracer=tr)
    eng.submit(tokens[0].numpy(), max_new_tokens=3)
    eng.run()
    (span,) = tr.spans("plain prefill")
    assert span.counts["tc_products"] == span.counts["products"] == \
        4 * cfg.num_layers
    steps = tr.spans("decode step")
    assert len(steps) == 2
    for s in steps:
        assert s.counts["products"] == 4 * cfg.num_layers
        assert s.counts["tc_products"] == 0


@pytest.mark.parametrize("b", [1, 3, 16])
def test_decode_output_projection_on_the_card_is_the_unrouted_product(
        cuda, b):
    """At yi-9b's widths (32 heads of 128, d 4096) a decode step's output
    projection through the routing, spelled as the prefills spell it,
    launches no kernel and is ``torch.einsum("bhk,hkd->bd")`` bit for
    bit."""
    from repro_torch.kernels.dense_3xtf32 import ops as dense_ops
    g = torch.Generator().manual_seed(b)
    out = torch.randn(b, 32, 128, generator=g).to(cuda)
    wo = (torch.randn(32, 128, 4096, generator=g) / 64).to(cuda)
    l0 = dense_ops.launches
    got = dense_ops.einsum("bshk,hkd->bsd", out[:, None], wo)
    assert dense_ops.launches == l0
    assert torch.equal(got[:, 0], torch.einsum("bhk,hkd->bd", out, wo))
