"""The port's own copies of the numpy-only modules agree with the JAX
package's: configs, codec (byte-identical encodes), fetch plans,
scheduler, allocator, workload and the flat KVStore."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster.storage import KVStore as JaxKVStore  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.core.chunks import encode_prefix as jax_encode_prefix  # noqa: E402
from repro.core.codec import KVCodec as JaxKVCodec  # noqa: E402
from repro.core.fetch import build_plan as jax_build_plan  # noqa: E402
from repro.core.layout import IntraLayout as JaxIntraLayout  # noqa: E402
from repro.core.scheduler import (  # noqa: E402
    FetchingAwareScheduler as JaxScheduler, Request as JaxRequest)
from repro.data.workload import (  # noqa: E402
    shared_prefix_tokens as jax_shared_prefix_tokens)
from repro.paged.allocator import PageAllocator as JaxAllocator  # noqa: E402

from repro_torch.cluster.storage import KVStore  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.chunks import (  # noqa: E402
    decode_chunk_tokens, encode_prefix, prefix_key)
from repro_torch.core.codec import KVCodec  # noqa: E402
from repro_torch.core.fetch import build_plan  # noqa: E402
from repro_torch.core.layout import IntraLayout  # noqa: E402
from repro_torch.core.scheduler import (  # noqa: E402
    FetchingAwareScheduler, Request)
from repro_torch.data.workload import shared_prefix_tokens  # noqa: E402
from repro_torch.paged.allocator import PageAllocator  # noqa: E402


@pytest.mark.parametrize("name", ["lwm-7b", "yi-34b", "llama3-70b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match(name, reduced):
    cfg, ref = get_config(name), jax_get_config(name)
    if reduced:
        cfg, ref = reduce_config(cfg), jax_reduce_config(ref)
    # the port's MoE routing fields, at the JAX package's routing
    ours = dataclasses.asdict(cfg)
    assert (ours.pop("norm_topk_prob"), ours.pop("moe_dropless")) == (
        True, False)
    assert ours == dataclasses.asdict(ref)
    assert cfg.kv_bytes_per_token() == ref.kv_bytes_per_token()
    assert cfg.param_count() == ref.param_count()


@pytest.mark.parametrize("T,L,H,D,tpc,layout", [
    (40, 4, 8, 32, 16, None),     # layout searched
    (24, 3, 4, 16, 10, (2, 4)),   # fixed layout, ragged last chunk
])
def test_encode_prefix_byte_identical(synthetic_kv, T, L, H, D, tpc,
                                      layout):
    kv_k, kv_v, toks = synthetic_kv(T, L, H, D, seed=T)
    kw = dict(prefix=prefix_key(toks), tokens_per_chunk=tpc,
              resolutions=("240p", "480p"))
    ours = encode_prefix(kv_k, kv_v, layout=None if layout is None
                         else IntraLayout(H, D, *layout), **kw)
    ref = jax_encode_prefix(kv_k, kv_v, layout=None if layout is None
                            else JaxIntraLayout(H, D, *layout), **kw)
    assert ours.layout == ref.layout
    assert ours.blobs == ref.blobs
    assert ours.scales.keys() == ref.scales.keys()
    for kind in ours.scales:
        np.testing.assert_array_equal(ours.scales[kind], ref.scales[kind])
    assert [dataclasses.astuple(r) for r in ours.refs] == \
        [dataclasses.astuple(r) for r in ref.refs]
    # frame-wise decode of our blobs with the JAX codec and vice versa
    lay = IntraLayout(H, D, *ours.layout)
    jlay = JaxIntraLayout(H, D, *ref.layout)
    for r in ours.refs:
        blob = ours.blobs[(r.chunk_id, "240p")]
        ours_frames = list(KVCodec(H, D, lay).iter_decode_frames(blob))
        ref_frames = list(JaxKVCodec(H, D, jlay).iter_decode_frames(blob))
        assert len(ours_frames) == len(ref_frames)
        for (t1, q1), (t2, q2) in zip(ours_frames, ref_frames):
            np.testing.assert_array_equal(t1, t2)
            np.testing.assert_array_equal(q1, q2)
    deq = decode_chunk_tokens(ours, ours.refs[0].chunk_id, "240p", H, D)
    assert deq.shape == (min(tpc, T), len(ours.refs[0].layers), H, D)


def test_kvstore_matches_jax_facade(synthetic_kv):
    kv_k, kv_v, toks = synthetic_kv(20, 3, 4, 16, seed=3)
    ours, ref = KVStore(), JaxKVStore()
    kw = dict(tokens_per_chunk=8, resolutions=("240p",))
    m1 = ours.register_prefix(toks, kv_k, kv_v, **kw)
    m2 = ref.register_prefix(toks, kv_k, kv_v, **kw)
    key = prefix_key(toks)
    assert m1.prefix == m2.prefix == key
    assert ours.stored_bytes() == ref.stored_bytes()
    assert list(ours.manifests) == list(ref.manifests) == [key]
    assert ours.lookup(key) is m1 and ours.lookup("missing") is None
    cid = m1.refs[0].chunk_id
    assert ours.get_chunk(key, cid, "240p") == ref.get_chunk(key, cid,
                                                             "240p")


def test_build_plan_matches(synthetic_kv):
    kv_k, kv_v, toks = synthetic_kv(30, 7, 4, 16, seed=4)
    man = encode_prefix(kv_k, kv_v, prefix="p", tokens_per_chunk=12,
                        resolutions=("240p",))
    jman = jax_encode_prefix(kv_k, kv_v, prefix="p", tokens_per_chunk=12,
                             resolutions=("240p",))
    plan, jplan = build_plan(5, man), jax_build_plan(5, jman)
    assert [(c.ref.chunk_id, c.sizes) for c in plan.chunks] == \
        [(c.ref.chunk_id, c.sizes) for c in jplan.chunks]
    assert plan.n_layers_total == jplan.n_layers_total == 7
    for c in plan.chunks[:6]:  # layer group 0: k and v of its 3 chunks
        c.t_restored = 1.0
    assert plan.layers_ready() == 3 and not plan.done


@pytest.mark.parametrize("policy", ["kvfetcher", "fetch_agnostic"])
def test_scheduler_matches(policy):
    def drive(sched_cls, req_cls):
        s = sched_cls(policy, max_running=2)
        reqs = [req_cls(rid=i, arrival=float(i), prompt_len=10,
                        reuse_tokens=6 if i % 2 else 0) for i in range(5)]
        log = []
        for r in reqs:
            s.submit(r, r.arrival)
        for t in range(6):
            adm = s.schedule(float(t))
            fetches = s.take_fetches()
            log.append(([r.rid for r in adm], [r.rid for r in fetches]))
            for r in fetches:
                s.notify_fetch_done(r, float(t))
            if s.running:
                s.finish(s.running[0], float(t))
        return log, [r.state.value for r in reqs]

    assert drive(FetchingAwareScheduler, Request) == \
        drive(JaxScheduler, JaxRequest)


def test_allocator_and_workload_match():
    a, b = PageAllocator(8), JaxAllocator(8)
    for alloc in (a, b):
        alloc.allocate(0, 3)
        alloc.allocate(1, 2)
        alloc.release(0)
        alloc.extend(1, 4)
    assert a.owned == b.owned and a.free == b.free
    with pytest.raises(MemoryError):
        a.allocate(2, 9)
    p1, q1 = shared_prefix_tokens(np.random.default_rng(7), 100, 12, 3, 4)
    p2, q2 = jax_shared_prefix_tokens(np.random.default_rng(7), 100, 12, 3,
                                      4)
    np.testing.assert_array_equal(p1, p2)
    for x, y in zip(q1, q2):
        np.testing.assert_array_equal(x, y)


# -- the layout baselines and the tensor quantizer ----------------------------

def _seeded_q(seed):
    """A seeded uint8 chunk [T, L, H, D] with power-of-two H and D."""
    rng = np.random.default_rng(seed)
    T, L = int(rng.integers(1, 12)), int(rng.integers(3, 10))
    H, D = 2 ** int(rng.integers(0, 4)), 2 ** int(rng.integers(2, 6))
    return rng.integers(0, 256, (T, L, H, D), dtype=np.uint8)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("name", ["layer_slice_frames", "head_slice_frames"])
def test_slicing_baselines_byte_equal_jax(name, seed):
    from repro.core import layout as jax_layout
    from repro_torch.core import layout
    q = _seeded_q(seed)
    got, want = getattr(layout, name)(q), getattr(jax_layout, name)(q)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", range(8))
def test_token_stitched_single_frame_byte_equal_jax(seed):
    from repro.core import layout as jax_layout
    from repro_torch.core import layout
    q = _seeded_q(seed)
    T, L, H, D = q.shape
    rng = np.random.default_rng(100 + seed)
    cands = layout.intra_candidates(H, D)
    lay = cands[int(rng.integers(len(cands)))]
    chunk = q[:, :3]
    got = layout.token_stitched_single_frame(chunk, lay)
    want = jax_layout.token_stitched_single_frame(
        chunk, jax_layout.IntraLayout(lay.H, lay.D, lay.hr, lay.dr))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", range(8))
def test_quantize_torch_bit_equal_jax(seed):
    import jax.numpy as jnp
    from repro.core import quantization as jax_quant
    from repro_torch.core import quantization as quant
    rng = np.random.default_rng(seed)
    shape = tuple(int(n) for n in rng.integers(1, 9, 4))
    kv = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(
        np.float32)
    jq, js = jax_quant.quantize_jnp(jnp.asarray(kv))
    q, s = quant.quantize_torch(kv, device="cpu")
    assert q.dtype == torch.uint8 and q.device.type == "cpu"
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=0)
    # given scales are used as they are; dequantize inverts the integers
    q2, s2 = quant.quantize_torch(kv, scales=s, device="cpu")
    jq2, _ = jax_quant.quantize_jnp(jnp.asarray(kv), jnp.asarray(js))
    assert q2.numpy().tobytes() == np.asarray(jq2).tobytes()
    deq = quant.dequantize_torch(q, s, device="cpu")
    jdeq = jax_quant.dequantize_jnp(jq, js)
    assert deq.numpy().tobytes() == np.asarray(jdeq).tobytes()
