"""The port's kernel ops, held against the JAX package's on the CPU.

On CPU tensors each op runs its plain PyTorch version (``ref.py``); the
JAX side runs its Pallas kernel in interpret mode and its own ``ref.py``.
The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.kv_restore.ops import kv_restore as jax_kv_restore  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention as jax_paged_attention)

from repro_torch.kernels.kv_restore import ops as kv_ops  # noqa: E402
from repro_torch.kernels.kv_restore.ops import kv_restore  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention)

# ---------------------------------------------------------------------------
# kv_restore: bit-equal to the JAX op (same fp32 arithmetic)
# ---------------------------------------------------------------------------

# tests/test_kernels.py's head shapes, plus lwm-7b's 240p frame
KV_CASES = [(n, H, D, dt, seed)
            for n, (H, D) in [(1, (2, 8)), (3, (4, 16)), (4, (8, 128))]
            for dt in ("float32", "bfloat16") for seed in (0, 1)]
KV_CASES.append((8, 32, 128, "float32", 2))


def _restore_inputs(n, H, D, dtype, seed, R=12):
    rng = np.random.default_rng(seed)
    pages = rng.standard_normal((R, H, D)).astype(np.float32)
    q = rng.integers(0, 256, (n, H, D)).astype(np.uint8)
    scales = (rng.random(H) + 0.05).astype(np.float32)
    slots = rng.choice(np.arange(1, R), size=n, replace=False)
    if n > 1 and seed % 2:
        slots[-1] = -1  # one dropped token (rows >= 1, as the JAX test)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jpages = jnp.asarray(pages, jdt)
    tpages = torch.from_numpy(np.array(jpages.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return (jpages, tpages, q, scales, slots.astype(np.int32))


@pytest.mark.parametrize("n,H,D,dtype,seed", KV_CASES)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_kv_restore_matches_jax_bit_equal(n, H, D, dtype, seed, use_kernel):
    jpages, tpages, q, scales, slots = _restore_inputs(n, H, D, dtype, seed)
    want = jax_kv_restore(jpages, jnp.asarray(q), jnp.asarray(scales),
                          jnp.asarray(slots), use_kernel=use_kernel)
    got = kv_restore(tpages, torch.from_numpy(q), torch.from_numpy(scales),
                     torch.from_numpy(slots))
    assert got is tpages  # updated in place
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_kv_restore_slot_zero_with_dropped_tokens():
    """A real token in row 0 beside dropped tokens: row 0 holds the new
    token and the dropped tokens change nothing (the JAX op rewrites row 0
    with its old value for each dropped token, which on a parallel device
    races with the real write)."""
    jpages, pages, q, scales, _ = _restore_inputs(4, 8, 128, "float32", 5)
    old = pages.clone()
    slots = torch.tensor([0, -1, 7, -1], dtype=torch.int32)
    kv_restore(pages, torch.from_numpy(q), torch.from_numpy(scales), slots)
    deq = (torch.from_numpy(q).to(torch.float32) - 128.0) \
        * torch.from_numpy(scales)[None, :, None]
    assert torch.equal(pages[0], deq[0])
    assert torch.equal(pages[7], deq[2])
    untouched = [r for r in range(pages.shape[0]) if r not in (0, 7)]
    assert torch.equal(pages[untouched], old[untouched])


def test_ops_take_the_plain_version_on_cpu_and_refuse_other_devices():
    before = (kv_ops.launches, pa_ops.launches)
    _, pages, q, scales, slots = _restore_inputs(2, 4, 16, "float32", 0)
    kv_restore(pages, torch.from_numpy(q), torch.from_numpy(scales),
               torch.from_numpy(slots))
    assert (kv_ops.launches, pa_ops.launches) == before  # no kernel ran
    meta = torch.empty((4, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kv_restore(meta, q, scales, slots)
    with pytest.raises(ValueError, match="no kernel"):
        paged_attention(torch.empty((1, 4, 16), device="meta"), meta, meta,
                        meta, meta)


# ---------------------------------------------------------------------------
# paged_attention: within 3e-5 of the JAX op (as tests/test_kernels.py)
# ---------------------------------------------------------------------------

def _attention_inputs(B, H, K, hd, ps, P, bps, lens, seed, pad_tail=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, ps, K, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, K, hd)).astype(np.float32)
    bt = rng.permutation(P)[:B * bps].reshape(B, bps).astype(np.int32)
    cl = np.asarray(lens, np.int32)
    if pad_tail:
        # block_table_array's zero padding past each context
        for b in range(B):
            bt[b, -(-int(cl[b]) // ps):] = 0
    return q, kp, vp, bt, cl


ATTN_CASES = {
    # H, K, hd, ps, P, bps, context lens, padded trailing pages
    "mha": (8, 8, 32, 16, 9, 3, [48, 17], False),
    "gqa": (8, 2, 16, 8, 9, 4, [32, 5], False),
    "gqa_unaligned": (8, 2, 64, 16, 12, 5, [33, 71], False),
    "padded_tail": (4, 1, 128, 4, 12, 5, [9, 3], True),
    "lwm7b_frame": (32, 32, 128, 16, 8, 3, [40, 33], False),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("use_kernel", [True, False])
def test_paged_attention_matches_jax(case, use_kernel):
    H, K, hd, ps, P, bps, lens, pad = ATTN_CASES[case]
    q, kp, vp, bt, cl = _attention_inputs(len(lens), H, K, hd, ps, P, bps,
                                          lens, seed=len(case), pad_tail=pad)
    want = jax_paged_attention(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(bt),
                               jnp.asarray(cl), use_kernel=use_kernel,
                               interpret=True)
    got = paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, bt,
                                                           cl)))
    assert got.dtype == torch.float32 and got.shape == (len(lens), H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)
