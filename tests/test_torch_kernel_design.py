"""The arithmetic of the port's Hopper kernel designs, held against the JAX
package on the CPU before any card runs them.

- ``paged_attention`` splits the page axis across blocks and merges the
  partials: the split plan covers every page once, and the plain
  split-and-merge (``ref.paged_attention_split_ref``) equals the plain
  version and the JAX op (Pallas in interpret mode, and its ``ref``).
- ``ssd_scan`` forms every product in 3xTF32 (a truncation split) on the
  tensor cores and runs chunks in pieces of at most 64 steps: the
  emulation of that arithmetic (``ref.ssd_scan_3xtf32_ref``) stays within
  the card's tolerance of the plain version and of the JAX op.
- ``ssd_scan``'s backward kernel forms its products in 3xTF32 too: the
  emulation (``ref.ssd_scan_bwd_3xtf32_ref``) stays within the card's
  tolerance of the plain backward and of ``jax.vjp`` of the JAX oracle,
  and its blocks fit the card's shared memory at every shape the forward
  accepts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention as jax_paged_attention)
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref, paged_attention_split_ref, split_range)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    mm_3xtf32, ssd_scan_3xtf32_ref, ssd_scan_bwd_3xtf32_ref,
    ssd_scan_bwd_ref, ssd_scan_ref, tf32_truncate)

# ---------------------------------------------------------------------------
# paged_attention: the split plan and the split-and-merge arithmetic
# ---------------------------------------------------------------------------

# (B, H, K, table width in pages, contexts, page size): chip_smoke.py's
# decode batch at lwm-7b's and yi-34b's heads, its storage phase's one
# request alone (in tables 36 and 34 pages wide: the cache's own width is
# 34), its fleet phase's decode steps, and small shapes
PLAN_CASES = [
    (3, 32, 32, 36, [543, 543, 543], 16),
    (1, 32, 32, 36, [543], 16),
    (3, 56, 8, 36, [543, 543, 543], 16),
    (3, 32, 32, 34, [543, 543, 543], 16),
    (1, 32, 32, 34, [543], 16),
    (1, 32, 32, 18, [273], 16),
    (2, 32, 32, 18, [273, 274], 16),
    (2, 32, 32, 34, [274, 529], 16),
    (2, 32, 32, 34, [529, 530], 16),
    (2, 8, 2, 8, [60, 1], 8),
    (4, 4, 1, 5, [33, 17, 9, 1], 8),
    (1, 64, 8, 250, [4000], 16),
    (12, 32, 32, 19, [300] * 12, 16),
]


@pytest.mark.parametrize("B,H,K,bps,lens,ps", PLAN_CASES)
def test_split_plan_covers_every_page_once(B, H, K, bps, lens, ps):
    n_split = pa_ops.plan_splits(B, H, K, bps)
    assert 1 <= n_split <= max(1, -(-bps // pa_ops.MIN_PAGES_PER_SPLIT))
    for ctx in lens + [1, bps * ps, bps * ps - 1, ps, ps + 1]:
        n_pages = -(-ctx // ps)
        seen = []
        for s in range(n_split):
            p0, p1 = split_range(n_pages, n_split, s)
            assert 0 <= p0 <= p1 <= n_pages
            seen.extend(range(p0, p1))
        assert sorted(seen) == list(range(n_pages))  # each page once


def test_split_plan_fills_the_card_at_the_path_shapes():
    """About two blocks per SM: 3 splits of ~12 pages at lwm-7b's heads,
    11 of ~3 pages at yi-34b's (3 sequences, 36-page tables, 132 SMs),
    and 9 of ~4 pages for one lwm-7b sequence alone."""
    assert pa_ops.plan_splits(3, 32, 32, 36, n_sm=132) == 3
    assert pa_ops.plan_splits(1, 32, 32, 36, n_sm=132) == 9
    assert pa_ops.plan_splits(3, 56, 8, 36, n_sm=132) == 11
    # the cache's own 34-page tables split alike; the fleet's steps
    assert pa_ops.plan_splits(3, 32, 32, 34, n_sm=132) == 3
    assert pa_ops.plan_splits(1, 32, 32, 34, n_sm=132) == 9
    assert pa_ops.plan_splits(1, 32, 32, 18, n_sm=132) == 9
    assert pa_ops.plan_splits(2, 32, 32, 34, n_sm=132) == 5
    assert pa_ops.plan_splits(12, 32, 32, 19, n_sm=132) == 1
    assert pa_ops.plan_splits(1, 8, 2, 2, n_sm=132) == 1  # one page pair
    assert split_range(34, 3, 2) == (24, 34)
    assert split_range(34, 11, 10) == (34, 34)  # an empty split


# (H, K, hd, ps, lens, n_split): splits that hold no page (short
# sequences, ctx = 1, more splits than pages), and splits whose last page
# is partly masked
SPLIT_CASES = [
    (8, 2, 32, 8, [13, 40, 1], 4),
    (8, 2, 32, 8, [1], 3),
    (4, 4, 16, 4, [7, 30, 2, 16], 9),
    (16, 2, 16, 8, [64, 5], 2),
    (4, 1, 8, 16, [100], 1),
    # the fleet's unequal pair: the shorter sequence leaves its last
    # splits empty
    (8, 2, 32, 16, [274, 529], 5),
]


@pytest.mark.parametrize("H,K,hd,ps,lens,n_split", SPLIT_CASES)
def test_split_and_merge_matches_plain_and_jax(H, K, hd, ps, lens, n_split):
    rng = np.random.default_rng(sum(lens) + n_split)
    B = len(lens)
    bps = max(-(-n // ps) for n in lens) + 1
    P = B * bps + 2
    f32 = np.float32
    q = rng.standard_normal((B, H, hd)).astype(f32)
    kp = rng.standard_normal((P, ps, K, hd)).astype(f32)
    vp = rng.standard_normal((P, ps, K, hd)).astype(f32)
    bt = rng.permutation(P)[:B * bps].reshape(B, bps).astype(np.int32)
    cl = np.asarray(lens, np.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, cl)]
    got = paged_attention_split_ref(*args, n_split)
    assert not torch.isnan(got).any()
    want = paged_attention_ref(*args)
    assert (got - want).abs().max().item() <= 3e-5
    for use_kernel in (True, False):
        jax_out = np.asarray(jax_paged_attention(
            *map(jnp.asarray, (q, kp, vp, bt, cl)), use_kernel=use_kernel))
        np.testing.assert_allclose(got.numpy(), jax_out, rtol=0, atol=3e-5)


# ---------------------------------------------------------------------------
# ssd_scan: 3xTF32 products and pieces of at most 64 steps
# ---------------------------------------------------------------------------

def test_tf32_truncation_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -9
                      + 2 ** -12), 1 - 2 ** -24, 3.0e-30, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1 + 2 ** -10, -(1 + 2 ** -9),
                         1 - 2 ** -11], dtype=torch.float32)
    got = tf32_truncate(x)
    assert torch.equal(got[:5], want)
    bits = got.view(torch.int32)
    assert torch.equal(bits & 0x1FFF, torch.zeros_like(bits))
    # the remainder is exact, and its own truncation leaves < 2^-20 of x
    rest = x - got
    assert torch.equal(got + rest, x)
    left = (rest - tf32_truncate(rest)).abs()
    assert (left <= 2 ** -20 * x.abs()).all()


def test_3xtf32_product_is_near_fp32_and_1xtf32_is_not():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    err3 = (mm_3xtf32(a, b).double() - exact).abs().max().item()
    err1 = ((tf32_truncate(a) @ tf32_truncate(b)).double() - exact).abs(
        ).max()
    err32 = ((a @ b).double() - exact).abs().max().item()
    assert err3 <= 4 * err32 + 1e-6
    assert err1.item() > 30 * err3


def _scan_inputs(b, s, nh, hd, G, S, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return ((rng.standard_normal((b, s, nh, hd)) * 0.3).astype(f32),
            (-np.abs(rng.standard_normal((b, s, nh))) * 0.1).astype(f32),
            (rng.standard_normal((b, s, G, S)) * 0.3).astype(f32),
            (rng.standard_normal((b, s, G, S)) * 0.3).astype(f32))


_M = reduce_config(get_config("mamba2-2.7b"))
# reduced mamba2 at its prefill chunk (64), padded, at chunk 128 (two
# pieces), and with two groups
SCAN_CASES = [
    (1, 128, _M.ssm_nheads, _M.ssm_head_dim, _M.ssm_ngroups, _M.ssm_state,
     64),
    (2, 100, _M.ssm_nheads, _M.ssm_head_dim, _M.ssm_ngroups, _M.ssm_state,
     64),
    (1, 200, _M.ssm_nheads, _M.ssm_head_dim, _M.ssm_ngroups, _M.ssm_state,
     128),
    (1, 96, 8, 64, 2, 128, 64),
]


@pytest.mark.parametrize("b,s,nh,hd,G,S,chunk", SCAN_CASES)
def test_3xtf32_scan_matches_plain_and_jax(b, s, nh, hd, G, S, chunk):
    args = _scan_inputs(b, s, nh, hd, G, S, s + nh)
    targs = [torch.from_numpy(a) for a in args]
    y, st = ssd_scan_3xtf32_ref(*targs, chunk=chunk)
    want_y, want_st = ssd_scan_ref(*targs, chunk=chunk)
    y_j, st_j = jax_ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                             use_kernel=False)
    for got, want, jax_want in ((y, want_y, y_j), (st, want_st, st_j)):
        assert got.shape == want.shape
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 2e-4 * scale
        assert np.abs(got.numpy() - np.asarray(jax_want)).max() \
            <= 2e-4 * scale


def test_scan_plan_fits_every_allowed_shape():
    """Pieces of at most 64 steps, two hd slices where hd is a multiple of
    16, and shared memory within one block's limit for every shape the op
    accepts; at the path's shape two blocks fit on one SM."""
    assert ssd_ops.plan(64, 64) == (64, 2)
    assert ssd_ops.plan(128, 64) == (64, 2)
    assert ssd_ops.plan(40, 8) == (40, 1)
    assert ssd_ops.plan(100, 24) == (50, 1)
    for Q in (1, 16, 40, 64, 65, 100, 128):
        for hd in (8, 16, 24, 64, 120, 128):
            for S in (4, 64, 128):
                assert ssd_ops.smem_bytes(Q, hd, S) <= ssd_ops.MAX_SMEM
    assert 2 * (ssd_ops.smem_bytes(64, 64, 128) + 1024) <= 233_472


@pytest.mark.parametrize("b,s,nh,hd,G,S,chunk",
                         SCAN_CASES + [(1, 256, 4, 128, 1, 128, 64)])
def test_3xtf32_scan_bwd_matches_plain_and_jax(b, s, nh, hd, G, S, chunk):
    """The backward kernel's arithmetic (every product in 3xTF32, C.B^T
    once per group) against ``ssd_scan_bwd_ref`` and ``jax.vjp`` of the
    JAX oracle, from a seeded dy and non-zero dstate: each gradient within
    2e-4 of its largest magnitude, the card's gate (da_log, a sum of
    E's row and column sums that cancel, included); the reduced mamba2
    cases, two groups, and 128-wide heads with state 128."""
    args = _scan_inputs(b, s, nh, hd, G, S, s + hd)
    rng = np.random.default_rng(s + hd + 1)
    dy = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    ds = rng.standard_normal((b, nh, hd, S)).astype(np.float32)
    targs = [torch.from_numpy(a) for a in (*args, dy, ds)]
    got = ssd_scan_bwd_3xtf32_ref(*targs, chunk=chunk)
    want = ssd_scan_bwd_ref(*targs, chunk=chunk)
    _, vjp = jax.vjp(lambda *t: jax_ssd_chunked(*t, chunk=chunk),
                     *map(jnp.asarray, args))
    jax_want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    for g, w, wj in zip(got, want, jax_want):
        assert g.shape == w.shape == wj.shape
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 2e-4 * scale
        assert np.abs(g.numpy() - np.asarray(wj)).max() <= 2e-4 * scale


def test_bwd_plan_fits_every_allowed_shape():
    """The backward's blocks fit one block's shared memory at every shape
    the forward accepts (so the op never refuses a gradient the forward
    took), and at the training path's shape two of the larger block fit
    on one SM; a sweep block holds at most 64 x 64 of a head's state."""
    assert ssd_ops.bwd_plan(64, 64, 128) == (64, 1, 2)
    assert ssd_ops.bwd_plan(128, 128, 128) == (64, 2, 2)
    assert ssd_ops.bwd_plan(40, 65, 64) == (40, 2, 1)
    for Q in (1, 16, 33, 40, 64, 65, 100, 127, 128):
        for hd in (1, 8, 16, 24, 63, 64, 65, 120, 127, 128):
            for S in (1, 4, 63, 64, 127, 128):
                if ssd_ops.smem_bytes(Q, hd, S) <= ssd_ops.MAX_SMEM:
                    assert ssd_ops.bwd_smem_bytes(Q, hd, S) \
                        <= ssd_ops.MAX_SMEM
    assert 2 * (ssd_ops.bwd_smem_bytes(64, 64, 128) + 1024) <= 233_472
