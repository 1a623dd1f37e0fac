"""The gradient of the port's ``ssd_scan`` on the CPU: the backward's plain
version (``ssd_scan_bwd_ref``, the backward kernel's arithmetic) against
``torch.autograd`` through ``ssd_scan_ref`` and against ``jax.vjp`` of
the JAX oracle ``repro.models.ssm.ssd_chunked``, within 1e-5 of each
gradient's largest magnitude (fp32 sums in another order); the
``torch.autograd.Function``'s wiring (padding, ``needs_input_grad``, a
final state the loss does not use) by ``gradcheck`` in fp64; and the
forward under ``torch.no_grad()`` saving nothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import ssm as jax_ssm  # noqa: E402

from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    piece_len, ssd_scan_bwd_ref, ssd_scan_ref)

TOL = 1e-5

# (b, s, nh, hd, G, S, chunk): s a multiple of the chunk and padded, one
# and two groups, a chunk above 64 (two pieces), Q = s
SHAPES = [(1, 64, 2, 8, 1, 4, 32), (1, 100, 2, 8, 1, 4, 32),
          (2, 64, 4, 16, 2, 8, 32), (1, 72, 3, 24, 3, 16, 64),
          (1, 130, 4, 8, 2, 8, 128), (1, 40, 2, 8, 1, 4, 64)]


def _inputs(b, s, nh, hd, G, S, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, s, nh, hd)) * 0.3).astype(dtype),
            (-np.abs(rng.standard_normal((b, s, nh))) * 0.5).astype(dtype),
            (rng.standard_normal((b, s, G, S)) * 0.3).astype(dtype),
            (rng.standard_normal((b, s, G, S)) * 0.3).astype(dtype),
            rng.standard_normal((b, s, nh, hd)).astype(dtype),
            rng.standard_normal((b, nh, hd, S)).astype(dtype)]


def _close(got, want, tol=TOL):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dstate", ["zero", "random"])
@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bwd_ref_matches_autograd_and_jax(shape, dstate):
    *dims, chunk = shape
    x, a, B, C, dy, ds = _inputs(*dims, seed=sum(shape))
    if dstate == "zero":
        ds = np.zeros_like(ds)
    got = ssd_scan_bwd_ref(*map(torch.as_tensor, (x, a, B, C, dy, ds)),
                           chunk=chunk)
    # torch.autograd through the plain forward
    leaves = [torch.tensor(t, requires_grad=True) for t in (x, a, B, C)]
    y, st = ssd_scan_ref(*leaves, chunk=chunk)
    auto = torch.autograd.grad(
        (y * torch.as_tensor(dy)).sum() + (st * torch.as_tensor(ds)).sum(),
        leaves)
    # jax.vjp of the JAX oracle
    _, vjp = jax.vjp(lambda *t: jax_ssm.ssd_chunked(*t, chunk=chunk),
                     *map(jnp.asarray, (x, a, B, C)))
    ref = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    for g, w_torch, w_jax in zip(got, auto, ref):
        _close(g, w_torch.numpy())
        _close(g, w_jax)


def test_piece_len():
    assert [piece_len(q) for q in (1, 40, 64, 65, 100, 128)] == \
        [1, 40, 64, 33, 50, 64]


def test_function_gradcheck_fp64():
    """The Function's backward against finite differences, with s padded
    (10 steps in chunks of 4) and two groups."""
    rng = np.random.default_rng(0)
    b, s, nh, hd, G, S = 1, 10, 4, 3, 2, 4
    args = [torch.tensor(rng.standard_normal(sh) * sc, requires_grad=True)
            for sh, sc in (((b, s, nh, hd), 0.3), ((b, s, nh), 0.3),
                           ((b, s, G, S), 0.3), ((b, s, G, S), 0.3))]
    with torch.no_grad():
        args[1].copy_(-args[1].abs())
    assert torch.autograd.gradcheck(
        lambda *t: ssd_ops.ssd_scan(*t, chunk=4), args)


def test_function_only_needed_grads_and_unused_state():
    """Only the inputs that require grad get one; a final state the loss
    does not use reaches the backward as zeros; the CPU runs the plain
    versions (no launch counted)."""
    x, a, B, C, dy, _ = map(torch.as_tensor, _inputs(1, 40, 2, 8, 1, 4, 3))
    xg, Cg = x.clone().requires_grad_(), C.clone().requires_grad_()
    before = (ssd_ops.launches, ssd_ops.bwd_launches)
    y, st = ssd_ops.ssd_scan(xg, a, B, Cg, chunk=16)
    assert st.grad_fn is not None
    (y * dy).sum().backward()
    assert (ssd_ops.launches, ssd_ops.bwd_launches) == before
    want = ssd_scan_bwd_ref(x, a, B, C, dy, torch.zeros(1, 2, 8, 4),
                            chunk=16)
    _close(xg.grad, want[0].numpy(), 0)
    _close(Cg.grad, want[3].numpy(), 0)


def test_no_grad_forward_saves_nothing():
    x, a, B, C, _, _ = map(torch.as_tensor, _inputs(1, 40, 2, 8, 1, 4, 4))
    args = [t.requires_grad_() for t in (x, a, B, C)]
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        with torch.no_grad():
            y, st = ssd_ops.ssd_scan(*args, chunk=16)
        assert not packed and y.grad_fn is None and st.grad_fn is None
        want_y, want_st = ssd_scan_ref(*args, chunk=16)
        assert packed  # with grad on, autograd through the plain version
    assert torch.equal(y, want_y.detach()) and torch.equal(st,
                                                           want_st.detach())
