"""The port's Mamba2 block and its chunked SSD scan, held against the JAX
package at fp32 on the CPU (the scan through its plain version; the JAX
side through the Pallas kernel in interpret mode and through its oracle).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

CFG = reduce_config(get_config("mamba2-2.7b"))
JAX_CFG = jax_reduce_config(jax_get_config("mamba2-2.7b"))
RTOL = 1e-5

# (b, s, nh, hd, G, S, chunk): tests/test_kernels.py's shapes, and s = 40
# with Q = s (not a power of two) as the snapshot test's prefix gives it
SCAN_SHAPES = [(1, 32, 2, 8, 1, 4, 32), (2, 64, 4, 16, 2, 8, 32),
               (1, 100, 2, 8, 1, 4, 32), (1, 40, 2, 8, 1, 4, 32),
               (1, 40, 2, 8, 1, 4, 64)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rtol=RTOL, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _scan_inputs(b, s, nh, hd, G, S, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return ((rng.standard_normal((b, s, nh, hd)) * 0.3).astype(f32),
            (-np.abs(rng.standard_normal((b, s, nh))) * 0.1).astype(f32),
            (rng.standard_normal((b, s, G, S)) * 0.3).astype(f32),
            (rng.standard_normal((b, s, G, S)) * 0.3).astype(f32))


@pytest.mark.parametrize("shape", SCAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("use_kernel,tol", [(True, 2e-4), (False, 1e-5)],
                         ids=["pallas_interpret", "jax_oracle"])
def test_ssd_scan_plain_matches_jax(shape, use_kernel, tol):
    *dims, chunk = shape
    args = _scan_inputs(*dims, seed=sum(shape))
    before = ssd_ops.launches
    y, st = ssd_ops.ssd_scan(*map(_t, args), chunk=chunk)
    assert ssd_ops.launches == before  # CPU tensors: the plain version
    y_j, st_j = jax_ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                             use_kernel=use_kernel)
    assert y.shape == y_j.shape and st.shape == st_j.shape
    _close(y, y_j, rtol=tol, atol=tol)
    _close(st, st_j, rtol=tol, atol=tol)


def test_segsum_matches():
    a = (-np.abs(np.random.default_rng(0).standard_normal((3, 9)))).astype(
        np.float32)
    got = ssm._segsum(_t(a)).numpy()
    want = np.asarray(jax_ssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-6)


def test_softplus_matches_jax_everywhere():
    x = np.concatenate([np.linspace(-40, 40, 161),
                        [0.0, 19.9, 20.0, 20.1, 88.0, -88.0]]).astype(
        np.float32)
    _close(ssm.softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)), rtol=1e-6,
           atol=1e-7)


def _ssm_params(seed):
    p = jax_ssm.init_ssm(JAX_CFG, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tree = {k: np.asarray(v) for k, v in p.items()}
    # non-trivial A, D, dt bias and norm, so every term is exercised
    nh, din = CFG.ssm_nheads, CFG.d_inner
    tree["A_log"] = (0.5 * rng.standard_normal(nh)).astype(np.float32)
    tree["D"] = (1 + 0.1 * rng.standard_normal(nh)).astype(np.float32)
    tree["dt_bias"] = (0.3 * rng.standard_normal(nh)).astype(np.float32)
    tree["norm_w"] = (0.1 * rng.standard_normal(din)).astype(np.float32)
    return ({k: _t(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def test_conv_full_matches():
    p, p_j = _ssm_params(0)
    convdim = CFG.d_inner + 2 * CFG.ssm_ngroups * CFG.ssm_state
    rng = np.random.default_rng(1)
    xbc = rng.standard_normal((2, 7, convdim)).astype(np.float32)
    prev = rng.standard_normal((2, CFG.ssm_conv - 1, convdim)).astype(
        np.float32)
    for pv in (None, prev):
        out, hist = ssm._conv_full(p, _t(xbc), None if pv is None
                                   else _t(pv))
        out_j, hist_j = jax_ssm._conv_full(p_j, jnp.asarray(xbc),
                                           None if pv is None
                                           else jnp.asarray(pv))
        _close(out, out_j)
        _close(hist, hist_j, rtol=0, atol=0)


@pytest.mark.parametrize("with_cache", [True, False])
def test_apply_ssm_full_matches(with_cache):
    p, p_j = _ssm_params(2)
    x = np.random.default_rng(3).standard_normal((2, 40, CFG.d_model)
                                                 ).astype(np.float32)
    out, cache = ssm.apply_ssm_full(p, _t(x), CFG, with_cache)
    out_j, cache_j = jax_ssm.apply_ssm_full(p_j, jnp.asarray(x), JAX_CFG,
                                            with_cache)
    _close(out, out_j)
    if with_cache:
        for k in ("state", "conv"):
            _close(cache[k], cache_j[k])
    else:
        assert cache is None and cache_j is None


def test_apply_ssm_decode_matches():
    p, p_j = _ssm_params(4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
    cache = {k: (0.5 * rng.standard_normal(tuple(v.shape))).astype(
        np.float32) for k, v in ssm.init_ssm_cache(CFG, 2,
                                                   device="cpu").items()}
    out, new = ssm.apply_ssm_decode(p, _t(x), CFG,
                                    {k: _t(v) for k, v in cache.items()})
    out_j, new_j = jax_ssm.apply_ssm_decode(
        p_j, jnp.asarray(x), JAX_CFG,
        {k: jnp.asarray(v) for k, v in cache.items()})
    _close(out, out_j)
    for k in ("state", "conv"):
        _close(new[k], new_j[k])


def test_init_ssm_cache_matches_jax():
    got = ssm.init_ssm_cache(CFG, 3, device="cpu")
    want = jax_ssm.init_ssm_cache(JAX_CFG, 3)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert not got[k].any()
