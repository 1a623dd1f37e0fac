"""The port's token-delta ops (the codec's inter-frame transform) on the
CPU, through their plain versions: bit-equal to the JAX ops with the
Pallas kernel (interpret mode) and with its jnp oracle, the one-frame
decode round trip, zigzag over every byte against the codec's tables, and
the encode of real packed frames against the numpy codec's TEMPORAL
residual.  Twins of tests/test_kernels.py's token_delta tests.  The stack
decode (``token_delta_decode_frames``, one launch per stack on the card)
is held against the JAX one-frame op chained frame by frame, and against
the numpy codec's TEMPORAL reconstruction of real packed planes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.token_delta.ops import (  # noqa: E402
    token_delta_decode_frame as jax_decode_frame,
    token_delta_encode as jax_encode)
from repro.kernels.token_delta.token_delta import (  # noqa: E402
    _unzigzag as jax_unzigzag, _zigzag as jax_zigzag)

from repro.core.prediction import (  # noqa: E402
    MODE_RAW, MODE_TEMPORAL, predict_decode)

from repro_torch.core.layout import (  # noqa: E402
    IntraLayout, frame_geometry, pack_frames)
from repro_torch.core.prediction import UNZIGZAG, ZIGZAG  # noqa: E402
from repro_torch.core.quantization import quantize  # noqa: E402
from repro_torch.kernels.token_delta import ops  # noqa: E402


@pytest.mark.parametrize("hw", [(8, 128), (16, 256), (5, 77)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("F", [1, 2, 3, 4, 5])
def test_encode_matches_jax(F, hw):
    H, W = hw
    rng = np.random.default_rng(F * 1000 + H)
    video = rng.integers(0, 256, (F, H, W)).astype(np.uint8)
    got = ops.token_delta_encode(torch.from_numpy(video)).numpy()
    assert got.dtype == np.uint8 and got.shape == (F, H, W)
    for use_kernel in (True, False):
        want = np.asarray(jax_encode(jnp.asarray(video),
                                     use_kernel=use_kernel))
        assert np.array_equal(got, want), use_kernel


@pytest.mark.parametrize("hw", [(8, 128), (3, 50)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_frame_roundtrip_matches_jax(hw, seed):
    H, W = hw
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, (4, H, W)).astype(np.uint8)
    zres = ops.token_delta_encode(torch.from_numpy(video))
    prev = torch.zeros((H, W), dtype=torch.uint8)
    jprev = jnp.zeros((H, W), jnp.uint8)
    for f in range(4):
        frame = ops.token_delta_decode_frame(prev, zres[f])
        assert frame.data_ptr() not in (prev.data_ptr(), zres.data_ptr())
        assert np.array_equal(frame.numpy(), video[f])
        jframe = jax_decode_frame(jprev, jnp.asarray(zres[f].numpy()),
                                  use_kernel=True)
        assert np.array_equal(frame.numpy(), np.asarray(jframe))
        prev, jprev = frame, jframe


def test_zigzag_over_every_byte_matches_the_luts():
    allb = np.arange(256, dtype=np.uint8)
    # frame 0's residual is the raw byte: encode of one frame is zigzag
    enc = ops.token_delta_encode(torch.from_numpy(allb.reshape(1, 1, 256)))
    assert np.array_equal(enc.numpy().reshape(-1), ZIGZAG)
    zero = torch.zeros((1, 256), dtype=torch.uint8)
    dec = ops.token_delta_decode_frame(zero,
                                       torch.from_numpy(allb.reshape(1, 256)))
    assert np.array_equal(dec.numpy().reshape(-1), UNZIGZAG)
    assert np.array_equal(np.asarray(jax_zigzag(jnp.asarray(allb))), ZIGZAG)
    assert np.array_equal(np.asarray(jax_unzigzag(jnp.asarray(allb))),
                          UNZIGZAG)


def test_encode_of_packed_frames_is_the_codecs_temporal_residual(
        synthetic_kv):
    """Real planes: quantized KV packed into 240p frames as the codec
    packs a chunk; every channel's encode equals the numpy codec's
    TEMPORAL candidate ZIGZAG[plane_f - plane_{f-1}] (frame 0: the raw
    plane), and the chained decode rebuilds every plane."""
    kv_k, _, _ = synthetic_kv(64, 3, 32, 128, seed=3)  # lwm-7b's K, hd
    q, _ = quantize(kv_k)  # [T, 3, H, D] uint8
    lay = IntraLayout(32, 128, 4, 4)  # 16 x 256 tiles, 15 to a frame
    geom = frame_geometry(q.shape[0], lay, "240p")
    video = pack_frames(q, lay, geom)  # [F, FH, FW, 3]
    assert video.shape[0] > 2
    for c in range(3):
        plane = np.ascontiguousarray(video[..., c])
        got = ops.token_delta_encode(torch.from_numpy(plane)).numpy()
        assert np.array_equal(got[0], ZIGZAG[plane[0]])
        for f in range(1, plane.shape[0]):
            assert np.array_equal(got[f], ZIGZAG[plane[f] - plane[f - 1]])
        prev = torch.zeros(plane.shape[1:], dtype=torch.uint8)
        for f in range(plane.shape[0]):
            prev = ops.token_delta_decode_frame(prev,
                                                torch.from_numpy(got[f]))
            assert np.array_equal(prev.numpy(), plane[f])


def test_ops_take_no_other_device():
    """CPU tensors go to the plain versions; a device without a kernel
    raises instead of falling back."""
    meta = torch.empty((2, 4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.token_delta_encode(meta)
    with pytest.raises(ValueError, match="no kernel"):
        ops.token_delta_decode_frame(meta[0], meta[1])
    with pytest.raises(ValueError, match="no kernel"):
        ops.token_delta_decode_frames(meta[0], meta)
    assert ops.encode_launches == 0 and ops.decode_launches == 0


def _stack(F, H, W, seed, prev_kind):
    """Seeded residuals [F, H, W] and a reference frame, zero or random."""
    rng = np.random.default_rng(seed)
    zres = rng.integers(0, 256, (F, H, W)).astype(np.uint8)
    prev = (np.zeros((H, W), np.uint8) if prev_kind == "zero"
            else rng.integers(0, 256, (H, W)).astype(np.uint8))
    return prev, zres


@pytest.mark.parametrize("prev_kind", ["zero", "random"])
@pytest.mark.parametrize("hw", [(8, 128), (5, 77), (3, 50)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("F", [1, 2, 5, 17])
def test_decode_frames_matches_jax_chained(F, hw, prev_kind):
    """One call over the stack == the JAX one-frame op chained frame by
    frame, with the Pallas kernel (interpret mode) and its jnp oracle."""
    prev, zres = _stack(F, *hw, seed=F * 100 + hw[1], prev_kind=prev_kind)
    got = ops.token_delta_decode_frames(torch.from_numpy(prev),
                                        torch.from_numpy(zres)).numpy()
    assert got.dtype == np.uint8 and got.shape == zres.shape
    for use_kernel in (True, False):
        jprev = jnp.asarray(prev)
        for f in range(F):
            jprev = jax_decode_frame(jprev, jnp.asarray(zres[f]),
                                     use_kernel=use_kernel)
            assert np.array_equal(got[f], np.asarray(jprev)), (use_kernel, f)


@pytest.mark.parametrize("split", [1, 8, 16])
def test_decode_frames_split_at_a_frame_equals_one_call(split):
    """A stack decoded in two calls, the second from the first's last
    frame, equals one call over the whole stack."""
    prev, zres = map(torch.from_numpy, _stack(17, 5, 77, seed=split,
                                              prev_kind="random"))
    whole = ops.token_delta_decode_frames(prev, zres)
    head = ops.token_delta_decode_frames(prev, zres[:split])
    tail = ops.token_delta_decode_frames(head[-1], zres[split:])
    assert torch.equal(torch.cat([head, tail]), whole)


@pytest.mark.parametrize("hw", [(8, 128), (3, 50)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_decode_frames_of_one_frame_is_decode_frame(hw):
    prev, zres = map(torch.from_numpy, _stack(1, *hw, seed=7,
                                              prev_kind="random"))
    got = ops.token_delta_decode_frames(prev, zres)
    assert got.shape == (1,) + hw
    assert torch.equal(got[0], ops.token_delta_decode_frame(prev, zres[0]))


def test_decode_frames_of_no_frames_is_empty():
    prev, zres = map(torch.from_numpy, _stack(0, 8, 128, seed=0,
                                              prev_kind="zero"))
    got = ops.token_delta_decode_frames(prev, zres)
    assert got.shape == (0, 8, 128) and got.dtype == torch.uint8


def test_decode_frames_rebuilds_packed_planes(synthetic_kv):
    """Real planes: each channel of quantized KV packed into 240p frames,
    encoded, then decoded in one call from a zero reference, equals the
    plane and the numpy codec's reconstruction with frame 0 RAW and every
    later frame TEMPORAL."""
    kv_k, _, _ = synthetic_kv(64, 3, 32, 128, seed=5)  # lwm-7b's K, hd
    q, _ = quantize(kv_k)
    lay = IntraLayout(32, 128, 4, 4)
    video = pack_frames(q, lay, frame_geometry(q.shape[0], lay, "240p"))
    F = video.shape[0]
    assert F > 2
    modes = np.full((F, video.shape[-1]), MODE_TEMPORAL, np.uint8)
    modes[0] = MODE_RAW
    zres = np.empty_like(video)
    for c in range(video.shape[-1]):
        plane = np.ascontiguousarray(video[..., c])
        zres[..., c] = ops.token_delta_encode(
            torch.from_numpy(plane)).numpy()
    codec = predict_decode(zres, modes)  # [F, FH, FW, 3]
    for c in range(video.shape[-1]):
        got = ops.token_delta_decode_frames(
            torch.zeros(video.shape[1:3], dtype=torch.uint8),
            torch.from_numpy(np.ascontiguousarray(zres[..., c]))).numpy()
        assert np.array_equal(got, video[..., c])
        assert np.array_equal(got, codec[..., c])
