"""The arithmetic of the port's rANS decode kernel (``kernels/rans_decode``),
held on the CPU against the host decoder before any card runs it.

``ref.rans_decode_ref`` runs the kernel's rounds: a table lookup and state
update in every lane, then the refills in ascending lane order at offsets
made of a warp rank (ballot and popcount) and a warp base.  It, and through
it ``ops.rans_decode_streams`` on CPU input, equals ``entropy.decode`` byte
for byte; the codec's card path (the chunk's streams decoded ahead, then
read frame by frame) yields the host path's frames.  Imports nothing of
JAX."""
import numpy as np
import pytest
import torch

from repro_torch.core import entropy
from repro_torch.core.codec import KVCodec
from repro_torch.core.layout import IntraLayout
from repro_torch.kernels.rans_decode import ops as rans_ops
from repro_torch.kernels.rans_decode.ref import (popc32, rans_decode_ref,
                                                 refill_offsets)

from _rans_cases import (CHUNK_LAYOUT, CHUNK_SYMBOLS, DISTS, cases,
                         chunk_blob, chunk_streams, symbols)


def _ref(blob) -> torch.Tensor:
    s = entropy.parse_stream(blob)
    return rans_decode_ref(s.n, torch.from_numpy(s.freq.astype(np.int64)),
                           torch.from_numpy(s.words.astype(np.int64)),
                           torch.from_numpy(s.states.astype(np.int64)))


@pytest.fixture(scope="module")
def chunk():
    return chunk_blob(28)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n,lanes", cases())
def test_plain_decode_equals_the_host_decoder(dist, n, lanes):
    data = symbols(dist, n, seed=n * 7 + lanes)
    blob = entropy.encode(data, lanes)
    want = entropy.decode(blob)
    np.testing.assert_array_equal(want, data)
    got = _ref(blob)
    assert got.dtype == torch.uint8 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    if n <= 1024 + 1:  # the wrapper on CPU input is the plain version
        (wrapped,) = rans_ops.rans_decode_streams([blob], "cpu")
        np.testing.assert_array_equal(wrapped.numpy(), want)


def test_plain_decode_of_a_chunks_six_streams(chunk):
    streams = chunk_streams(chunk)
    assert len(streams) == 6
    sizes = [entropy.parse_stream(s).n for s in streams]
    assert [sizes[2 * c] + sizes[2 * c + 1] for c in range(3)] == \
        [CHUNK_SYMBOLS] * 3
    assert sum(n > 0 for n in sizes) >= 4  # I and P streams both in use
    got = rans_ops.rans_decode_streams(streams, "cpu")
    for s, g in zip(streams, got):
        np.testing.assert_array_equal(g.numpy(), entropy.decode(s))


@pytest.mark.parametrize("lanes", [1, 31, 32, 33, 256, 1000, 1024])
def test_warp_refill_offsets_are_the_sequential_word_order(lanes):
    """Rank in the warp plus the warp's base is the lane's place among the
    round's refilling lanes, which is the order in which the host decoder
    hands out ``words[wpos:wpos + k]``."""
    rng = np.random.default_rng(lanes)
    for p in (0.0, 0.05, 0.5, 1.0):
        need = torch.from_numpy(rng.random(lanes) < p)
        offs, total = refill_offsets(need)
        seq = torch.cumsum(need.to(torch.int64), 0) - need.to(torch.int64)
        assert total == int(need.sum())
        assert torch.equal(offs[need], seq[need])
        assert torch.equal(torch.sort(offs[need]).values,
                           torch.arange(total))
    v = torch.from_numpy(rng.integers(0, 2**32, 1000, dtype=np.int64))
    assert popc32(v).tolist() == [bin(int(x)).count("1") for x in v]


def test_codec_reads_frames_from_streams_decoded_ahead(chunk, monkeypatch):
    """The codec's card path: the chunk's six streams decoded in one call
    before the first frame, each frame's residual plane a slice of them,
    gives the host path's frames; the call is timed in ``rans_s``."""
    calls = []
    plain = rans_ops.rans_decode_streams

    def on_cpu(streams, device):
        calls.append((len(streams), torch.device(device).type))
        return plain(streams, "cpu")

    monkeypatch.setattr(rans_ops, "rans_decode_streams", on_cpu)
    lay = IntraLayout(4, 128, *CHUNK_LAYOUT)
    host, card = KVCodec(4, 128, lay), KVCodec(4, 128, lay)
    want = list(host.iter_decode_frames(chunk))
    got = list(card.iter_decode_frames(chunk, "cuda"))
    assert calls == [(6, "cuda")]
    assert list(host.iter_decode_frames(chunk, "cpu")) and len(calls) == 1
    assert len(got) == len(want) == 9
    for (t1, q1), (t2, q2) in zip(got, want):
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(q1, q2)
    assert card.rans_s > 0.0


def test_wrapper_rejects_bad_streams():
    blob = entropy.encode(symbols("skewed", 500, 1), 32)
    with pytest.raises(ValueError, match="truncated"):
        rans_ops.rans_decode_streams([blob[:-3]], "cpu")
    with pytest.raises(ValueError, match="header"):
        rans_ops.rans_decode_streams([blob[:100]], "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        rans_ops.rans_decode_streams([blob], "meta")
    bad = bytearray(blob)
    bad[9:11] = (int.from_bytes(bad[9:11], "little") + 1).to_bytes(2,
                                                                 "little")
    with pytest.raises(ValueError, match="sum"):
        rans_ops.rans_decode_streams([bytes(bad)], "cpu")
    # a stream whose word count is off by one reads other than its words
    s = entropy.parse_stream(blob)
    with pytest.raises(ValueError, match="words"):
        rans_decode_ref(s.n, torch.from_numpy(s.freq.astype(np.int64)),
                        torch.from_numpy(s.words[:-1].astype(np.int64)),
                        torch.from_numpy(s.states.astype(np.int64)))
    got = rans_ops.rans_decode_streams(
        [torch.from_numpy(np.frombuffer(blob, np.uint8).copy())], "cpu")
    np.testing.assert_array_equal(got[0].numpy(), entropy.decode(blob))
