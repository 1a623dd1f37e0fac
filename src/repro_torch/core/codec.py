"""KVCodec: quantized KV chunk [T, nl<=3, H, D] <-> compressed video chunk.

Pipeline (encode): intra-frame tiling -> inter-frame frame packing ->
per-plane prediction mode decision -> zigzag -> per-channel rANS streams.
Everything after quantization is bit-exact invertible.

Wire format:
  magic "KVF1" | u16 version | u16 T | u16 n_layers | u16 H | u16 D |
  u16 hr | u16 dr | u8 res_id | u8 pad | u32 F |
  modes (F*3 u8) | 3 x (u32 len | stream)

Residual symbols are frame-major per channel, so ``iter_decode_frames``
can entropy-decode incrementally and reconstruct frame-by-frame with a
single reference frame — the frame-wise restoration memory property.
"""
from __future__ import annotations

import dataclasses
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import entropy
from repro_torch.core.layout import (
    RESOLUTION_ORDER,
    FrameGeometry,
    IntraLayout,
    frame_geometry,
    intra_candidates,
    pack_frames,
    unpack_frames,
    unpack_single_frame,
)
from repro_torch.core.prediction import (
    ZIGZAG,
    predict_decode,
    predict_decode_frame,
    predict_encode,
)
from repro_torch.kernels.rans_decode import ops as rans_ops

MAGIC = b"KVF1"
_HDR = struct.Struct("<4sHHHHHHHBBI")


@dataclasses.dataclass(frozen=True)
class CodecOptions:
    lanes: int = 256
    allow_temporal: bool = True
    allow_intra: bool = True


@dataclasses.dataclass
class ChunkInfo:
    T: int
    n_layers: int
    H: int
    D: int
    layout: IntraLayout
    resolution: str
    geom: FrameGeometry


class KVCodec:
    """Codec for one architecture's KV geometry (H heads x D dims)."""

    def __init__(self, H: int, D: int,
                 layout: Optional[IntraLayout] = None,
                 options: CodecOptions = CodecOptions()):
        self.H, self.D = H, D
        self.layout = layout or IntraLayout(H, D, H, 1)  # identity-ish
        self.options = options
        # host seconds in the rANS streams' reads, summed over every
        # ``iter_decode_frames`` of this codec; on the card's path they
        # cover the upload, the launch, the wait and the readback
        self.rans_s = 0.0
        # bytes of symbols the running ``iter_decode_frames`` holds decoded
        # ahead of its frame loop: the whole chunk's on the card's path,
        # 0 on the host's
        self.held_bytes = 0

    # -- layout search (paper Fig. 14; offline, input-agnostic) ---------
    def search_layout(self, sample_q: np.ndarray,
                      resolution: str = "1080p",
                      log: Optional[list] = None) -> IntraLayout:
        """Pick the intra layout minimizing predicted+entropy-coded size
        over the O(log H x log D) candidate grid."""
        from repro_torch.core.layout import layout_fits
        best, best_cost = None, None
        for cand in intra_candidates(self.H, self.D):
            if not layout_fits(cand, resolution):
                if log is not None:
                    log.append((cand.hr, cand.dr, float("inf")))
                continue
            cost = self._layout_cost(sample_q, cand, resolution)
            if log is not None:
                log.append((cand.hr, cand.dr, cost))
            if best_cost is None or cost < best_cost:
                best, best_cost = cand, cost
        self.layout = best
        return best

    def _layout_cost(self, q: np.ndarray, lay: IntraLayout,
                     resolution: str) -> int:
        q3 = _to_3ch(q)
        geom = frame_geometry(q3.shape[0], lay, resolution)
        video = pack_frames(q3, lay, geom)
        zres, _ = predict_encode(video, self.options.allow_temporal,
                                 self.options.allow_intra)
        return entropy.coded_size_bound(zres)

    # -- encode ----------------------------------------------------------
    def encode_chunk(self, q: np.ndarray, resolution: str) -> bytes:
        """q [T, nl<=3, H, D] uint8 -> chunk bytes."""
        T, nl, H, D = q.shape
        assert (H, D) == (self.H, self.D) and nl <= 3
        q3 = _to_3ch(q)
        lay = self.layout
        geom = frame_geometry(T, lay, resolution)
        video = pack_frames(q3, lay, geom)
        zres, modes = predict_encode(video, self.options.allow_temporal,
                                     self.options.allow_intra)
        out = bytearray()
        out += _HDR.pack(MAGIC, 1, T, nl, H, D, lay.hr, lay.dr,
                         RESOLUTION_ORDER.index(resolution), 0,
                         geom.n_frames)
        out += modes.tobytes()
        # two entropy contexts per channel (the CABAC-context analogue):
        # I-planes (raw/left) and P-planes (temporal) have very different
        # statistics; mixing them in one table costs ~0.5 bits/symbol.
        from repro_torch.core.prediction import MODE_TEMPORAL
        for c in range(3):
            is_p = modes[:, c] == MODE_TEMPORAL
            i_syms = zres[~is_p, :, :, c].reshape(-1)
            p_syms = zres[is_p, :, :, c].reshape(-1)
            for syms in (i_syms, p_syms):
                stream = entropy.encode(syms, self.options.lanes)
                out += struct.pack("<I", len(stream))
                out += stream
        return bytes(out)

    # -- decode ----------------------------------------------------------
    def _parse(self, blob: bytes):
        magic, ver, T, nl, H, D, hr, dr, res_id, _, F = _HDR.unpack_from(
            blob, 0)
        assert magic == MAGIC and ver == 1
        lay = IntraLayout(H, D, hr, dr)
        resolution = RESOLUTION_ORDER[res_id]
        geom = frame_geometry(T, lay, resolution)
        assert geom.n_frames == F
        off = _HDR.size
        modes = np.frombuffer(blob, np.uint8, F * 3, off).reshape(F, 3)
        off += F * 3
        streams = []  # [(i_stream, p_stream)] per channel
        for _ in range(3):
            pair = []
            for _ in range(2):
                (ln,) = struct.unpack_from("<I", blob, off)
                off += 4
                pair.append(blob[off:off + ln])
                off += ln
            streams.append(tuple(pair))
        return ChunkInfo(T, nl, H, D, lay, resolution, geom), modes, streams

    def decode_chunk(self, blob: bytes) -> np.ndarray:
        """chunk bytes -> q [T, nl, H, D] uint8 (bulk path)."""
        info, modes, streams = self._parse(blob)
        from repro_torch.core.prediction import MODE_TEMPORAL
        fh, fw, _ = info.geom.frame_shape
        zres = np.empty((info.geom.n_frames, fh, fw, 3), np.uint8)
        for c in range(3):
            is_p = modes[:, c] == MODE_TEMPORAL
            i_dec = entropy.decode(streams[c][0])
            p_dec = entropy.decode(streams[c][1])
            zres[~is_p, :, :, c] = i_dec.reshape(-1, fh, fw)
            zres[is_p, :, :, c] = p_dec.reshape(-1, fh, fw)
        video = predict_decode(zres, modes)
        q3 = unpack_frames(video, info.layout, info.geom)
        return q3[:, :info.n_layers]

    def rans_streams(self, blob: bytes) -> List[bytes]:
        """The chunk's six rANS streams, I then P of each channel, in the
        order ``iter_decode_frames`` hands them to ``rans_decode``."""
        _, _, streams = self._parse(blob)
        return [s for pair in streams for s in pair]

    def iter_decode_frames(self, blob: bytes, device=None
                           ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Frame-wise decode: yields (token_ids, q [n, nl, H, D]).

        On the host (``device`` None or the CPU) the rANS streams are read
        a frame at a time, so only one reference frame + one residual
        frame are held (per channel) — the decompress-buffer bound of
        §3.3.2.  With a CUDA ``device`` the chunk's streams are decoded on
        the card in one ``rans_decode`` launch before the first frame, so
        the chunk's residuals are held whole on the host (1.58 MB for a
        yi-9b chunk of 1,024 tokens at 240p; ``held_bytes`` while the
        frames are read); reconstruction stays frame by frame on the host.
        """
        info, modes, streams = self._parse(blob)
        from repro_torch.core.prediction import MODE_TEMPORAL
        fh, fw, _ = info.geom.frame_shape
        fsz = fh * fw
        if device is not None and torch.device(device).type == "cuda":
            t0 = time.monotonic()  # repro-lint: allow(no-wall-clock)
            decoded = rans_ops.rans_decode_streams(
                [s for pair in streams for s in pair], device)
            # repro-lint: allow(no-wall-clock)
            self.rans_s += time.monotonic() - t0
            self.held_bytes = sum(d.nbytes for d in decoded)
            decoders = [(_Decoded(decoded[2 * c].numpy()),
                         _Decoded(decoded[2 * c + 1].numpy()))
                        for c in range(3)]
        else:
            decoders = [(entropy.StreamDecoder(si),
                         entropy.StreamDecoder(sp)) for si, sp in streams]
        prev = None
        for f in range(info.geom.n_frames):
            zres_f = np.empty((fh, fw, 3), np.uint8)
            t0 = time.monotonic()  # repro-lint: allow(no-wall-clock)
            for c in range(3):
                which = 1 if modes[f, c] == MODE_TEMPORAL else 0
                zres_f[:, :, c] = decoders[c][which].read(fsz).reshape(fh, fw)
            # repro-lint: allow(no-wall-clock)
            self.rans_s += time.monotonic() - t0
            frame = predict_decode_frame(zres_f, modes[f], prev)
            prev = frame
            toks, qt = unpack_single_frame(frame, info.layout, info.geom, f)
            yield toks, qt[:, :info.n_layers]
        self.held_bytes = 0

    def frame_count(self, blob: bytes) -> int:
        info, _, _ = self._parse(blob)
        return info.geom.n_frames


class _Decoded:
    """A stream decoded ahead: ``read`` hands out its symbols in order, as
    ``entropy.StreamDecoder.read`` does."""

    def __init__(self, symbols: np.ndarray):
        self.symbols = symbols
        self.pos = 0

    def read(self, count: int) -> np.ndarray:
        out = self.symbols[self.pos:self.pos + count]
        self.pos += out.size
        return out


def _to_3ch(q: np.ndarray) -> np.ndarray:
    """Zero-pad the layer axis to 3 (channels code independently)."""
    T, nl = q.shape[:2]
    if nl == 3:
        return q
    pad = np.zeros((T, 3 - nl) + q.shape[2:], np.uint8)
    return np.concatenate([q, pad], axis=1)
