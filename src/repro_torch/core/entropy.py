"""Interleaved multi-lane rANS entropy coder (lossless, byte alphabet).

This is the "bitstream engine" of the KV codec: the entropy stage that on
GPUs lives inside NVENC/NVDEC.  Encoding runs here on the host; decoding
runs here on the host on the CPU path (``StreamDecoder``), and on the card
through ``kernels/rans_decode`` (one launch per fetched chunk, every stream
of it at once) when the engine serves on CUDA.  It is a
real, self-contained compressor: static per-chunk frequency tables (12-bit
precision, add-1 smoothed so every byte is codable), 64-bit-state rANS with
32-bit renormalization (emits at most one u32 per symbol -> fully
vectorizable across N interleaved lanes with numpy).

Wire format of ``encode``:
  [u8 lanes_log2][u32 n_symbols][256 x u16 freq table][u32 n_words]
  [n_words x u32 stream][lanes x u64 final states]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
RANS_L = np.uint64(1) << np.uint64(31)
MASK32 = np.uint64(0xFFFFFFFF)
DEFAULT_LANES = 256


# ---------------------------------------------------------------------------
# Frequency tables
# ---------------------------------------------------------------------------

def build_freq_table(data: np.ndarray) -> np.ndarray:
    """Normalized (sum=4096) add-1-smoothed byte frequency table."""
    counts = np.bincount(data.reshape(-1), minlength=256).astype(np.float64)
    counts += 1.0
    freq = np.floor(counts * (PROB_SCALE - 256) / counts.sum()).astype(
        np.int64) + 1
    # fix rounding so the table sums exactly to PROB_SCALE
    diff = PROB_SCALE - int(freq.sum())
    if diff != 0:
        # add/remove from the most frequent symbols (keeps all >= 1)
        order = np.argsort(-freq)
        i = 0
        step = 1 if diff > 0 else -1
        while diff != 0:
            s = order[i % 256]
            if freq[s] + step >= 1:
                freq[s] += step
                diff -= step
            i += 1
    return freq.astype(np.uint16)


def entropy_bits(data: np.ndarray) -> float:
    """Shannon bound in bits for `data` under its empirical distribution."""
    counts = np.bincount(data.reshape(-1), minlength=256).astype(np.float64)
    p = counts / max(counts.sum(), 1)
    nz = p > 0
    return float(-(counts[nz] * np.log2(p[nz])).sum())


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode(data: np.ndarray, lanes: int = DEFAULT_LANES) -> bytes:
    """Encode uint8 array -> bytes (losslessly decodable with `decode`)."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    freq = build_freq_table(data)
    cum = np.zeros(257, np.uint32)
    cum[1:] = np.cumsum(freq.astype(np.uint32))

    lanes = max(1, min(lanes, 1 << 15))
    rounds = -(-max(n, 1) // lanes)
    pad = rounds * lanes - n
    # pad with symbol 0 (freq >= 1 by smoothing); count stored in header
    padded = np.concatenate([data, np.zeros(pad, np.uint8)])
    grid = padded.reshape(rounds, lanes)

    f64 = freq.astype(np.uint64)
    c64 = cum.astype(np.uint64)
    x = np.full(lanes, RANS_L, np.uint64)
    chunks = []  # per-round emitted u32 words (lane order), reverse order
    shift32 = np.uint64(32)
    shiftp = np.uint64(PROB_BITS)

    for r in range(rounds - 1, -1, -1):
        syms = grid[r]
        f = f64[syms]
        c = c64[syms]
        x_max = ((RANS_L >> shiftp) << shift32) * f
        m = x >= x_max
        if m.any():
            chunks.append((x[m] & MASK32).astype(np.uint32))
            x = np.where(m, x >> shift32, x)
        x = ((x // f) << shiftp) + (x % f) + c

    words = (np.concatenate(chunks[::-1]) if chunks
             else np.zeros(0, np.uint32))
    head = np.zeros(1, np.uint8)
    head[0] = int(np.log2(lanes)) if lanes & (lanes - 1) == 0 else 255
    out = bytearray()
    out += head.tobytes()
    out += np.uint32(lanes).tobytes()
    out += np.uint32(n).tobytes()
    out += freq.tobytes()
    out += np.uint32(words.size).tobytes()
    out += words.tobytes()
    out += x.tobytes()
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

HEADER_BYTES = 1 + 4 + 4 + 512 + 4  # lanes_log2, lanes, n, freq, n_words


class Stream(NamedTuple):
    """One encoded stream's fields, as views of its bytes."""
    lanes: int
    n: int
    freq: np.ndarray    # [256] uint16, sums to PROB_SCALE
    words: np.ndarray   # [n_words] uint32, in the order the decoder reads
    states: np.ndarray  # [lanes] uint64, the encoder's final states


def parse_stream(blob) -> Stream:
    """Split an ``encode`` output into its fields; raises ValueError on a
    stream shorter than its header says."""
    buf = memoryview(blob).cast("B")
    if len(buf) < HEADER_BYTES:
        raise ValueError(f"rANS stream of {len(buf)} bytes is shorter than "
                         f"its {HEADER_BYTES}-byte header")
    lanes = int(np.frombuffer(buf[1:5], np.uint32)[0])
    n = int(np.frombuffer(buf[5:9], np.uint32)[0])
    freq = np.frombuffer(buf[9:9 + 512], np.uint16)
    n_words = int(np.frombuffer(buf[521:525], np.uint32)[0])
    end = HEADER_BYTES + 4 * n_words + 8 * lanes
    if len(buf) < end:
        raise ValueError(f"rANS stream truncated: {len(buf)} bytes, its "
                         f"header ({n_words} words, {lanes} lanes) needs "
                         f"{end}")
    words = np.frombuffer(buf[HEADER_BYTES:HEADER_BYTES + 4 * n_words],
                          np.uint32)
    states = np.frombuffer(buf[HEADER_BYTES + 4 * n_words:end], np.uint64)
    return Stream(lanes, n, freq, words, states)


class StreamDecoder:
    """Incremental rANS decoder: call ``read(n)`` repeatedly.

    Memory held: lane states + the (mmap-able) word stream; suitable for
    frame-wise decoding where only a frame's worth of symbols is
    materialized at a time.
    """

    def __init__(self, blob: bytes):
        stream = parse_stream(blob)
        self.lanes, self.n = stream.lanes, stream.n
        freq = stream.freq.astype(np.uint64)
        self.words = stream.words
        self.x = stream.states.copy()
        self.freq = freq
        self.cum = np.zeros(257, np.uint64)
        self.cum[1:] = np.cumsum(freq)
        self.sym_of = np.zeros(PROB_SCALE, np.uint8)
        for s in range(256):
            if freq[s]:
                self.sym_of[int(self.cum[s]):int(self.cum[s + 1])] = s
        self.wpos = 0
        self.spos = 0  # symbols emitted so far
        self._leftover = np.zeros(0, np.uint8)

    def read(self, count: int) -> np.ndarray:
        count = min(count, self.n - self.spos + self._leftover.size)
        chunks = [self._leftover]
        got = self._leftover.size
        maskp = np.uint64(PROB_SCALE - 1)
        shiftp = np.uint64(PROB_BITS)
        shift32 = np.uint64(32)
        x, words = self.x, self.words
        while got < count and self.spos < self.n:
            slot = x & maskp
            syms = self.sym_of[slot]
            f = self.freq[syms]
            c = self.cum[syms.astype(np.int64)]
            x = f * (x >> shiftp) + slot - c
            m = x < RANS_L
            k = int(m.sum())
            if k:
                refill = words[self.wpos:self.wpos + k].astype(np.uint64)
                self.wpos += k
                x[m] = (x[m] << shift32) | refill
            take = min(self.lanes, self.n - self.spos)
            chunks.append(syms[:take])
            self.spos += take
            got += take
        self.x = x
        flat = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        out, self._leftover = flat[:count], flat[count:]
        return out


def decode(blob: bytes, max_symbols: int = -1) -> np.ndarray:
    """Decode; `max_symbols` >= 0 stops early (streaming/frame-wise use)."""
    dec = StreamDecoder(blob)
    n = dec.n if max_symbols < 0 else min(dec.n, max_symbols)
    return dec.read(n)


# ---------------------------------------------------------------------------
# Size estimate (exact coded size without running the coder; used by the
# layout search where only relative sizes matter)
# ---------------------------------------------------------------------------

def coded_size_bound(data: np.ndarray) -> int:
    """Static-table cross-entropy size in bytes + header overhead."""
    return int(np.ceil(entropy_bits(data) / 8)) + 512 + 17 + 8 * 4
