"""Streams shared by the rANS decode tests on the CPU
(``test_torch_rans_decode.py``) and on the card (``test_torch_cuda.py``):
symbol distributions, the (n, lanes) cases, and a yi-9b-shaped chunk."""
import numpy as np

from repro_torch.core.codec import KVCodec
from repro_torch.core.layout import IntraLayout

# a yi-9b-shaped chunk: 1,024 tokens x 3 layers x 4 kv heads x 128 at 240p
# packs into 9 frames of 228 x 256, 525,312 symbols a channel
CHUNK_SYMBOLS = 9 * 228 * 256
CHUNK_LAYOUT = (2, 1)
DISTS = ("uniform", "skewed", "single")


def symbols(dist: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "uniform":  # every byte alike: refills in most rounds
        return rng.integers(0, 256, n, dtype=np.uint8)
    if dist == "skewed":  # small zigzagged residuals, as the codec makes
        return np.minimum(rng.geometric(0.35, n) - 1, 255).astype(np.uint8)
    return np.full(n, 7, np.uint8)  # one symbol: few refills


def cases():
    """Each (n, lanes): the edges around one round for every lane count,
    and a channel of a chunk; the chunk's channel at one lane (525,312
    rounds, minutes of Python loop in each decoder) is left out."""
    out = []
    for lanes in (1, 32, 256, 1024):
        ns = {0, 1, lanes - 1, lanes, lanes + 1}
        if lanes > 1:
            ns.add(CHUNK_SYMBOLS)
        out += [(n, lanes) for n in sorted(ns)]
    return out


def chunk_blob(seed: int) -> bytes:
    """A yi-9b-shaped chunk encoded by the codec at 240p: per-head KV that
    drifts from token to token, with noise, quantised, so that the I and
    P streams both carry symbols."""
    rng = np.random.default_rng(seed)
    T, nl, H, D = 1024, 3, 4, 128
    base = rng.normal(128, 24, (1, nl, H, D))
    walk = np.cumsum(rng.normal(0, 1.5, (T, nl, H, 1)), axis=0)
    q = np.clip(base + walk + rng.normal(0, 3, (T, nl, H, D)), 0, 255)
    codec = KVCodec(H, D, IntraLayout(H, D, *CHUNK_LAYOUT))
    return codec.encode_chunk(q.astype(np.uint8), "240p")


def chunk_streams(blob: bytes):
    """The chunk's six rANS streams: I then P of each channel."""
    return KVCodec(4, 128).rans_streams(blob)
