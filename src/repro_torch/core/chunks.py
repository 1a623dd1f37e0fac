"""Chunking and manifests: a model prefix's KV cache <-> a set of encoded
video chunks (paper §3.1: KV caches are chunked — 3 layers x token-chunk —
compressed offline in multiple resolutions, and registered as reusable).

Also covers the state-snapshot path for SSM / RG-LRU layers: recurrent
states have no token axis, so snapshots are coded with intra-frame
prediction + entropy only.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import entropy
from repro_torch.core.codec import CodecOptions, KVCodec
from repro_torch.core.layout import RESOLUTION_ORDER, IntraLayout
from repro_torch.core.prediction import ZIGZAG, UNZIGZAG
from repro_torch.core.quantization import quantize

DEFAULT_TOKENS_PER_CHUNK = 10_000  # paper §4: 10K tokens x 3 layers


def prefix_key(token_ids: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(token_ids).tobytes()
                          ).hexdigest()[:16]


@dataclasses.dataclass
class ChunkRef:
    kind: str  # "k" | "v"
    group: int  # 3-layer group index
    chunk: int  # token-chunk index
    token_start: int
    token_end: int
    layers: Tuple[int, ...]  # absolute layer ids in the group

    @property
    def chunk_id(self) -> str:
        return f"{self.kind}.g{self.group}.c{self.chunk}"


@dataclasses.dataclass
class KVManifest:
    """All encoded artifacts for one reusable prefix."""
    prefix: str
    n_tokens: int
    layer_groups: List[Tuple[int, ...]]
    refs: List[ChunkRef]
    scales: Dict[str, np.ndarray]  # kind -> [L, H] fp32
    blobs: Dict[Tuple[str, str], bytes]  # (chunk_id, resolution) -> bytes
    state_blob: Optional[bytes] = None  # SSM/RG-LRU snapshot
    layout: Optional[Tuple[int, int]] = None

    def sizes(self, resolution: str) -> Dict[str, int]:
        return {r.chunk_id: len(self.blobs[(r.chunk_id, resolution)])
                for r in self.refs}

    def total_bytes(self, resolution: str) -> int:
        n = sum(self.sizes(resolution).values())
        if self.state_blob:
            n += len(self.state_blob)
        return n

    @property
    def resolutions(self) -> Tuple[str, ...]:
        return tuple(sorted({res for (_, res) in self.blobs},
                            key=RESOLUTION_ORDER.index))


def layer_groups_of(n_attn_layers: int) -> List[Tuple[int, ...]]:
    return [tuple(range(i, min(i + 3, n_attn_layers)))
            for i in range(0, n_attn_layers, 3)]


def encode_prefix(kv_k: np.ndarray, kv_v: np.ndarray, *,
                  prefix: str,
                  layout: Optional[IntraLayout] = None,
                  resolutions: Sequence[str] = ("240p", "480p", "1080p"),
                  tokens_per_chunk: int = DEFAULT_TOKENS_PER_CHUNK,
                  options: CodecOptions = CodecOptions(),
                  search_sample: int = 512) -> KVManifest:
    """kv_k/kv_v [T, L, H, D] float -> manifest with multi-res encodings."""
    T, L, H, D = kv_k.shape
    groups = layer_groups_of(L)
    codec = KVCodec(H, D, layout, options)
    qs, scales = {}, {}
    for kind, kv in (("k", kv_k), ("v", kv_v)):
        qs[kind], scales[kind] = quantize(kv)
    if layout is None:
        sample = qs["k"][:min(search_sample, T), :min(3, L)]
        codec.search_layout(sample, resolutions[0])

    refs: List[ChunkRef] = []
    blobs: Dict[Tuple[str, str], bytes] = {}
    n_chunks = max(1, -(-T // tokens_per_chunk))
    for kind in ("k", "v"):
        for g, layers in enumerate(groups):
            for ci in range(n_chunks):
                t0 = ci * tokens_per_chunk
                t1 = min(T, t0 + tokens_per_chunk)
                ref = ChunkRef(kind, g, ci, t0, t1, layers)
                refs.append(ref)
                q = qs[kind][t0:t1][:, list(layers)]
                for res in resolutions:
                    blobs[(ref.chunk_id, res)] = codec.encode_chunk(q, res)
    return KVManifest(prefix=prefix, n_tokens=T, layer_groups=groups,
                      refs=refs, scales=scales, blobs=blobs,
                      layout=(codec.layout.hr, codec.layout.dr))


def decode_chunk_tokens(manifest: KVManifest, chunk_id: str,
                        resolution: str, H: int, D: int) -> np.ndarray:
    """Bulk-decode one chunk back to dequantized float KV [t, nl, H, D]."""
    lay = IntraLayout(H, D, *manifest.layout)
    codec = KVCodec(H, D, lay)
    ref = next(r for r in manifest.refs if r.chunk_id == chunk_id)
    q = codec.decode_chunk(manifest.blobs[(chunk_id, resolution)])
    sc = manifest.scales[ref.kind][list(ref.layers)]  # [nl, H]
    return (q.astype(np.float32) - 128) * sc[None, :, :, None]


# ---------------------------------------------------------------------------
# Recurrent-state snapshots (SSM / RG-LRU prefix reuse)
# ---------------------------------------------------------------------------

def encode_state_snapshot(states: Dict[str, np.ndarray],
                          lanes: int = 256) -> bytes:
    """Flatten, per-tensor absmax-quantize, left-predict, entropy-code."""
    import struct
    out = bytearray()
    out += struct.pack("<I", len(states))
    for name in sorted(states):
        x = np.asarray(states[name], np.float32)
        absmax = max(float(np.abs(x).max()), 1e-8)
        scale = absmax / 127.0
        q = (np.clip(np.rint(x / scale), -127, 127) + 128).astype(np.uint8)
        flat = q.reshape(-1)
        res = flat.copy()
        res[1:] = flat[1:] - flat[:-1]
        stream = entropy.encode(ZIGZAG[res], lanes)
        nb = name.encode()
        out += struct.pack("<H", len(nb)) + nb
        out += struct.pack("<f", scale)
        out += struct.pack("<B", x.ndim)
        out += struct.pack(f"<{x.ndim}I", *x.shape)
        out += struct.pack("<I", len(stream)) + stream
    return bytes(out)


def decode_state_snapshot(blob: bytes) -> Dict[str, np.ndarray]:
    import struct
    off = 0
    (n,) = struct.unpack_from("<I", blob, off)
    off += 4
    out = {}
    for _ in range(n):
        (ln,) = struct.unpack_from("<H", blob, off)
        off += 2
        name = blob[off:off + ln].decode()
        off += ln
        (scale,) = struct.unpack_from("<f", blob, off)
        off += 4
        (nd,) = struct.unpack_from("<B", blob, off)
        off += 1
        shape = struct.unpack_from(f"<{nd}I", blob, off)
        off += 4 * nd
        (sl,) = struct.unpack_from("<I", blob, off)
        off += 4
        z = entropy.decode(blob[off:off + sl])
        off += sl
        res = UNZIGZAG[z]
        flat = np.cumsum(res.astype(np.uint64)).astype(np.uint8)
        out[name] = (flat.reshape(shape).astype(np.float32) - 128) * scale
    return out
