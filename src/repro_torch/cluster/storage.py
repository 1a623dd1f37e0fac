"""Prefix storage: the flat in-process ``KVStore``.

The public API matches the JAX package's ``KVStore`` facade (register /
register_prefix / lookup / get_chunk / stored_bytes / manifests), backed
by a dict.  The multi-node ``StorageCluster`` and its ``StorageNode``s
arrive with a later slice of the port.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.chunks import KVManifest, encode_prefix, prefix_key


class KVStore:
    """Unbounded single-node store of encoded prefixes."""

    def __init__(self) -> None:
        self._manifests: Dict[str, KVManifest] = {}

    @property
    def manifests(self) -> Dict[str, KVManifest]:
        return dict(self._manifests)

    def register(self, manifest: KVManifest) -> None:
        self._manifests[manifest.prefix] = manifest

    def register_prefix(self, token_ids: np.ndarray, kv_k: np.ndarray,
                        kv_v: np.ndarray, **kw) -> KVManifest:
        key = prefix_key(np.asarray(token_ids))
        man = encode_prefix(kv_k, kv_v, prefix=key, **kw)
        self.register(man)
        return man

    def lookup(self, prefix: str) -> Optional[KVManifest]:
        return self._manifests.get(prefix)

    def get_chunk(self, prefix: str, chunk_id: str, resolution: str) -> bytes:
        return self._manifests[prefix].blobs[(chunk_id, resolution)]

    def stored_bytes(self) -> int:
        """Total encoded bytes, every resolution of every prefix."""
        return sum(len(b) for man in self._manifests.values()
                   for b in man.blobs.values())
