"""CacheGen-style grouped integer quantization for KV tensors.

Per-(layer, head) symmetric int8 quantization stored as uint8 (offset 128).
This is the only lossy step in the pipeline (identical in spirit to
CacheGen/ShadowServe, as the paper states); everything downstream —
layout, prediction, entropy coding — is bit-exact.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

QOFF = 128


def quantize(kv: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """kv [T, L, H, D] float -> (q uint8 [T,L,H,D], scales fp32 [L,H])."""
    kv = np.asarray(kv, np.float32)
    absmax = np.abs(kv).max(axis=(0, 3))  # [L, H]
    scales = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.rint(kv / scales[None, :, :, None]), -127, 127)
    return (q + QOFF).astype(np.uint8), scales.astype(np.float32)


def dequantize(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of quantize (exact for the stored integers)."""
    return (q.astype(np.float32) - QOFF) * scales[None, :, :, None]


def quantize_torch(kv, scales: Optional[torch.Tensor] = None,
                   device: DeviceLike = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor variant on ``device`` (the card unless named), the
    counterpart of ``quantize_jnp``: kv [T, L, H, D] -> (q uint8, scales
    fp32 [L, H]); with ``scales`` given, those are used."""
    device = resolve_device(device)
    kv = torch.as_tensor(kv, device=device).to(torch.float32)
    if scales is None:
        absmax = kv.abs().amax(dim=(0, 3))
        scales = torch.clamp_min(absmax, 1e-8) / 127.0
    else:
        scales = torch.as_tensor(scales, device=device)
    q = torch.clamp(torch.round(kv / scales[None, :, :, None]), -127, 127)
    return (q + QOFF).to(torch.uint8), scales


def dequantize_torch(q, scales, device: DeviceLike = None) -> torch.Tensor:
    """Inverse of ``quantize_torch`` on ``device``, the counterpart of
    ``dequantize_jnp``."""
    device = resolve_device(device)
    q = torch.as_tensor(q, device=device)
    scales = torch.as_tensor(scales, device=device)
    return (q.to(torch.float32) - QOFF) * scales[None, :, :, None]
