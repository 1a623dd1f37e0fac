"""Plain PyTorch version of the token-delta (inter-frame) transform: the
codec's TEMPORAL residual ``frame_f - frame_{f-1}`` (mod 256) through the
zigzag sign interleave, and its inverse, one frame and a stack of
frames, by lookup in the codec's own ``ZIGZAG``/``UNZIGZAG`` tables."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.prediction import UNZIGZAG, ZIGZAG

_LUTS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _luts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ZIGZAG, UNZIGZAG) as uint8 tensors on ``device``, made once."""
    luts = _LUTS.get(device)
    if luts is None:
        luts = (torch.from_numpy(ZIGZAG).to(device),
                torch.from_numpy(UNZIGZAG).to(device))
        _LUTS[device] = luts
    return luts


def token_delta_encode_ref(video: torch.Tensor) -> torch.Tensor:
    """video [F, H, W] uint8 -> zigzagged temporal residuals (frame 0
    raw, i.e. against a zero reference)."""
    prev = torch.cat([torch.zeros_like(video[:1]), video[:-1]], dim=0)
    res = video - prev  # uint8 wraps mod 256
    return _luts(video.device)[0][res.long()]


def token_delta_decode_frame_ref(prev_frame: torch.Tensor,
                                 zres: torch.Tensor) -> torch.Tensor:
    """prev [H, W] uint8 (zeros for frame 0), zres [H, W] uint8 -> the
    frame, ``prev + unzigzag(zres)`` mod 256, as a new tensor."""
    return prev_frame + _luts(zres.device)[1][zres.long()]


def token_delta_decode_frames_ref(prev_frame: torch.Tensor,
                                  zres: torch.Tensor) -> torch.Tensor:
    """prev [H, W] uint8, zres [F, H, W] uint8 -> [F, H, W]: frame f is
    ``prev`` plus the unzigzagged residuals of frames 0..f, mod 256; the
    one-frame inverse chained over the frames."""
    out = torch.empty_like(zres)
    for f in range(zres.shape[0]):
        prev_frame = token_delta_decode_frame_ref(prev_frame, zres[f])
        out[f] = prev_frame
    return out
