"""Public token-delta ops (the codec's inter-frame transform): the plain
version on CPU tensors, the CUDA kernels (``token_delta.cu``) on CUDA
tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.token_delta.ref import (
    token_delta_decode_frame_ref, token_delta_decode_frames_ref,
    token_delta_encode_ref)

#: kernel launches so far, one counter per kernel (the decode kernel's
#: counts both decode ops); a run resets them to 0 and reads them back to
#: show which of its calls went through the kernels
encode_launches = 0
decode_launches = 0

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
#: each launcher's C signature; both end in (device, stream)
_ARGTYPES = {
    # video, out, n, hw
    "token_delta_encode": [_P, _P, _I64, _I64],
    # prev, zres, out, F, n (= H * W)
    "token_delta_decode_frames": [_P, _P, _P, _I64, _I64],
}
_fns = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("token_delta"), name)
        fn.argtypes = _ARGTYPES[name] + [ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(op: str, named) -> None:
    """Same device, uint8, contiguous; the shapes are the op's to check."""
    dev = named[0][1].device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{op}: {name} is on {t.device}, "
                             f"{named[0][0]} on {dev}")
        if t.dtype != torch.uint8:
            raise TypeError(f"{op}: {name} must be uint8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def token_delta_encode(video: torch.Tensor) -> torch.Tensor:
    """video [F, H, W] uint8 -> ``zigzag((frame_f - frame_{f-1}) mod 256)``
    [F, H, W] uint8, with frame -1 taken as 0."""
    if video.device.type == "cpu":
        return token_delta_encode_ref(video)
    if video.device.type != "cuda":
        raise ValueError(f"token_delta_encode: no kernel for {video.device}")
    build.refuse_grad("token_delta_encode", video)
    _check("token_delta_encode", (("video", video),))
    if video.dim() != 3:
        raise ValueError(f"token_delta_encode: video {tuple(video.shape)} "
                         f"is not [F, H, W]")
    out = torch.empty_like(video)
    F, H, W = video.shape
    if out.numel() == 0:
        return out
    err = _launcher("token_delta_encode")(
        video.data_ptr(), out.data_ptr(), F * H * W, H * W,
        video.device.index, _stream(video))
    build.check(err, "token_delta")
    global encode_launches
    encode_launches += 1
    return out


def token_delta_decode_frames(prev_frame: torch.Tensor,
                              zres: torch.Tensor) -> torch.Tensor:
    """prev [H, W] uint8, zres [F, H, W] uint8 -> [F, H, W] uint8: frame f
    is ``prev`` plus the unzigzagged residuals of frames 0..f, mod 256, in
    one launch.  Pass zeros as ``prev`` to decode a stack from its first
    frame, and the last frame of the previous result to go on with the
    next stack."""
    if zres.device.type == "cpu":
        return token_delta_decode_frames_ref(prev_frame, zres)
    if zres.device.type != "cuda":
        raise ValueError(f"token_delta_decode_frames: no kernel for "
                         f"{zres.device}")
    build.refuse_grad("token_delta_decode_frames", prev_frame, zres)
    _check("token_delta_decode_frames",
           (("zres", zres), ("prev_frame", prev_frame)))
    if zres.dim() != 3 or prev_frame.shape != zres.shape[1:]:
        raise ValueError(f"token_delta_decode_frames: shapes "
                         f"{tuple(prev_frame.shape)}, {tuple(zres.shape)} "
                         f"are not [H, W], [F, H, W]")
    out = torch.empty_like(zres)
    if out.numel() == 0:
        return out
    F, H, W = zres.shape
    err = _launcher("token_delta_decode_frames")(
        prev_frame.data_ptr(), zres.data_ptr(), out.data_ptr(), F, H * W,
        zres.device.index, _stream(zres))
    build.check(err, "token_delta")
    global decode_launches
    decode_launches += 1
    return out


def token_delta_decode_frame(prev_frame: torch.Tensor,
                             zres: torch.Tensor) -> torch.Tensor:
    """prev [H, W] uint8 (zeros for frame 0), zres [H, W] uint8 -> the
    frame ``prev + unzigzag(zres)`` mod 256, as a new tensor: the stack
    decode's kernel at F = 1."""
    if zres.device.type == "cpu":
        return token_delta_decode_frame_ref(prev_frame, zres)
    if zres.dim() != 2:
        raise ValueError(f"token_delta_decode_frame: zres "
                         f"{tuple(zres.shape)} is not [H, W]")
    return token_delta_decode_frames(prev_frame, zres[None])[0]
