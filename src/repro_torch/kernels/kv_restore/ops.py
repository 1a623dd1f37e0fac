"""Public fused KV restoration op: the plain version on CPU tensors, the
CUDA kernel (``kv_restore.cu``) on CUDA tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_restore.ref import kv_restore_ref

#: kernel launches so far; a run resets it to 0 and reads it back to show
#: which of its calls went through the kernel
launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_fns = {}


def _launcher(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(build.load("kv_restore"),
                     f"kv_restore_{_SUFFIX[dtype]}")
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(pages, q_tokens, scales, slots) -> None:
    dev = pages.device
    for name, t in (("q_tokens", q_tokens), ("scales", scales),
                    ("slots", slots)):
        if t.device != dev:
            raise ValueError(f"kv_restore: {name} is on {t.device}, "
                             f"pages on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"kv_restore: {name} must be contiguous")
    if pages.dtype not in _SUFFIX:
        raise TypeError(f"kv_restore: page dtype {pages.dtype} has no "
                        f"kernel (float32, bfloat16, float16)")
    if q_tokens.dtype != torch.uint8 or scales.dtype != torch.float32 \
            or slots.dtype != torch.int32:
        raise TypeError("kv_restore: wants uint8 q_tokens, float32 scales "
                        f"and int32 slots, got {q_tokens.dtype}, "
                        f"{scales.dtype}, {slots.dtype}")
    if pages.dim() != 3 or q_tokens.dim() != 3 \
            or q_tokens.shape[1:] != pages.shape[1:] \
            or scales.shape != (pages.shape[1],) \
            or slots.shape != (q_tokens.shape[0],):
        raise ValueError(
            f"kv_restore: shapes pages {tuple(pages.shape)}, q_tokens "
            f"{tuple(q_tokens.shape)}, scales {tuple(scales.shape)}, slots "
            f"{tuple(slots.shape)} do not match [R, H, D], [n, H, D], [H], "
            f"[n]")
    if not pages.is_contiguous():
        raise ValueError("kv_restore: pages must be contiguous")


def kv_restore(pages: torch.Tensor, q_tokens: torch.Tensor,
               scales: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Dequantize one decoded frame's uint8 KV tokens and scatter them into
    paged rows, in place; returns ``pages``.

    pages    [R, H, D] float   (paged KV memory rows of one layer)
    q_tokens [n, H, D] uint8   (one decoded frame's tokens, one layer/kind)
    scales   [H] float32       (per-head dequant scales)
    slots    [n] int32         (destination rows < R; negative drops the
                                token and leaves its row untouched)
    """
    if pages.device.type == "cpu":
        return kv_restore_ref(pages, q_tokens, scales, slots)
    if pages.device.type != "cuda":
        raise ValueError(f"kv_restore: no kernel for {pages.device}")
    _check(pages, q_tokens, scales, slots)
    n, H, D = q_tokens.shape
    if n == 0:
        return pages
    fn = _launcher(pages.dtype)
    err = fn(pages.data_ptr(), q_tokens.data_ptr(), scales.data_ptr(),
             slots.data_ptr(), n, H, D, pages.shape[0], pages.device.index,
             torch.cuda.current_stream(pages.device).cuda_stream)
    build.check(err, "kv_restore")
    global launches
    launches += 1
    return pages
