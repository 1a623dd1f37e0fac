"""Public fused KV restoration ops: the plain versions on CPU tensors, the
CUDA kernel (``kv_restore.cu``) on CUDA tensors.

``kv_restore`` is the JAX op's single-layer signature; ``kv_restore_layers``
restores every layer of a fetched chunk's layer group in one launch.  Both
go through the same kernel (``kv_restore`` is its case G = 1)."""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_restore.ref import (kv_restore_layers_ref,
                                                kv_restore_ref)

#: kernel launches so far; a run resets it to 0 and reads it back to show
#: which of its calls went through the kernel
launches = 0

#: layer ids one launch carries by value (``kv_restore.cu``)
MAX_LAYERS = 64

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_fns = {}


def _launcher(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(build.load("kv_restore"),
                     f"kv_restore_{_SUFFIX[dtype]}")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.POINTER(ctypes.c_int32), i, i, i,
                       i, ctypes.c_int64, i, p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(op: str, pages, q_tokens, scales, slots) -> None:
    """Devices, dtypes and contiguity of a kernel call's tensors."""
    dev = pages.device
    for name, t in (("q_tokens", q_tokens), ("scales", scales),
                    ("slots", slots)):
        if t.device != dev:
            raise ValueError(f"{op}: {name} is on {t.device}, pages on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    if not pages.is_contiguous():
        raise ValueError(f"{op}: pages must be contiguous")
    if pages.dtype not in _SUFFIX:
        raise TypeError(f"{op}: page dtype {pages.dtype} has no kernel "
                        f"(float32, bfloat16, float16)")
    if q_tokens.dtype != torch.uint8 or scales.dtype != torch.float32 \
            or slots.dtype != torch.int32:
        raise TypeError(f"{op}: wants uint8 q_tokens, float32 scales and "
                        f"int32 slots, got {q_tokens.dtype}, {scales.dtype}, "
                        f"{slots.dtype}")


def _layer_ids(layers, L: int) -> Tuple[int, ...]:
    """The group's absolute layer ids as host ints, each distinct and
    below L (two blocks writing one row would race)."""
    if isinstance(layers, torch.Tensor) and layers.device.type != "cpu":
        raise ValueError(f"kv_restore_layers: layers must be host ints, "
                         f"got a tensor on {layers.device}")
    ids = tuple(int(x) for x in layers)
    if any(not 0 <= x < L for x in ids) or len(set(ids)) != len(ids):
        raise ValueError(f"kv_restore_layers: layers {ids} must be distinct "
                         f"ids below L = {L}")
    if len(ids) > MAX_LAYERS:
        raise ValueError(f"kv_restore_layers: {len(ids)} layers in one "
                         f"launch, at most {MAX_LAYERS}")
    return ids


def _launch(pages, layers: Tuple[int, ...], q_tokens, scales, slots,
            R: int) -> None:
    """One launch over len(layers) x n token rows; pages viewed as
    [L, R, H, D]."""
    n, H, D = q_tokens.shape[-3:]
    if n == 0 or not layers:
        return
    ids = (ctypes.c_int32 * len(layers))(*layers)
    err = _launcher(pages.dtype)(
        pages.data_ptr(), q_tokens.data_ptr(), scales.data_ptr(),
        slots.data_ptr(), ids, len(layers), n, H, D, R, pages.device.index,
        torch.cuda.current_stream(pages.device).cuda_stream)
    build.check(err, "kv_restore")
    global launches
    launches += 1


def _device_kind(op: str, pages: torch.Tensor) -> str:
    kind = pages.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for {pages.device}")
    return kind


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
    if _device_kind("kv_restore", pages) == "cpu":
        return kv_restore_ref(pages, q_tokens, scales, slots)
    _check("kv_restore", pages, q_tokens, scales, slots)
    build.refuse_grad("kv_restore", pages, scales)
    if pages.dim() != 3 or q_tokens.dim() != 3 \
            or q_tokens.shape[1:] != pages.shape[1:] \
            or scales.shape != (pages.shape[1],) \
            or slots.shape != (q_tokens.shape[0],):
        raise ValueError(
            f"kv_restore: shapes pages {tuple(pages.shape)}, q_tokens "
            f"{tuple(q_tokens.shape)}, scales {tuple(scales.shape)}, slots "
            f"{tuple(slots.shape)} do not match [R, H, D], [n, H, D], [H], "
            f"[n]")
    _launch(pages, (0,), q_tokens, scales, slots, pages.shape[0])
    return pages


def kv_restore_layers(pages: torch.Tensor, layers: Sequence[int],
                      q_tokens: torch.Tensor, scales: torch.Tensor,
                      slots: torch.Tensor) -> torch.Tensor:
    """Restore one fetched chunk's tokens into every layer of its group in
    one launch, in place; returns ``pages``.

    pages    [L, R, H, D] float  (one kind's pages, R = P * page_size rows
                                  per layer)
    layers   G host ints         (the group's absolute layer ids, distinct,
                                  below L; a CPU int tensor or a sequence)
    q_tokens [G, n, H, D] uint8  (layer-major: the chunk's decoded tokens)
    scales   [G, H] float32      (the group's per-head dequant scales)
    slots    [n] int32           (rows < R shared by every layer; negative
                                  drops the token in every layer)
    """
    kind = _device_kind("kv_restore_layers", pages)
    if pages.dim() != 4:
        raise ValueError(f"kv_restore_layers: pages {tuple(pages.shape)} "
                         f"is not [L, R, H, D]")
    ids = _layer_ids(layers, pages.shape[0])
    if kind == "cpu":
        return kv_restore_layers_ref(pages, ids, q_tokens, scales, slots)
    _check("kv_restore_layers", pages, q_tokens, scales, slots)
    build.refuse_grad("kv_restore_layers", pages, scales)
    G = len(ids)
    if q_tokens.dim() != 4 or q_tokens.shape[0] != G \
            or q_tokens.shape[2:] != pages.shape[2:] \
            or scales.shape != (G, pages.shape[2]) \
            or slots.shape != (q_tokens.shape[1],):
        raise ValueError(
            f"kv_restore_layers: shapes pages {tuple(pages.shape)}, "
            f"{G} layers, q_tokens {tuple(q_tokens.shape)}, scales "
            f"{tuple(scales.shape)}, slots {tuple(slots.shape)} do not "
            f"match [L, R, H, D], [G, n, H, D], [G, H], [n]")
    _launch(pages, ids, q_tokens, scales, slots, pages.shape[1])
    return pages
