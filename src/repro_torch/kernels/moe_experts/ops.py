"""Public dropless grouped expert op: the plain version for CPU tensors,
the CUDA kernels (``moe_experts.cu``) for CUDA tensors: a counting sort of
the choices by expert, one gate-up launch and one down launch over the
chosen experts' rows, then each token's k rows summed in choice order."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_experts.ref import max_tiles, moe_experts_ref

#: op calls that went through the kernels so far (three launches each); a
#: run resets it to 0 and reads it back to show which calls took the card
launches = 0

#: experts the sort kernel counts in shared memory (``moe_experts.cu``)
MAX_EXPERTS = 256

#: (variant, rows a tile): skinny tiles for few rows an expert, tiled
#: products of 32 and 64 rows for prefills
VARIANTS = ((0, 8), (1, 32), (2, 64))

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        _fn = build.load("moe_experts").moe_experts
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p]
        _fn.restype = ctypes.c_int
    return _fn


def plan(P: int, E: int) -> Tuple[int, int]:
    """(variant, rows a tile) for P choices over E experts: skinny below
    16 choices an expert on average, 32-row tiles below 64, else 64."""
    if P < 16 * E:
        return VARIANTS[0]
    return VARIANTS[1] if P < 64 * E else VARIANTS[2]


def scratch_ints(P: int, E: int, tiles: int) -> int:
    """int32 scratch of a launch: order, offsets, tile experts and rows,
    meta (tiles used, experts used)."""
    return P + E + 1 + 2 * tiles + 2


def _check(x, ids, wts, wi, wo) -> None:
    dev = x.device
    n, k = ids.shape
    E, d, two, ff = wi.shape
    for name, t in (("x", x), ("ids", ids), ("wts", wts), ("wi", wi),
                    ("wo", wo)):
        if t.device != dev:
            raise ValueError(f"moe_experts: {name} is on {t.device}, x on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"moe_experts: {name} must be contiguous")
    if x.dtype != torch.float32 or wts.dtype != torch.float32 \
            or wi.dtype != torch.float32 or wo.dtype != torch.float32 \
            or ids.dtype != torch.int64:
        raise TypeError("moe_experts: the kernel takes float32 x, wts, wi, "
                        "wo and int64 ids")
    if two != 2 or tuple(wo.shape) != (E, ff, d) or tuple(x.shape) != (n, d) \
            or tuple(wts.shape) != (n, k):
        raise ValueError(f"moe_experts: shapes x {tuple(x.shape)}, ids "
                         f"{tuple(ids.shape)}, wts {tuple(wts.shape)}, wi "
                         f"{tuple(wi.shape)}, wo {tuple(wo.shape)}")
    if d % 64 or ff % 64:
        raise ValueError(f"moe_experts: d {d} and ff {ff} must be multiples "
                         f"of 64")
    if E > MAX_EXPERTS or not 0 < k <= E:
        raise ValueError(f"moe_experts: {E} experts, top {k}; at most "
                         f"{MAX_EXPERTS} experts")


def moe_experts(x: torch.Tensor, ids: torch.Tensor, wts: torch.Tensor,
                wi: torch.Tensor, wo: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, d]; ids [n, k] int64 expert ids (each below E); wts [n, k]
    routing weights; wi [E, d, 2, ff] (gate, up); wo [E, ff, d] ->
    (out [n, d] = sum over each token's choices of weight x SwiGLU expert
    output, the number of distinct experts chosen as a one-element int
    tensor on x's device).

    On a CUDA device three launches on the current stream and no
    synchronisation: an expert no token chose reads none of its weights,
    and the count stays on the card until the caller reads it.  On the CPU
    the plain version."""
    build.refuse_grad("moe_experts", x, wi, wo)
    if x.device.type == "cpu":
        return moe_experts_ref(x, ids, wts, wi, wo)
    if x.device.type != "cuda":
        raise ValueError(f"moe_experts: no kernel for {x.device}")
    _check(x, ids, wts, wi, wo)
    n, k = ids.shape
    E, d, _, ff = wi.shape
    P = n * k
    variant, bm = plan(P, E)
    tiles = max_tiles(P, E, bm)
    scratch = torch.empty(scratch_ints(P, E, tiles), dtype=torch.int32,
                          device=x.device)
    h = torch.empty(P, ff, dtype=torch.float32, device=x.device)
    y = torch.empty(P, d, dtype=torch.float32, device=x.device)
    err = _launcher()(x.data_ptr(), ids.data_ptr(), wts.data_ptr(),
                      wi.data_ptr(), wo.data_ptr(), n, k, d, ff, E, variant,
                      tiles, scratch.data_ptr(), h.data_ptr(), y.data_ptr(),
                      torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "moe_experts")
    global launches
    launches += 1
    return y.view(n, k, d).sum(1), scratch[-1:]
