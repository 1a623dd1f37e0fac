"""Dense fp32 products of a prefill on the tensor cores in 3xTF32: the
plain version for CPU tensors, the CUDA kernel (``dense_3xtf32.cu``) for
CUDA tensors, and the routing function that the model's dense products
call.

``einsums(eq, x, ws)`` is ``torch.einsum(eq, x, w)`` for each weight, with
``eq`` a dense product that contracts x's trailing dims with each weight's
leading dims ("bsd,dhk->bshk", "bshk,hkd->bsd").  It launches the kernel
once for all the weights when every operand is a plain CUDA fp32 tensor,
none requires grad, no sharding mesh is active, x has at least
``MIN_ROWS`` rows and the launch has blocks for at least half the card's
SMs; everything else (CPU tensors, decode steps, short suffixes,
training, DTensors, deepseek-moe-16b's 64-column router) takes
``torch.einsum``.  Each weight is read as it lies: a contiguous [d, h, k]
is the [d, h k] of the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Iterator, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dense_3xtf32.ref import dense_ref
from repro_torch.sharding import rules

#: fewest rows a product sends to the kernel: from 160 rows on each of
#: yi-9b's products runs at least as fast as cuBLAS's fp32 product
#: (torch.einsum, TF32 off) on the H100, at 128 its output projection and
#: MLP wo take 1.4 times as long (the crossover: PERF.md, row H)
MIN_ROWS = 160

#: columns of a block's tile
TILE_COLS = 128

#: products the routing functions ran, and those that launched the kernel
#: (one launch each); a span reads both through ``counted``
products = 0
launches = 0

#: weights one launch takes, sharing x
MAX_WEIGHTS = 3

#: the device type whose tensors the routing sends to the kernel
DEVICE_TYPE = "cuda"

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        _fn = build.load("dense_3xtf32").dense_3xtf32
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn.argtypes = [p, i, i, i, p, p, p, i, i, i, p, p, p, i, p]
        _fn.restype = ctypes.c_int
    return _fn


_sm_count = build.sm_count


def _tiles(widths: Sequence[int]) -> int:
    return sum(-(-n // TILE_COLS) for n in widths)


def plan(M: int, tiles: int, sms: int) -> Tuple[int, int]:
    """(variant, blocks) of a launch of M rows and ``tiles`` column tiles
    on ``sms`` SMs: variant 0 (64-token tiles) where they take less time,
    a wave of them 2/3 of a wave of 128-token tiles (measured on the
    H100), else 1 (128-token tiles)."""
    blocks = {bt: -(-M // bt) * tiles for bt in (64, 128)}
    waves = {bt: -(-n // sms) for bt, n in blocks.items()}
    if 2 * waves[64] < 3 * waves[128]:
        return 0, blocks[64]
    return 1, blocks[128]


def _check(x: torch.Tensor, ws: Sequence[torch.Tensor]) -> None:
    if not 1 <= len(ws) <= MAX_WEIGHTS:
        raise ValueError(f"dense_3xtf32: {len(ws)} weights, 1 to "
                         f"{MAX_WEIGHTS} a launch")
    K = x.shape[1]
    for name, t in (("x", x), *((f"w{i}", w) for i, w in enumerate(ws))):
        if t.device != x.device:
            raise ValueError(f"dense_3xtf32: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"dense_3xtf32: {name} must be a float32 matrix")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"dense_3xtf32: {name} must be contiguous and "
                             f"16-byte aligned")
        if t.shape[1] % 4:
            raise ValueError(f"dense_3xtf32: {name}'s rows of {t.shape[1]} "
                             f"are not a multiple of 4")
    for i, w in enumerate(ws):
        if w.shape[0] != K:
            raise ValueError(f"dense_3xtf32: w{i} {tuple(w.shape)} against "
                             f"x {tuple(x.shape)}")


def dense_3xtf32(x: torch.Tensor, ws: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, ...]:
    """x [M, K]; ws 1 to 3 weights [K, N_i] -> (x @ w_i for each).

    On a CUDA device one launch on the current stream, no synchronisation:
    fp32 storage and accumulation, products in 3xTF32 on the tensor cores.
    K and each N_i multiples of 4.  On the CPU the plain version."""
    build.refuse_grad("dense_3xtf32", x, *ws)
    if x.device.type == "cpu":
        return dense_ref(x, ws)
    if x.device.type != "cuda":
        raise ValueError(f"dense_3xtf32: no kernel for {x.device}")
    _check(x, ws)
    M, K = x.shape
    outs = tuple(torch.empty(M, w.shape[1], dtype=torch.float32,
                             device=x.device) for w in ws)
    pad = MAX_WEIGHTS - len(ws)
    w_ptrs = [w.data_ptr() for w in ws] + [None] * pad
    n = [w.shape[1] for w in ws] + [0] * pad
    y_ptrs = [y.data_ptr() for y in outs] + [None] * pad
    variant, _ = plan(M, _tiles(n), _sm_count(x.device))
    err = _launcher()(x.data_ptr(), M, K, len(ws), *w_ptrs, *n, *y_ptrs,
                      variant, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dense_3xtf32")
    global launches
    launches += 1
    return outs


@functools.lru_cache(maxsize=None)
def contracted(eq: str) -> int:
    """How many trailing dims of x a dense product ``eq`` contracts with
    the weight's leading dims, in order ("bshk,hkd->bsd": 2); 0 if ``eq``
    is not such a product."""
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    c = len(set(a) & set(b))
    if (c == 0 or len(set(a)) != len(a) or len(set(b)) != len(b)
            or a[len(a) - c:] != b[:c] or out != a[:len(a) - c] + b[c:]):
        return 0
    return c


def _routed(eq: str, x: torch.Tensor, ws: Sequence[torch.Tensor]) -> int:
    """``contracted(eq)`` if the product goes to the kernel, else 0."""
    c = contracted(eq)
    if not c or x.dim() <= c:
        return 0
    K = math.prod(x.shape[x.dim() - c:])
    if x.numel() < MIN_ROWS * K or K % 4:  # decode steps leave here
        return 0
    if rules.active_mesh() is not None:
        return 0
    for t in (x, *ws):
        if (type(t) is not torch.Tensor or t.device != x.device
                or t.device.type != DEVICE_TYPE or t.dtype != torch.float32
                or t.requires_grad):
            return 0
    widths = [math.prod(w.shape[c:]) for w in ws]
    for w, n in zip(ws, widths):
        if (tuple(w.shape[:c]) != tuple(x.shape[x.dim() - c:])
                or not w.is_contiguous() or w.data_ptr() % 16 or n % 4):
            return 0
    sms = _sm_count(x.device)
    _, blocks = plan(x.numel() // K, _tiles(widths), sms)
    return c if 2 * blocks >= sms else 0


def einsums(eq: str, x: torch.Tensor, ws: Sequence[torch.Tensor]
            ) -> Tuple[torch.Tensor, ...]:
    """``torch.einsum(eq, x, w)`` for each of 1 to 3 weights, as one
    kernel launch where the module docstring's conditions hold."""
    global products
    products += 1
    c = _routed(eq, x, ws)
    if not c:
        return tuple(torch.einsum(eq, x, w) for w in ws)
    lead = x.shape[:x.dim() - c]
    x2 = x.reshape(-1, math.prod(x.shape[x.dim() - c:])).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    ys = dense_3xtf32(x2, [w.view(x2.shape[1], -1) for w in ws])
    return tuple(y.view(*lead, *w.shape[c:]) for y, w in zip(ys, ws))


def einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)``, routed as ``einsums``."""
    return einsums(eq, x, (w,))[0]


@contextlib.contextmanager
def counted(span) -> Iterator[None]:
    """Set ``span.counts``' ``products`` (the products routed inside the
    block) and ``tc_products`` (those that launched the kernel)."""
    p0, l0 = products, launches
    try:
        yield
    finally:
        span.counts["products"] = products - p0
        span.counts["tc_products"] = launches - l0
