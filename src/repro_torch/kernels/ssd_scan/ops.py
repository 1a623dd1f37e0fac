"""Public Mamba2 chunked SSD scan op: the plain version on CPU tensors, the
CUDA kernel (``ssd_scan.cu``) on CUDA tensors, and its gradient.

On the card one call is two launches (``ssd_scan.cu``): C.B^T of every
chunk and group into fp32 scratch, then the scan over b * nh * slices
blocks (``plan``); every product in 3xTF32 on the tensor cores.  When an
input requires grad (and grad mode is on), the call goes through a
``torch.autograd.Function`` whose backward is the backward kernel
(``ssd_scan_bwd_f32``, three more launches, every product in 3xTF32 too:
C.B^T of every piece and group, the sweeps over the pieces' states (a
block per head, direction and 64 x 64 tile of the state), then one block
per piece and head; then two PyTorch sums of dB and dC over a group's
heads) on the card and
``ssd_scan_bwd_ref`` on the CPU.  Otherwise nothing is saved and the
forward launches exactly as it does for serving.

The forward and the backward are the custom ops ``repro_torch::
ssd_scan_fwd`` and ``repro_torch::ssd_scan_bwd``: the kernel is their
``cuda`` implementation and the plain version their ``cpu`` one, a fake
implementation gives their outputs' shapes (so a trace under
``FakeTensorMode`` reaches no kernel), a FLOP formula counts them for
``torch.utils.flop_counter`` (``scan_flops``, ``scan_bwd_flops``), and a
sharding strategy lets DTensors call them: batch and heads shard, B and
C stay replicated (their G groups cannot follow a head split), and the
backward's dB and dC are partial sums over a head split."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import (piece_len, ssd_scan_bwd_ref,
                                              ssd_scan_ref)

#: op calls that went through the CUDA kernel so far; a run resets it to
#: 0 and reads it back to show which of its calls used it
launches = 0
#: backward calls that went through the backward kernel so far
bwd_launches = 0

#: the kernel's limits: head_dim, state and chunk length each at most this
MAX_DIM = 128
#: shared memory one block may use on an H100 (bytes)
MAX_SMEM = 232_448

_fn = None
_bwd_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("ssd_scan").ssd_scan_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("ssd_scan").ssd_scan_bwd_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def plan(Q: int, hd: int) -> Tuple[int, int]:
    """(piece, hd slices per head) of the kernel: ``piece_len(Q)`` steps
    run at once, and head_dim is split in two (two blocks per head) when
    it is a multiple of 16."""
    return piece_len(Q), (2 if hd % 16 == 0 else 1)


def smem_bytes(Q: int, hd: int, S: int) -> int:
    """Shared memory of one scan block (``ssd_scan.cu``), all fp32, with
    the piece Qk and the slice P = hd / slices each padded as the kernel
    pads them: B and C [Qk, S + 4], X [Qk, P + 8], C.B^T [Qk, Qk + 4],
    the state slice [P, S + 4] and four [Qk] vectors."""
    Qk, ks = plan(Q, hd)
    QP, SP, PP = -(-Qk // 16) * 16, -(-S // 8) * 8, -(-(hd // ks) // 16) * 16
    return 4 * (2 * QP * (SP + 4) + QP * (PP + 8) + QP * (QP + 4)
                + PP * (SP + 4) + 4 * QP)


def bwd_plan(Q: int, hd: int, S: int) -> Tuple[int, int, int]:
    """(piece, row slices, column slices) of the backward: pieces of
    ``piece_len(Q)`` steps; each sweep block holds a tile of at most 64 x
    64 of a head's [hd, S] state, so head_dim above 64 is cut into two
    row slices and a state above 64 into two column slices."""
    return piece_len(Q), (2 if hd > 64 else 1), (2 if S > 64 else 1)


def bwd_smem_bytes(Q: int, hd: int, S: int) -> int:
    """Shared memory of the backward's larger block (``ssd_scan.cu``), all
    fp32, with the piece P = ``piece_len(Q)`` padded to QP (a multiple of
    16) and rows padded as the kernel pads them.  A piece block holds X
    and dY [QP, hd32 + 4], B [QP, S32 + 4], M and W [QP, QP + 4], four
    [QP] vectors, sixteen [QP] rows of partial sums (E's rows and
    columns per tile, C.V and B.U per strip of S) and five scalars (hd32,
    S32: rounded up to 32).  A sweep block holds two stages of its
    columns of B or C [QP, CW + 8], its rows of X or dY [QP, RP + 8] and
    a [QP], and three [QP] vectors and a scalar (CW: the tile's columns
    rounded up to 8, RP: its rows rounded up to 16)."""
    def up(x, m):
        return -(-x // m) * m

    P, ks, cs = bwd_plan(Q, hd, S)
    QP = up(P, 16)
    hd32, S32 = up(hd, 32), up(S, 32)
    CW = up(-(-S // cs), 8)
    RP = up(-(-hd // ks), 16)
    piece = QP * (2 * (hd32 + 4) + S32 + 4 + 2 * (QP + 4) + 20) + 5
    sweep = 2 * QP * (CW + 8 + RP + 8 + 1) + 3 * QP + 1
    return 4 * max(piece, sweep)


def _check(xdt, a_log, Bm, Cm, Q: int, grad: bool = False) -> None:
    dev = xdt.device
    named = (("xdt", xdt), ("a_log", a_log), ("Bm", Bm), ("Cm", Cm))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, xdt on "
                             f"{dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: the kernel takes float32, {name} "
                            f"is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if xdt.dim() != 4 or a_log.shape != xdt.shape[:3] or Bm.dim() != 4 \
            or Bm.shape != Cm.shape or Bm.shape[:2] != xdt.shape[:2]:
        raise ValueError(
            f"ssd_scan: shapes xdt {tuple(xdt.shape)}, a_log "
            f"{tuple(a_log.shape)}, Bm {tuple(Bm.shape)}, Cm "
            f"{tuple(Cm.shape)} do not match [b, s, nh, hd], [b, s, nh], "
            f"[b, s, G, S] twice")
    b, s, nh, hd = xdt.shape
    G, S = Bm.shape[2], Bm.shape[3]
    if G == 0 or nh % G:
        raise ValueError(f"ssd_scan: G = {G} groups must divide nh = {nh}")
    if hd > MAX_DIM or S > MAX_DIM or not 1 <= Q <= MAX_DIM:
        raise ValueError(f"ssd_scan: the kernel takes head_dim, state and "
                         f"chunk up to {MAX_DIM}, got {hd}, {S}, {Q}")
    if smem_bytes(Q, hd, S) > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk {Q}, head_dim {hd}, state {S} "
                         f"need {smem_bytes(Q, hd, S)} bytes of shared "
                         f"memory, more than {MAX_SMEM}")
    if grad and bwd_smem_bytes(Q, hd, S) > MAX_SMEM:
        raise ValueError(f"ssd_scan: the backward of chunk {Q}, head_dim "
                         f"{hd}, state {S} needs {bwd_smem_bytes(Q, hd, S)} "
                         f"bytes of shared memory, more than {MAX_SMEM}")


def scan_flops(b: int, s: int, nh: int, hd: int, G: int, S: int,
               Q: int) -> int:
    """The products one forward needs (chunks of Q steps): C.B^T once per
    group (lower triangle with its diagonal), and per head M.X (lower
    triangle), the inter-chunk term and the state update."""
    c = -(-s // Q)
    tri = Q * (Q + 1) // 2
    return 2 * b * c * (G * tri * S + nh * (tri * hd + 2 * Q * S * hd))


def scan_bwd_flops(b: int, s: int, nh: int, hd: int, G: int, S: int,
                   Q: int) -> int:
    """The products the chunked gradient needs per piece of P steps
    (``ssd_scan.cu``): C.B^T once per group, and per head dY.X^T, M^T.dY,
    W.B and W^T.C over the lower triangle, and the five [P, hd] x [hd, S]
    products (the two sweeps, dY.h0, X.dH, B.dH^T)."""
    P = piece_len(min(Q, s))
    c = -(-s // P)
    tri = P * (P + 1) // 2
    return 2 * b * c * (G * tri * S + nh * (2 * tri * hd + 2 * tri * S
                                            + 5 * P * hd * S))


def ssd_scan(xdt: torch.Tensor, a_log: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 chunked SSD scan from a zero state.

    xdt [b, s, nh, hd] (x pre-multiplied by dt), a_log [b, s, nh] (dt*A),
    Bm/Cm [b, s, G, S] with G dividing nh.  Returns (y [b, s, nh, hd]
    fp32, final_state [b, nh, hd, S] fp32).  The chunk length is
    ``Q = min(chunk, s)``; on the card s is padded with zeros to a
    multiple of Q (a_log = 0, x = 0 leave the state intact) and y is
    sliced back, as ``repro/kernels/ssd_scan/ops.py`` does.  Both outputs
    are differentiable when an input requires grad.
    """
    args = (xdt, a_log, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Scan.apply(xdt, a_log, Bm, Cm, chunk)
    return _forward(xdt, a_log, Bm, Cm, chunk)


class _Scan(torch.autograd.Function):
    """The scan with its gradient: the forward saves its (unpadded)
    inputs; the backward is the ``ssd_scan_bwd`` op.  A final state that
    the loss does not use reaches the backward as zeros (materialised
    grads)."""

    @staticmethod
    def forward(ctx, xdt, a_log, Bm, Cm, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(xdt, a_log, Bm, Cm)
        if xdt.device.type == "cuda":
            _check(xdt, a_log, Bm, Cm, min(chunk, xdt.shape[1]), grad=True)
        return _forward(xdt, a_log, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = ssd_scan_bwd(*ctx.saved_tensors, dy, dstate,
                             chunk=ctx.chunk)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def _forward(xdt, a_log, Bm, Cm, chunk: int):
    if xdt.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan: no kernel for {xdt.device}")
    return tuple(torch.ops.repro_torch.ssd_scan_fwd(xdt, a_log, Bm, Cm,
                                                    chunk))


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=(),
                         device_types="cuda")
def _scan_fwd_op(xdt: torch.Tensor, a_log: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (two launches) on CUDA tensors."""
    b, s = xdt.shape[:2]
    Q = min(chunk, s)
    _check(xdt, a_log, Bm, Cm, Q)
    nh, hd = xdt.shape[2], xdt.shape[3]
    G, S = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(xdt)
    if b == 0 or s == 0 or nh == 0:
        return y, torch.zeros(b, nh, hd, S, dtype=torch.float32,
                              device=xdt.device)
    state = torch.empty(b, nh, hd, S, dtype=torch.float32, device=xdt.device)
    pad = (-s) % Q
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        y = torch.empty_like(xdt)
    piece, _ = plan(Q, hd)
    QP = -(-piece // 16) * 16
    # C.B^T of every piece of every group, written by the first kernel
    cb = torch.empty(b * -(-(s + pad) // piece) * G * QP * QP,
                     dtype=torch.float32, device=xdt.device)
    err = _launcher()(xdt.data_ptr(), a_log.data_ptr(), Bm.data_ptr(),
                      Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                      cb.data_ptr(), b, s + pad, nh, hd, G, S, Q,
                      xdt.device.index,
                      torch.cuda.current_stream(xdt.device).cuda_stream)
    build.check(err, "ssd_scan")
    global launches
    launches += 1
    return (y[:, :s] if pad else y), state


@_scan_fwd_op.register_kernel("cpu")
def _scan_fwd_cpu(xdt, a_log, Bm, Cm, chunk):
    return tuple(t.contiguous()
                 for t in ssd_scan_ref(xdt, a_log, Bm, Cm, chunk=chunk))


def _kernel_pad(xdt, step: int) -> int:
    """The steps the kernel pads s with (its outputs are slices of the
    padded length); the CPU version returns whole tensors."""
    b, s, nh = xdt.shape[:3]
    if xdt.device.type != "cuda" or b == 0 or nh == 0:
        return 0
    return (-s) % step


@_scan_fwd_op.register_fake
def _scan_fwd_fake(xdt, a_log, Bm, Cm, chunk):
    b, s, nh, hd = xdt.shape
    _check(xdt, a_log, Bm, Cm, min(chunk, s))
    pad = _kernel_pad(xdt, min(chunk, s))
    y = xdt.new_empty((b, s + pad, nh, hd), dtype=torch.float32)
    return (y[:, :s] if pad else y,
            xdt.new_empty((b, nh, hd, Bm.shape[3]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
def _scan_fwd_flop(xdt_shape, a_shape, B_shape, C_shape, chunk, *args,
                   **kwargs) -> int:
    b, s, nh, hd = xdt_shape
    return scan_flops(b, s, nh, hd, B_shape[2], B_shape[3], min(chunk, s))


def ssd_scan_bwd(xdt: torch.Tensor, a_log: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, dy: torch.Tensor, dstate: torch.Tensor, *,
                 chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor, torch.Tensor]:
    """The scan's backward: (dxdt, da_log, dBm, dCm) from dy [b, s, nh,
    hd] and dstate [b, nh, hd, S], shaped as the inputs.  The plain
    version on CPU tensors, the backward kernel on CUDA tensors (the
    inputs as ``ssd_scan`` checks them).  ``ssd_scan``'s gradient calls
    it; it is public for the card's checks and timing."""
    if xdt.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan: no kernel for {xdt.device}")
    return tuple(torch.ops.repro_torch.ssd_scan_bwd(
        xdt, a_log, Bm, Cm, dy.contiguous(), dstate.contiguous(), chunk))


def _check_bwd(xdt, a_log, Bm, Cm, dy, dstate, chunk: int) -> None:
    b, s, nh, hd = xdt.shape
    _check(xdt, a_log, Bm, Cm, min(chunk, s), grad=True)
    S = Bm.shape[3]
    for name, t, shape in (("dy", dy, xdt.shape),
                           ("dstate", dstate, (b, nh, hd, S))):
        if t.device != xdt.device or t.dtype != torch.float32 \
                or t.shape != shape:
            raise ValueError(f"ssd_scan backward: {name} {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, wants float32 "
                             f"{tuple(shape)} on {xdt.device}")


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _scan_bwd_op(xdt: torch.Tensor, a_log: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, dy: torch.Tensor, dstate: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """The backward kernel (three launches, then two sums) on CUDA
    tensors."""
    b, s, nh, hd = xdt.shape
    _check_bwd(xdt, a_log, Bm, Cm, dy, dstate, chunk)
    G, S = Bm.shape[2], Bm.shape[3]
    if b == 0 or s == 0 or nh == 0:
        return (torch.zeros_like(xdt), torch.zeros_like(a_log),
                torch.zeros_like(Bm), torch.zeros_like(Cm))
    P = piece_len(min(chunk, s))
    pad = (-s) % P  # zeros, as the forward pads: they change no gradient
    if pad:
        xdt, dy, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (xdt, dy, Bm, Cm))
        a_log = F.pad(a_log, (0, 0, 0, pad))
    sp = s + pad
    f32 = dict(dtype=torch.float32, device=xdt.device)
    QP = -(-P // 16) * 16
    # C.B^T of every piece and group; the state entering and the adjoint
    # leaving each piece
    cb = torch.empty(b * (sp // P) * G * QP * QP, **f32)
    h0 = torch.empty(b, sp // P, nh, hd, S, **f32)
    dh = torch.empty_like(h0)
    dx = torch.empty(b, sp, nh, hd, **f32)
    da = torch.empty(b, sp, nh, **f32)
    dBh = torch.empty(b, sp, nh, S, **f32)  # each head's partial
    dCh = torch.empty_like(dBh)
    err = _bwd_launcher()(
        xdt.data_ptr(), a_log.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dy.data_ptr(), dstate.data_ptr(), cb.data_ptr(), h0.data_ptr(),
        dh.data_ptr(), dx.data_ptr(), da.data_ptr(), dBh.data_ptr(),
        dCh.data_ptr(), b, sp, nh, hd, G, S, P, xdt.device.index,
        torch.cuda.current_stream(xdt.device).cuda_stream)
    build.check(err, "ssd_scan")
    global bwd_launches
    bwd_launches += 1
    hpg = nh // G
    return (dx[:, :s], da[:, :s],
            dBh[:, :s].reshape(b, s, G, hpg, S).sum(3),
            dCh[:, :s].reshape(b, s, G, hpg, S).sum(3))


@_scan_bwd_op.register_kernel("cpu")
def _scan_bwd_cpu(xdt, a_log, Bm, Cm, dy, dstate, chunk):
    return tuple(t.contiguous() for t in ssd_scan_bwd_ref(
        xdt, a_log, Bm, Cm, dy, dstate, chunk=chunk))


@_scan_bwd_op.register_fake
def _scan_bwd_fake(xdt, a_log, Bm, Cm, dy, dstate, chunk):
    _check_bwd(xdt, a_log, Bm, Cm, dy, dstate, chunk)
    b, s = xdt.shape[:2]
    pad = _kernel_pad(xdt, piece_len(min(chunk, s)))
    dx, da = (t.new_empty((b, s + pad) + tuple(t.shape[2:]),
                          dtype=torch.float32) for t in (xdt, a_log))
    return (dx[:, :s] if pad else dx, da[:, :s] if pad else da,
            Bm.new_empty(Bm.shape, dtype=torch.float32),
            Cm.new_empty(Cm.shape, dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _scan_bwd_flop(xdt_shape, a_shape, B_shape, C_shape, dy_shape,
                   dstate_shape, chunk, *args, **kwargs) -> int:
    b, s, nh, hd = xdt_shape
    return scan_bwd_flops(b, s, nh, hd, B_shape[2], B_shape[3], chunk)


# DTensor strategies, one mesh dim at a time: replicated; batch split;
# heads split (B and C replicated, their gradients partial sums)
@register_sharding(torch.ops.repro_torch.ssd_scan_fwd.default)
def _scan_fwd_sharding(xdt, a_log, Bm, Cm, chunk):
    R = Replicate()
    return [([R, R], [R, R, R, R, None]),
            ([Shard(0), Shard(0)], [Shard(0)] * 4 + [None]),
            ([Shard(2), Shard(1)], [Shard(2), Shard(2), R, R, None])]


@register_sharding(torch.ops.repro_torch.ssd_scan_bwd.default)
def _scan_bwd_sharding(xdt, a_log, Bm, Cm, dy, dstate, chunk):
    R = Replicate()
    return [([R] * 4, [R] * 6 + [None]),
            ([Shard(0)] * 4, [Shard(0)] * 6 + [None]),
            ([Shard(2), Shard(2), Partial(), Partial()],
             [Shard(2), Shard(2), R, R, Shard(2), Shard(1), None])]
