"""Public Mamba2 chunked SSD scan op: the plain version on CPU tensors, the
CUDA kernel (``ssd_scan.cu``) on CUDA tensors.

On the card one call is two launches (``ssd_scan.cu``): C.B^T of every
chunk and group into fp32 scratch, then the scan over b * nh * slices
blocks (``plan``); every product in 3xTF32 on the tensor cores."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

#: op calls that went through the CUDA kernel so far; a run resets it to
#: 0 and reads it back to show which of its calls used it
launches = 0

#: the kernel's limits: head_dim, state and chunk length each at most this
MAX_DIM = 128
#: shared memory one block may use on an H100 (bytes)
MAX_SMEM = 232_448
#: the longest piece of a chunk the kernel runs at once
MAX_PIECE = 64

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("ssd_scan").ssd_scan_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def plan(Q: int, hd: int) -> Tuple[int, int]:
    """(piece, hd slices per head) of the kernel: a chunk longer than
    MAX_PIECE runs as two halves, and head_dim is split in two (two
    blocks per head) when it is a multiple of 16."""
    return (Q if Q <= MAX_PIECE else -(-Q // 2)), (2 if hd % 16 == 0 else 1)


def smem_bytes(Q: int, hd: int, S: int) -> int:
    """Shared memory of one scan block (``ssd_scan.cu``), all fp32, with
    the piece Qk and the slice P = hd / slices each padded as the kernel
    pads them: B and C [Qk, S + 4], X [Qk, P + 8], C.B^T [Qk, Qk + 4],
    the state slice [P, S + 4] and four [Qk] vectors."""
    Qk, ks = plan(Q, hd)
    QP, SP, PP = -(-Qk // 16) * 16, -(-S // 8) * 8, -(-(hd // ks) // 16) * 16
    return 4 * (2 * QP * (SP + 4) + QP * (PP + 8) + QP * (QP + 4)
                + PP * (SP + 4) + 4 * QP)


def _check(xdt, a_log, Bm, Cm, Q: int) -> None:
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


def ssd_scan(xdt: torch.Tensor, a_log: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 chunked SSD scan from a zero state.

    xdt [b, s, nh, hd] (x pre-multiplied by dt), a_log [b, s, nh] (dt*A),
    Bm/Cm [b, s, G, S] with G dividing nh.  Returns (y [b, s, nh, hd]
    fp32, final_state [b, nh, hd, S] fp32).  The chunk length is
    ``Q = min(chunk, s)``; on the card s is padded with zeros to a
    multiple of Q (a_log = 0, x = 0 leave the state intact) and y is
    sliced back, as ``repro/kernels/ssd_scan/ops.py`` does.
    """
    if xdt.device.type == "cpu":
        return ssd_scan_ref(xdt, a_log, Bm, Cm, chunk=chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {xdt.device}")
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
