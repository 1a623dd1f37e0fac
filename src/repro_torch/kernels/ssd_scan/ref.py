"""Plain PyTorch version of the Mamba2 chunked SSD scan, in the arithmetic
of ``repro/models/ssm.py::ssd_chunked`` (the oracle of the TPU kernel).

The arithmetic lives here once: ``repro_torch.models.ssm`` imports
``ssd_chunked`` from this module, never the other way round.  The 3xTF32
helpers emulate the CUDA kernel's tensor-core arithmetic for the tests;
no path calls them.  ``ssd_scan_bwd_ref`` is the plain version of the
backward kernel (``ssd_scan.cu``, ``ssd_scan_bwd_f32``), in its
arithmetic.  fp32 and bf16 inputs are computed in fp32, as the JAX oracle
computes them; fp64 inputs stay fp64 (for ``torch.autograd.gradcheck``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _segsum(a_log: torch.Tensor) -> torch.Tensor:
    """a_log [..., q] -> [..., q, q] lower-tri cumulative log-decay."""
    q = a_log.shape[-1]
    cs = torch.cumsum(a_log, dim=-1)
    # decay from j+1..i inclusive = cs[i] - cs[j]; strictly lower + diag 0
    dif = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                 device=a_log.device))
    return torch.where(mask, dif, torch.full_like(dif, -torch.inf))


def ssd_chunked(xh: torch.Tensor, a_log: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, init_state: Optional[torch.Tensor] = None,
                chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    xh     [b, s, nh, hd]   (already multiplied by dt)
    a_log  [b, s, nh]       log decay per step (dt * A, negative)
    Bm, Cm [b, s, G, S]     (G broadcast over heads)
    returns y [b, s, nh, hd] fp32, final_state [b, nh, hd, S] fp32
    """
    b, s, nh, hd = xh.shape
    G, S = Bm.shape[2], Bm.shape[3]
    assert nh % G == 0
    q = min(chunk, s)
    hpg = nh // G
    orig_s = s
    if s % q:  # pad to a chunk multiple; a_log=0, x=0 leaves state intact
        pad = q - s % q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        s = s + pad
    c = s // q

    cdtype = xh.dtype
    wt = torch.promote_types(cdtype, torch.float32)
    xc = xh.reshape(b, c, q, nh, hd)
    ac = a_log.reshape(b, c, q, nh).to(wt)
    Bc = Bm.reshape(b, c, q, G, S).to(cdtype)
    Cc = Cm.reshape(b, c, q, G, S).to(cdtype)

    acs = torch.cumsum(ac, dim=2)  # [b,c,q,nh]
    # intra-chunk (diagonal) term
    L = torch.exp(_segsum(ac.permute(0, 1, 3, 2))).to(cdtype)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)  # [b,c,G,q,q]
    scores = torch.repeat_interleave(scores, hpg, dim=2)  # [b,c,nh,q,q]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", L * scores,
                          xc).to(wt)

    # per-chunk end states: input at t decays by exp(sum_{t+1..end} a)
    decay_to_end = torch.exp(acs[:, :, -1:, :] - acs).to(cdtype)
    Bh = torch.repeat_interleave(Bc, hpg, dim=3)  # [b,c,q,nh,S]
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bh, decay_to_end,
                          xc).to(wt)
    y, final = _ssd_inter(y_diag, states, acs, Cc, xc, init_state, hpg)
    return y[:, :orig_s], final


def _ssd_inter(y_diag, states, acs, Cc, xc, init_state, hpg):
    b, c, q, nh = acs.shape
    hd = xc.shape[-1]
    S = Cc.shape[-1]
    wt = acs.dtype
    chunk_decay = torch.exp(acs[:, :, -1, :])  # [b,c,nh]

    if init_state is None:
        init_state = torch.zeros(b, nh, hd, S, dtype=wt,
                                 device=acs.device)
    # scan over chunks: h_prevs[:, i] is the state entering chunk i
    h = init_state
    h_prevs = []
    for i in range(c):
        h_prevs.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    final = h
    h_prevs = torch.stack(h_prevs, dim=1)  # [b,c,nh,hd,S]

    # inter-chunk contribution: y_off[t] = C_t . (decay(0..t) * h_chunk_start)
    in_decay = torch.exp(acs)  # decay from chunk start to t inclusive
    Ch = torch.repeat_interleave(Cc, hpg, dim=3) if Cc.shape[3] != nh \
        else Cc
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch,
                         h_prevs.to(Ch.dtype),
                         in_decay.to(Ch.dtype)).to(wt)
    y = (y_diag.to(wt) + y_off).reshape(b, c * q, nh, hd)
    return y, final


def ssd_scan_ref(xdt: torch.Tensor, a_log: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt [b,s,nh,hd] (dt-folded); a_log [b,s,nh]; Bm/Cm [b,s,G,S].
    Returns (y [b,s,nh,hd] fp32, final_state [b,nh,hd,S] fp32)."""
    return ssd_chunked(xdt, a_log, Bm, Cm, chunk=chunk)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 values cut to TF32 (the sign, the exponent and the top 10
    mantissa bits), as the kernel's ``split_tf32`` masks them."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's tensor cores form it: each operand split into
    its TF32 truncation and the remainder's TF32 truncation,
    a_lo b_hi + a_hi b_lo + a_hi b_hi with exact products summed in fp32
    (a_lo b_lo dropped)."""
    ah = tf32_truncate(a)
    al = tf32_truncate(a - ah)
    bh = tf32_truncate(b)
    bl = tf32_truncate(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def ssd_scan_3xtf32_ref(xdt: torch.Tensor, a_log: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor,
                        chunk: int = 128
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's arithmetic on the CPU, for the tests: chunks run
    in pieces of at most 64 steps, and every product goes through
    ``mm_3xtf32``.  Same arguments and results as ``ssd_scan_ref``."""
    b, s, nh, hd = xdt.shape
    G, S = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, s)
    Qk = piece_len(Q)
    pad = -(-s // Qk) * Qk - s  # a = 0, x = 0 leave the state intact
    hpg = nh // G
    x = F.pad(xdt, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    a = F.pad(a_log, (0, 0, 0, pad)).permute(0, 2, 1).to(torch.float32)
    Bh = F.pad(Bm, (0, 0, 0, 0, 0, pad)).repeat_interleave(
        hpg, dim=2).permute(0, 2, 1, 3)
    Ch = F.pad(Cm, (0, 0, 0, 0, 0, pad)).repeat_interleave(
        hpg, dim=2).permute(0, 2, 1, 3)
    lower = torch.tril(torch.ones(Qk, Qk, dtype=torch.bool))
    st = torch.zeros(b, nh, hd, S, dtype=torch.float32)
    ys = []
    for c0 in range(0, s + pad, Qk):
        X, A = x[:, :, c0:c0 + Qk], a[:, :, c0:c0 + Qk]
        Bc, Cc = Bh[:, :, c0:c0 + Qk], Ch[:, :, c0:c0 + Qk]
        acs = torch.cumsum(A, dim=-1)
        dif = acs[..., :, None] - acs[..., None, :]
        M = torch.exp(torch.where(lower, dif, -torch.inf)) \
            * mm_3xtf32(Cc, Bc.transpose(-1, -2))
        y = torch.exp(acs)[..., None] * mm_3xtf32(Cc, st.transpose(-1, -2)) \
            + mm_3xtf32(M, X)
        dte = torch.exp(acs[..., -1:] - acs)
        st = torch.exp(acs[..., -1])[..., None, None] * st \
            + mm_3xtf32(X.transpose(-1, -2), dte[..., None] * Bc)
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :s].permute(0, 2, 1, 3).contiguous()
    return y, st


#: the longest piece of a chunk the CUDA kernels run at once
MAX_PIECE = 64


def piece_len(Q: int) -> int:
    """The run of steps the CUDA kernels take at once: a chunk of Q <=
    MAX_PIECE steps whole, a longer one as two pieces.  The recurrence is
    exact under any chunking, so only rounding depends on it."""
    return Q if Q <= MAX_PIECE else -(-Q // 2)


def ssd_scan_bwd_ref(xdt: torch.Tensor, a_log: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                     dstate: torch.Tensor, chunk: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """The gradient of ``ssd_scan_ref`` (y and the final state) in the
    arithmetic of the backward kernel (``ssd_scan.cu``): dy [b, s, nh, hd]
    and dstate [b, nh, hd, S] in; (dxdt, da_log, dBm, dCm) out, shaped as
    xdt, a_log, Bm and Cm.

    s is cut into pieces of P = ``piece_len(min(chunk, s))`` steps (zeros
    pad the last one: a = 0, x = 0, dy = 0 change nothing).  With acs the
    cumulative sum of a over a piece, e = exp(acs), dte = exp(acs_last -
    acs) and eT = exp(acs_last):

    1. a sweep forward gives the state h0 entering each piece, a sweep
       back the adjoint dH of the state leaving it (dstate after the last
       piece): h' = eT h + X^T (dte B), dH_prev = eT dH + dY^T (e C);
    2. per piece and head, with L[i, j] = exp(acs_i - acs_j) for j <= i,
       M = L * (C B^T), W = L * (dY X^T) and E = M * (dY X^T):
       dX = M^T dY + dte (B dH^T), dC = W B + e (dY h0),
       dB = W^T C + dte (X dH), and d acs = rowsum E - colsum E
       + e (C . dY h0) - dte (B . X dH), plus eT <dH, h0> + sum_j dte_j
       (B_j . (X dH)_j) at the last step; da is d acs summed from the end;
    3. dB and dC are summed over the heads of each group.
    """
    b, s, nh, hd = xdt.shape
    G, S = Bm.shape[2], Bm.shape[3]
    hpg = nh // G
    P = piece_len(min(chunk, s))
    pad = (-s) % P
    c = (s + pad) // P
    wt = torch.promote_types(xdt.dtype, torch.float32)

    def pieces(t, width):  # [b, s, heads, width] -> [b, nh, c, P, width]
        t = F.pad(t.to(wt), (0, 0, 0, 0, 0, pad))
        t = t.reshape(b, c, P, t.shape[2], width).permute(0, 3, 1, 2, 4)
        return t.repeat_interleave(nh // t.shape[1], dim=1)

    X, dY = pieces(xdt, hd), pieces(dy, hd)
    Bc, Cc = pieces(Bm, S), pieces(Cm, S)
    a = F.pad(a_log.to(wt), (0, 0, 0, pad)).reshape(b, c, P, nh)
    acs = torch.cumsum(a.permute(0, 3, 1, 2), dim=-1)  # [b, nh, c, P]
    e = torch.exp(acs)
    dte = torch.exp(acs[..., -1:] - acs)
    eT = torch.exp(acs[..., -1])  # [b, nh, c]

    # 1. the states entering and the adjoints leaving each piece
    fwd = torch.einsum("bhcqp,bhcqn->bhcpn", dte[..., None] * X, Bc)
    rev = torch.einsum("bhcqp,bhcqn->bhcpn", e[..., None] * dY, Cc)
    h = torch.zeros(b, nh, hd, S, dtype=wt, device=xdt.device)
    lam = dstate.to(wt)
    h0, dH = [], [None] * c
    for i in range(c):
        h0.append(h)
        h = eT[:, :, i, None, None] * h + fwd[:, :, i]
    for i in reversed(range(c)):
        dH[i] = lam
        lam = eT[:, :, i, None, None] * lam + rev[:, :, i]
    h0, dH = torch.stack(h0, dim=2), torch.stack(dH, dim=2)

    # 2. each piece on its own
    lower = torch.tril(torch.ones(P, P, dtype=torch.bool,
                                  device=xdt.device))
    L = torch.exp(torch.where(lower, acs[..., :, None] - acs[..., None, :],
                              -torch.inf))
    D = torch.einsum("bhcip,bhcjp->bhcij", dY, X)
    M = L * torch.einsum("bhcin,bhcjn->bhcij", Cc, Bc)
    W = L * D
    E = M * D
    V = torch.einsum("bhcip,bhcpn->bhcin", dY, h0)
    U = torch.einsum("bhcjp,bhcpn->bhcjn", X, dH)
    dX = torch.einsum("bhcij,bhcip->bhcjp", M, dY) \
        + dte[..., None] * torch.einsum("bhcjn,bhcpn->bhcjp", Bc, dH)
    dC = torch.einsum("bhcij,bhcjn->bhcin", W, Bc) + e[..., None] * V
    dB = torch.einsum("bhcij,bhcin->bhcjn", W, Cc) + dte[..., None] * U
    Fk = e * (Cc * V).sum(-1)
    Gk = dte * (Bc * U).sum(-1)
    dacs = E.sum(-1) - E.sum(-2) + Fk - Gk
    last = eT * (dH * h0).sum((-2, -1)) + Gk.sum(-1)
    dacs = torch.cat([dacs[..., :-1], dacs[..., -1:] + last[..., None]], -1)
    da = torch.flip(torch.cumsum(torch.flip(dacs, [-1]), -1), [-1])

    # 3. back to the inputs' layouts; dB, dC summed over a group's heads
    def back(t):  # [b, nh, c, P, w] -> [b, s, nh, w]
        return t.permute(0, 2, 3, 1, 4).reshape(b, c * P, nh, -1)[:, :s]

    def group_sum(t):
        t = back(t)
        return t.reshape(b, s, G, hpg, S).sum(3)

    dxdt = back(dX).to(xdt.dtype)
    da_log = da.permute(0, 2, 3, 1).reshape(b, c * P, nh)[:, :s]
    return (dxdt, da_log.to(a_log.dtype), group_sum(dB).to(Bm.dtype),
            group_sum(dC).to(Cm.dtype))


def ssd_scan_bwd_3xtf32_ref(xdt: torch.Tensor, a_log: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor,
                            dy: torch.Tensor, dstate: torch.Tensor,
                            chunk: int = 128
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic on the CPU, for the tests: the
    pieces, sweeps and terms of ``ssd_scan_bwd_ref`` with every product
    through ``mm_3xtf32`` (C.B^T once per group; the sweeps, dY X^T, M^T dY,
    B dH^T, W B, W^T C, dY h0 and X dH per head), and the row sums, decays
    and the cumulative sums of d acs in fp32 as the kernel takes them.
    Same arguments and results as ``ssd_scan_bwd_ref``."""
    b, s, nh, hd = xdt.shape
    G, S = Bm.shape[2], Bm.shape[3]
    hpg = nh // G
    P = piece_len(min(chunk, s))
    pad = (-s) % P
    c = (s + pad) // P
    mm = mm_3xtf32

    def pieces(t, width):  # [b, s, heads, width] -> [b, heads, c, P, width]
        t = F.pad(t.to(torch.float32), (0, 0, 0, 0, 0, pad))
        return t.reshape(b, c, P, t.shape[2], width).permute(0, 3, 1, 2, 4)

    X, dY = pieces(xdt, hd), pieces(dy, hd)
    Bg, Cg = pieces(Bm, S), pieces(Cm, S)
    CB = mm(Cg, Bg.transpose(-1, -2)).repeat_interleave(hpg, dim=1)
    Bc, Cc = Bg.repeat_interleave(hpg, dim=1), Cg.repeat_interleave(hpg, dim=1)
    a = F.pad(a_log.to(torch.float32), (0, 0, 0, pad)).reshape(b, c, P, nh)
    acs = torch.cumsum(a.permute(0, 3, 1, 2), dim=-1)  # [b, nh, c, P]
    e = torch.exp(acs)
    dte = torch.exp(acs[..., -1:] - acs)
    eT = torch.exp(acs[..., -1])

    fwd = mm(X.transpose(-1, -2), dte[..., None] * Bc)  # [b, nh, c, hd, S]
    rev = mm(dY.transpose(-1, -2), e[..., None] * Cc)
    h = torch.zeros(b, nh, hd, S, dtype=torch.float32, device=xdt.device)
    lam = dstate.to(torch.float32)
    h0, dH = [], [None] * c
    for i in range(c):
        h0.append(h)
        h = eT[:, :, i, None, None] * h + fwd[:, :, i]
    for i in reversed(range(c)):
        dH[i] = lam
        lam = eT[:, :, i, None, None] * lam + rev[:, :, i]
    h0, dH = torch.stack(h0, dim=2), torch.stack(dH, dim=2)

    lower = torch.tril(torch.ones(P, P, dtype=torch.bool,
                                  device=xdt.device))
    L = torch.exp(torch.where(lower, acs[..., :, None] - acs[..., None, :],
                              -torch.inf))
    D = mm(dY, X.transpose(-1, -2))
    M = L * CB
    W = L * D
    E = M * D
    V = mm(dY, h0)
    U = mm(X, dH)
    dX = mm(M.transpose(-1, -2), dY) \
        + dte[..., None] * mm(Bc, dH.transpose(-1, -2))
    dC = mm(W, Bc) + e[..., None] * V
    dB = mm(W.transpose(-1, -2), Cc) + dte[..., None] * U
    Gk = dte * (Bc * U).sum(-1)
    dacs = E.sum(-1) - E.sum(-2) + e * (Cc * V).sum(-1) - Gk
    last = eT * (dH * h0).sum((-2, -1)) + Gk.sum(-1)
    dacs = torch.cat([dacs[..., :-1], dacs[..., -1:] + last[..., None]], -1)
    da = torch.flip(torch.cumsum(torch.flip(dacs, [-1]), -1), [-1])

    def back(t):  # [b, nh, c, P, w] -> [b, s, nh, w]
        return t.permute(0, 2, 3, 1, 4).reshape(b, c * P, nh, -1)[:, :s]

    def group_sum(t):
        return back(t).reshape(b, s, G, hpg, S).sum(3)

    da_log = da.permute(0, 2, 3, 1).reshape(b, c * P, nh)[:, :s]
    return back(dX), da_log, group_sum(dB), group_sum(dC)
