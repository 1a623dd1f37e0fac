"""Plain PyTorch version of the rANS stream decode, in the kernel's own
arithmetic: one round decodes one symbol in every lane, and the lanes that
refill take the next words of the stream in ascending lane order, each at
the offset that a warp ballot gives it (its rank among its warp's refilling
lanes) plus its warp's base (the refills of the warps below it).  States
are int64: a state stays below 2**63, so no value here needs uint64."""
from __future__ import annotations

import torch

PROB_BITS = 12
PROB_MASK = (1 << PROB_BITS) - 1
RANS_L = 1 << 31
WARP = 32


def popc32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in an int64 tensor (``__popc``)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def refill_offsets(need: torch.Tensor):
    """Each refilling lane's offset from the round's first word, and the
    round's refills: ``__ballot_sync`` per warp of 32 lanes, the lane's
    rank ``__popc(ballot & lanemask_lt)``, and the exclusive prefix of the
    warps' totals ``__popc(ballot)``.  need [lanes] bool."""
    lanes = need.numel()
    warps = -(-lanes // WARP)
    bit = torch.arange(WARP, dtype=torch.int64)
    m = torch.zeros(warps * WARP, dtype=torch.int64)
    m[:lanes] = need.to(torch.int64)
    ballot = (m.view(warps, WARP) << bit).sum(1)
    rank = popc32(ballot[:, None] & ((1 << bit) - 1))
    total = popc32(ballot)
    base = torch.cumsum(total, 0) - total
    return (base[:, None] + rank).reshape(-1)[:lanes], int(total.sum())


def decode_tables(freq: torch.Tensor):
    """(cum [256], sym_of [4096]) of a frequency table [256] that sums to
    4096; symbols of frequency 0 own no slot."""
    freq = freq.to(torch.int64)
    cum = torch.cumsum(freq, 0) - freq
    sym_of = torch.repeat_interleave(torch.arange(256), freq)
    return cum, sym_of


def rans_decode_ref(n: int, freq: torch.Tensor, words: torch.Tensor,
                    states: torch.Tensor) -> torch.Tensor:
    """Decode one stream's first ``n`` symbols: freq [256] (sums to 4096),
    words [n_words] int64 (u32 values), states [lanes] int64 (the encoder's
    final states).  Every lane decodes every round, the padded lanes of the
    last round too, as ``core.entropy.StreamDecoder`` does.  Returns uint8
    [n]; raises ValueError if the rounds read other than all the words."""
    cum, sym_of = decode_tables(freq)
    freq = freq.to(torch.int64)
    x = states.to(torch.int64).clone()
    lanes = x.numel()
    rounds = -(-n // lanes)
    out = torch.empty(rounds * lanes, dtype=torch.uint8)
    wpos = 0
    for r in range(rounds):
        slot = x & PROB_MASK
        sym = sym_of[slot]
        x = freq[sym] * (x >> PROB_BITS) + slot - cum[sym]
        need = x < RANS_L
        offs, total = refill_offsets(need)
        if wpos + total > words.numel():
            raise ValueError(f"rANS stream reads past its {words.numel()} "
                             f"words in round {r}")
        x[need] = (x[need] << 32) | words[wpos + offs[need]]
        wpos += total
        out[r * lanes:(r + 1) * lanes] = sym.to(torch.uint8)
    if wpos != words.numel():
        raise ValueError(f"rANS stream read {wpos} of its {words.numel()} "
                         f"words")
    return out[:n]
