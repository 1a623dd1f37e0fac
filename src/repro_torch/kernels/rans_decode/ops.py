"""Public rANS stream decode op: the plain version for a CPU device, the
CUDA kernel (``rans_decode.cu``) for a CUDA device, every stream of a
fetched chunk in one launch."""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import entropy
from repro_torch.kernels import build
from repro_torch.kernels.rans_decode.ref import rans_decode_ref

#: kernel launches so far; a run resets it to 0 and reads it back to show
#: which of its calls went through the kernel
launches = 0

#: lanes of a stream the kernel decodes (one thread a lane)
MAX_LANES = 1024

_ALIGN = 16
_DESC_BYTES = 64  # eight int64 a stream (``rans_decode.cu``)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        _fn = build.load("rans_decode").rans_decode
        p, i = ctypes.c_void_p, ctypes.c_int
        _fn.argtypes = [p, p, i, i, i, p]
        _fn.restype = ctypes.c_int
    return _fn


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _host_bytes(stream):
    """A stream's bytes on the host, refusing device tensors."""
    if isinstance(stream, torch.Tensor):
        if stream.device.type != "cpu":
            raise ValueError(f"rans_decode_streams: streams are read on the "
                             f"host, got a tensor on {stream.device}")
        return stream.contiguous().numpy().view(np.uint8)
    return stream


def _parse(stream) -> entropy.Stream:
    s = entropy.parse_stream(_host_bytes(stream))
    if s.lanes < 1:
        raise ValueError("rans_decode_streams: a stream of 0 lanes")
    if int(s.freq.sum(dtype=np.int64)) != entropy.PROB_SCALE \
            or int(s.freq.max()) >= entropy.PROB_SCALE:
        raise ValueError(f"rans_decode_streams: a frequency table must sum "
                         f"to {entropy.PROB_SCALE} with every entry below it")
    return s


class Packed(NamedTuple):
    """A launch's input laid out on the host (``rans_decode.cu``)."""
    host_in: torch.Tensor  # pinned uint8: descriptors, tables, states, words
    live: List[int]        # indices of the non-empty streams, one block each
    out_offs: List[int]    # byte offset of each live stream's symbols
    out_bytes: int         # the words read by each stream, then the symbols
    threads: int           # lanes of the widest stream, in whole warps


def pack(parsed: Sequence[entropy.Stream]) -> Packed:
    """Lay the non-empty streams out in one pinned buffer: descriptors,
    then each stream's table, states and words at 16-byte offsets."""
    wide = [s.lanes for s in parsed if s.lanes > MAX_LANES]
    if wide:
        raise ValueError(f"rans_decode_streams: {wide[0]} lanes, the kernel "
                         f"decodes at most {MAX_LANES}")
    live = [i for i, s in enumerate(parsed) if s.n > 0]
    desc = np.zeros((len(live), 8), np.int64)
    at = _up(_DESC_BYTES * len(live))
    out_at = _up(8 * len(live))
    for row, i in enumerate(live):
        s = parsed[i]
        desc[row, :3] = (at, at + 512, at + 512 + _up(8 * s.lanes))
        at = int(desc[row, 2]) + _up(4 * s.words.size)
        desc[row, 3:7] = (s.words.size, s.n, s.lanes, out_at)
        out_at += _up(s.n)
    host_in = torch.empty(at, dtype=torch.uint8, pin_memory=True)
    hv = host_in.numpy()
    hv[:desc.nbytes] = desc.view(np.uint8).reshape(-1)
    for row, i in enumerate(live):
        s = parsed[i]
        for off, part in zip(desc[row, :3], (s.freq, s.states, s.words)):
            hv[off:off + part.nbytes] = part.view(np.uint8)
    threads = max((32 * -(-parsed[i].lanes // 32) for i in live), default=32)
    return Packed(host_in, live, desc[:, 6].tolist(), out_at, threads)


def launch(dev_in: torch.Tensor, dev_out: torch.Tensor, n_live: int,
           threads: int) -> None:
    """One kernel launch on the current stream over ``n_live`` streams
    laid out by ``pack`` and uploaded to ``dev_in``; not synchronised."""
    device = dev_in.device
    if dev_out.device != device:
        raise ValueError(f"rans_decode: output on {dev_out.device}, input "
                         f"on {device}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    err = _launcher()(dev_in.data_ptr(), dev_out.data_ptr(), n_live,
                      threads, index,
                      torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "rans_decode")
    global launches
    launches += 1


def rans_decode_streams(streams: Sequence, device) -> List[torch.Tensor]:
    """Decode every stream of ``streams`` (``core.entropy.encode`` outputs:
    bytes, or uint8 arrays or CPU tensors) into its n uint8 symbols, on
    ``device``; returns one host uint8 tensor per stream, in order.

    On a CUDA device the streams go up in one pinned buffer, one kernel
    launch decodes all of them (a block per non-empty stream, at most
    ``MAX_LANES`` lanes), and the symbols come back into one pinned host
    buffer; the call returns after the readback.  On the CPU each stream
    runs the plain version.  Raises ValueError on a stream that is
    truncated or does not read exactly its words."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"rans_decode_streams: no kernel for {device}")
    parsed = [_parse(s) for s in streams]
    if device.type == "cpu":
        return [rans_decode_ref(
            s.n, torch.from_numpy(s.freq.astype(np.int64)),
            torch.from_numpy(s.words.astype(np.int64)),
            torch.from_numpy(s.states.astype(np.int64))) for s in parsed]
    p = pack(parsed)
    if not p.live:
        return [torch.empty(0, dtype=torch.uint8) for _ in parsed]
    dev_in = p.host_in.to(device, non_blocking=True)
    dev_out = torch.empty(p.out_bytes, dtype=torch.uint8, device=device)
    launch(dev_in, dev_out, len(p.live), p.threads)
    host_out = torch.empty(p.out_bytes, dtype=torch.uint8, pin_memory=True)
    host_out.copy_(dev_out, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    read = host_out[:8 * len(p.live)].view(torch.int64).tolist()
    out = [host_out[:0]] * len(parsed)
    for row, i in enumerate(p.live):
        if read[row] != parsed[i].words.size:
            raise ValueError(f"rans_decode_streams: stream {i} read "
                             f"{read[row]} of its {parsed[i].words.size} "
                             f"words")
        out[i] = host_out[p.out_offs[row]:p.out_offs[row] + parsed[i].n]
    return out
