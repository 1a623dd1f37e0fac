"""What one traced step does on one device: the recorder behind the dry
run (``launch/dryrun.py``) and the roofline's trace readers
(``roofline/analysis.py``).

``TraceRecorder`` is a ``TorchDispatchMode`` that sees the ops which run
on the *local* shards.  Entered below ``FakeTensorMode`` (``recording``
does both in that order), it is not shown an op on ``DTensor``s: DTensor
lowers that op to its local op and to the collectives of its
redistributions, and those reach the recorder on this rank's fake local
tensors.  So every number is per device, as the JAX package's numbers
from the partitioned HLO are:

* ``flops``: the FLOPs of every op that ``torch.utils.flop_counter`` has
  a formula for (matrix products, convolutions, attention, and the
  custom ops that register one, such as ``repro_torch::ssd_scan_fwd``),
  from the local shapes;
* ``result_bytes``: the bytes of every result of an op that is not a
  view or an alias of its input (the HLO parser's "result shape of every
  real op"); in-place ops count, since they write;
* ``bytes_accessed``: those results plus the bytes of the tensor inputs
  of the same ops (one read of each input, one write of each result);
* ``collectives``: per family (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``) the bytes
  of the local result of each functional collective, and their counts;
* ``calls``: how many times each op ran, by ``namespace::name``;
* ``peak_bytes``: the most bytes that the step's own allocations (a
  result that is not a view or an in-place write) held at once, each
  freed when its tensor is collected.

Nothing is allocated and nothing runs: the tensors are fake.  Only ops
on the fake tensors of the recorder's own mode count, and not the runs
that DTensor's sharding propagation makes on fake tensors of the global
shapes to learn an op's output (``torch/distributed/tensor/
_sharding_prop.py``, the first time it meets an op and its layouts).
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from collections import Counter
from typing import Dict, Iterator, List

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLL_FAMILIES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute")

# functional collectives (and DTensor's own) by op name -> family
_COLL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
    "isend": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
# ops that only name or wait for a result made elsewhere
_FREE = {"wait_tensor", "device", "_unsafe_view", "lift_fresh", "detach"}


def tensors_in(tree) -> List[torch.Tensor]:
    """The tensors among the leaves of ``tree``."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """This device's part of ``t``: a ``DTensor``'s local shard, a plain
    tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _in_sharding_propagation(depth: int = 12) -> bool:
    """Whether a caller a few frames up is DTensor's sharding propagation
    (``_sharding_prop.py``)."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class TraceRecorder(TorchDispatchMode):
    """Per-device counters of the ops that run under it (module
    docstring)."""

    def __init__(self, fake_mode: FakeTensorMode) -> None:
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.result_bytes = 0.0
        self.bytes_accessed = 0.0
        self.collectives: Dict[str, float] = {f: 0.0 for f in COLL_FAMILIES}
        self.collective_counts: Dict[str, int] = {f: 0 for f in
                                                  COLL_FAMILIES}
        self.calls: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor lowers it to local ops
        out = func(*args, **kwargs)
        outs = tensors_in(out)
        ins = tensors_in((args, kwargs))
        if not all(isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode
                   for t in outs + ins) or _in_sharding_propagation():
            return out  # not an op of the traced step
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        self.calls[f"{ns}::{name}"] += 1
        if ns in _COLL_NAMESPACES and name in _COLL_OPS:
            fam = _COLL_OPS[name]
            self.collectives[fam] += float(sum(_nbytes(t) for t in outs))
            self.collective_counts[fam] += 1
            return out
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        if func.is_view or name in _FREE or not outs:
            return out
        in_keys = {_storage_key(t) for t in ins}
        writes = func._schema.is_mutable
        fresh = [t for t in outs if _storage_key(t) not in in_keys]
        if not writes and len(fresh) < len(outs):
            return out  # an alias of an input (a no-op cast, a copy=False)
        nres = sum(_nbytes(t) for t in outs)
        self.result_bytes += nres
        self.bytes_accessed += nres + sum(_nbytes(t) for t in ins)
        for t in fresh:
            n = _nbytes(t)
            self.live_bytes += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


@contextlib.contextmanager
def recording(fake_mode: FakeTensorMode) -> Iterator[TraceRecorder]:
    """A fresh ``TraceRecorder`` entered below ``fake_mode``, so that it
    sees the local ops of DTensors on fake tensors (module docstring)."""
    rec = TraceRecorder(fake_mode)
    with rec, fake_mode:
        yield rec


def local_bytes(tree) -> int:
    """Bytes of the tensors in ``tree`` on this device: a ``DTensor``'s
    local shard, a plain tensor whole."""
    return sum(_nbytes(local_shard(t)) for t in tensors_in(tree))
