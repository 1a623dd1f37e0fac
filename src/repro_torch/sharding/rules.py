"""Logical-axis sharding rules (MaxText-style), divisibility-aware.

The JAX package's rule engine over a torch ``DeviceMesh``.  Model code
annotates tensors with *logical* axis names via ``shard_hint``; launchers
activate a rule set mapping logical names to mesh axes.  Outside an
active context (unit tests, CPU smoke runs) ``shard_hint`` is a no-op, so
the model zoo never depends on a mesh being present.

A rule maps a logical axis to a priority list of mesh axes (or axis
tuples).  At resolution time we pick the first candidate whose total
size evenly divides the dimension: small smoke models never crash on a
256-card mesh, and dims like GQA's 8 KV heads fall back to replication on
a 16-way model axis instead of producing an invalid sharding.

A resolved spec is a tuple with one entry per tensor dim: ``None``, a
mesh axis name or a tuple of names (JAX's ``PartitionSpec``).
``placements`` turns it into DTensor placements, one ``Shard(i)`` or
``Replicate()`` per mesh dim.  The resolver reads only the mesh's axis
sizes: a ``DeviceMesh`` (``mesh_dim_names`` with its ``shape``), or any
object whose ``.shape`` is already a mapping from axis name to size.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

AxisCand = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[AxisCand], ...]

# Default rule set. "fsdp" behaviour: weight dims marked "embed" shard over
# the data axes, giving ZeRO-3-style full parameter sharding.
DEFAULT_RULES: Dict[str, Sequence[AxisCand]] = {
    "batch": [("pod", "data"), "data"],
    "seq": [],  # unsharded by default; "cp" variant shards it (see below)
    "cache_seq": [],  # decode-time KV seq; context-parallel rule shards it
    "embed": [("pod", "data"), "data"],  # fsdp dim of weights
    "embed_act": [],  # activation hidden dim
    "heads": ["model"],
    "kv_heads": ["model"],
    "head_dim": [],
    "mlp": ["model"],
    "vocab": ["model"],
    "experts": ["model"],
    "expert_cap": [],
    "ssm_inner": ["model"],
    "ssm_heads": ["model"],
    "ssm_state": [],
    "conv_channels": ["model"],
    # d_model sharded over the model axis (sequence-parallel-style
    # reduce-scatter points, e.g. the MoE combine)
    "embed_model": ["model"],
    "rglru_width": ["model"],
    "conv_k": [],
    "frames": [],
    "layers": [],  # stacked-layer leading dim of scanned params
}

# Context-parallel overlay used for batch=1 long-context decode: KV cache
# sequence is sharded over the data axes (queries are replicated, partial
# attention is combined with a logsumexp reduction).
CONTEXT_PARALLEL_OVERLAY: Dict[str, Sequence[AxisCand]] = {
    "cache_seq": [("pod", "data"), "data"],
    "batch": [],
}


class _State(threading.local):
    def __init__(self) -> None:
        self.mesh = None
        self.rules: Dict[str, Sequence[AxisCand]] = {}


_STATE = _State()


@contextlib.contextmanager
def activate(mesh, rules: Optional[Dict[str, Sequence[AxisCand]]] = None,
             overlay: Optional[Dict[str, Sequence[AxisCand]]] = None):
    """Activate (mesh, rules) so shard_hint becomes a real constraint."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    if overlay:
        merged.update(overlay)
    prev = (_STATE.mesh, _STATE.rules)
    _STATE.mesh, _STATE.rules = mesh, merged
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def active_mesh():
    return _STATE.mesh


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of ``mesh``."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: Dict[str, int], cand: AxisCand) -> int:
    if isinstance(cand, str):
        return sizes[cand]
    size = 1
    for a in cand:
        size *= sizes[a]
    return size


def _try_candidate(sizes: Dict[str, int], cand: Optional[AxisCand],
                   dim: int, taken: set) -> Optional[AxisCand]:
    if cand is None:
        return None
    axes = (cand,) if isinstance(cand, str) else tuple(cand)
    if any(a not in sizes for a in axes):
        return None
    if any(a in taken for a in axes):
        return None
    if dim % _axis_size(sizes, cand) != 0:
        return None
    return cand


def logical_to_pspec(logical_axes: Sequence[Optional[str]],
                     shape: Sequence[int], mesh=None) -> Spec:
    """Resolve logical axis names to a spec for `shape`.

    Resolution is round-based: in round r every still-unresolved dim tries
    its r-th candidate. A rule may contain ``None`` entries to skip early
    rounds, i.e. to yield a mesh axis to higher-priority logical axes
    (e.g. ``cache_seq: [None, "model"]`` lets ``kv_heads`` claim "model"
    first and only claims it when kv_heads was indivisible).
    """
    mesh = mesh or _STATE.mesh
    if mesh is None:
        raise ValueError("logical_to_pspec: no mesh given and none active")
    sizes = mesh_sizes(mesh)
    taken: set = set()
    out: list = [None] * len(logical_axes)
    resolved = [name is None for name in logical_axes]
    max_rounds = max((len(_STATE.rules.get(n, ())) for n in logical_axes
                      if n is not None), default=0)
    for r in range(max_rounds):
        for i, (name, dim) in enumerate(zip(logical_axes, shape)):
            if resolved[i]:
                continue
            cands = _STATE.rules.get(name, ())
            if r >= len(cands):
                continue
            cand = _try_candidate(sizes, cands[r], dim, taken)
            if cand is not None:
                axes = (cand,) if isinstance(cand, str) else tuple(cand)
                taken.update(axes)
                out[i] = cand
                resolved[i] = True
    return tuple(out)


def placements(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
               mesh=None) -> Tuple[Placement, ...]:
    """DTensor placements of a tensor of ``shape`` whose dims carry
    ``logical_axes`` on ``mesh`` (a ``DeviceMesh``; the active one by
    default): ``Shard(i)`` on each mesh dim that tensor dim i resolved
    to, ``Replicate()`` on the rest.  The counterpart of JAX's
    ``named_sharding``."""
    mesh = mesh or _STATE.mesh
    if mesh is None:
        raise ValueError("placements: no mesh given and none active")
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(logical_to_pspec(logical_axes, shape, mesh)):
        if entry is None:
            continue
        for axis in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(axis)] = Shard(i)
    return tuple(out)


def shard_hint(x: torch.Tensor, logical_axes: Sequence[Optional[str]]):
    """Lay ``x`` out by its logical axes if a rule context is active.

    A ``DTensor`` is redistributed to the resolved placements.  A plain
    tensor has no layout to constrain and comes back unchanged, as
    ``with_sharding_constraint`` leaves an array on a one-device mesh."""
    if _STATE.mesh is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"shard_hint: {len(logical_axes)} axes for rank-{x.ndim} array")
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(_STATE.mesh,
                          placements(logical_axes, x.shape, _STATE.mesh))
