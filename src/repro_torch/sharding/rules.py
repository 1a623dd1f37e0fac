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
``Replicate()`` per mesh dim.

``local_region`` runs a function on this rank's local shards
(``local_map``), its inputs and outputs laid out by their logical axes:
the model code's counterpart of what GSPMD propagates between the JAX
package's hints.  Inside it, ``local_offset`` and ``local_all_reduce``
see the shards of the region's logical axes.  The resolver reads only the mesh's axis
sizes: a ``DeviceMesh`` (``mesh_dim_names`` with its ``shape``), or any
object whose ``.shape`` is already a mapping from axis name to size.
"""
from __future__ import annotations

import contextlib
import math
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.distributed.tensor.placement_types import Placement
from torch.utils._pytree import tree_flatten, tree_unflatten

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


class _State:
    """The active rule context.  Process-wide, not per thread (the JAX
    package keeps it per thread): the autograd engine runs the backward
    of CUDA tensors, and so a checkpointed layer's recompute, on a device
    thread of its own, which must see the context of the step."""

    def __init__(self) -> None:
        self.mesh = None
        self.rules: Dict[str, Sequence[AxisCand]] = {}
        # inside a local region: logical axis -> (global size, mesh dims)
        self.region: Optional[Dict[str, Tuple[int, Tuple[int, ...]]]] = None


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


# ---------------------------------------------------------------------------
# Local regions
# ---------------------------------------------------------------------------

Axes = Optional[Sequence[Optional[str]]]


def _sharded_dims(pl: Sequence[Placement], dim: int) -> Tuple[int, ...]:
    return tuple(m for m, p in enumerate(pl)
                 if isinstance(p, Shard) and p.dim == dim)


def local_region(fn: Callable, args: Sequence[Any], in_axes: Sequence[Any],
                 out_axes: Any, *, partial: Sequence[str] = ()):
    """``fn(*args)`` on this rank's local shards when a rule context is
    active and a tensor in ``args`` is a ``DTensor``; plain
    ``fn(*args)`` otherwise.

    ``in_axes[i]`` mirrors ``args[i]``: the logical axes of a tensor, a
    dict or list of them for a dict or list of tensors, or ``None`` for
    an argument passed as it is.  Each tensor is laid out by its axes
    first (a plain tensor counts as replicated), so a weight whose
    FSDP dim is named ``None`` here is all-gathered over the data axes.
    An axis name resolves once per region: two inputs that name it must
    agree in size and layout.

    ``out_axes`` are the logical axes of ``fn``'s output, or a list of
    them for a tuple of outputs.  An output dim is laid out as the input
    dim of the same axis name; a name no input carries is replicated.
    ``partial`` names axes that ``fn`` contracts: each mesh dim that
    shards one of them holds a partial sum of the outputs.
    A gradient flows back as a partial sum on each mesh dim where its
    input was replicated but the region was split."""
    mesh = _STATE.mesh
    if mesh is None:
        return fn(*args)
    flat, spec = tree_flatten(list(args))
    if not any(isinstance(t, DTensor) for t in flat):
        return fn(*args)
    axes_flat = _flat_axes(args, in_axes)
    resolved: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
    in_pl: List[Optional[Tuple[Placement, ...]]] = []
    dflat = []
    for t, axes in zip(flat, axes_flat):
        if axes is None or not isinstance(t, torch.Tensor):
            in_pl.append(None)
            dflat.append(t)
            continue
        pl = placements(axes, t.shape, mesh)
        for i, name in enumerate(axes):
            if name is None:
                continue
            got = (t.shape[i], _sharded_dims(pl, i))
            if resolved.setdefault(name, got) != got:
                raise ValueError(
                    f"local_region: axis {name!r} resolves to "
                    f"{resolved[name]} and to {got}")
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        in_pl.append(pl)
        dflat.append(t)

    def out_pl(axes) -> List[Placement]:
        pl: List[Placement] = [Replicate()] * mesh.ndim
        for i, name in enumerate(axes):
            for m in resolved.get(name, (0, ()))[1]:
                pl[m] = Shard(i)
        for name in partial:
            for m in resolved.get(name, (0, ()))[1]:
                if isinstance(pl[m], Shard):
                    raise ValueError(f"local_region: mesh dim {m} both "
                                     f"shards and reduces {name!r}")
                pl[m] = Partial()
        return pl  # a list: local_map reads a tuple as one per output

    multi = isinstance(out_axes, list)
    outs = tuple(out_pl(a) for a in out_axes) if multi else out_pl(out_axes)
    split = {m for pls in ([outs] if not multi else list(outs)) + in_pl
             if pls is not None for m, p in enumerate(pls)
             if not isinstance(p, Replicate)}
    grad_pl = [None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and m in split else p
        for m, p in enumerate(pl)) for pl in in_pl]

    def flat_fn(*local):
        prev, _STATE.region = _STATE.region, resolved
        try:
            return fn(*tree_unflatten(list(local), spec))
        finally:
            _STATE.region = prev

    return local_map(flat_fn, out_placements=outs,
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*dflat)


def _flat_axes(args, in_axes) -> List[Axes]:
    """``in_axes`` flattened as ``tree_flatten`` flattens ``args``."""
    out: List[Axes] = []
    in_axes = list(in_axes) + [None] * (len(args) - len(in_axes))
    for a, axes in zip(args, in_axes):
        if isinstance(a, dict):
            out += _flat_axes(list(a.values()),
                              [axes.get(k) if axes else None for k in a])
        elif isinstance(a, (list, tuple)):
            out += _flat_axes(a, axes if axes is not None else [None] * len(a))
        else:
            out.append(axes if isinstance(a, torch.Tensor) else None)
    return out


def local_offset(name: str) -> int:
    """Inside a local region: the global index of the first element of
    this rank's shard along logical axis ``name`` (0 when it is not
    sharded, or outside a region)."""
    region = _STATE.region
    if not region or name not in region:
        return 0
    size, mdims = region[name]
    mesh = _STATE.mesh
    coord = mesh.get_coordinate()
    idx = 0
    for m in mdims:
        idx = idx * mesh.size(m) + coord[m]
    return idx * (size // math.prod(mesh.size(m) for m in mdims))


def local_all_reduce(t: torch.Tensor, name: str,
                     op: str = "sum") -> torch.Tensor:
    """Inside a local region: ``t`` reduced by ``op`` over the ranks that
    hold the other shards of logical axis ``name`` (``t`` itself when the
    axis is not sharded, or outside a region).  Not differentiable."""
    region = _STATE.region
    if not region or name not in region:
        return t
    for m in region[name][1]:
        t = funcol.all_reduce(t, op, (_STATE.mesh, m))
    return t


def global_size(name: str, local: int) -> int:
    """Inside a local region: the global size of logical axis ``name``
    (``local`` when the region does not carry it, or outside one)."""
    region = _STATE.region
    return region[name][0] if region and name in region else local


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor, a_axes: Axes,
           b_axes: Axes, out_axes: Axes) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` as a local region: each operand laid
    out by its logical axes, the output by ``out_axes``, and a partial
    sum on the mesh dims that shard a contracted axis (one the operands
    name and the output does not)."""
    if _STATE.mesh is None:
        return torch.einsum(eq, a, b)
    contracted = ({n for n in (*a_axes, *b_axes) if n is not None}
                  - set(out_axes))
    return local_region(lambda x, y: torch.einsum(eq, x, y), (a, b),
                        (a_axes, b_axes), tuple(out_axes),
                        partial=tuple(sorted(contracted)))
