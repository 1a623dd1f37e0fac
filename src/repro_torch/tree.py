"""Trees of tensors as the port keeps them (nested dicts and lists with
tensor leaves, e.g. the parameter dict of ``params.py``): the leaves in
a fixed order (dict keys sorted, lists in order) with their key paths,
and maps over trees of one structure.  The JAX package uses
``jax.tree`` for the same."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key path, leaf)], e.g. ``("layers/0/attn/wq", tensor)``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (of the same structure), into a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def _rebuild(node, items: List[Any]):
    """A list or tuple (named tuples too) of ``node``'s type."""
    return type(node)(*items) if hasattr(node, "_fields") \
        else type(node)(items)


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree shaped as ``like`` whose leaves, in ``flatten`` order, are
    ``new_leaves``."""
    paths = {path: i for i, (path, _) in enumerate(flatten(like))}
    if len(paths) != len(new_leaves):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(paths)}")

    def pick(node, prefix):
        if isinstance(node, dict):
            return {k: pick(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [pick(v, f"{prefix}{i}/")
                                   for i, v in enumerate(node)])
        return new_leaves[paths[prefix[:-1]]]

    return pick(like, "")
