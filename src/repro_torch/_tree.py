"""Trees of tensors: nested dicts with tensors (or anything else) at the
leaves, walked in sorted-key order, the order ``jax.tree`` flattens a
dict in, so that a leaf list lines up with the reference's."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_flatten_with_path",
           "tree_unflatten"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf to ``tree`` and the trees ``rest`` of the
    same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_flatten_with_path(tree: Any, path: Tuple = ()) -> List[Tuple]:
    """``[(keys, leaf), ...]``: each leaf with the tuple of dict keys that
    leads to it."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_path(tree[k], path + (k,))]
    return [(path, tree)]


def tree_unflatten(paths, leaves) -> Any:
    """The tree whose leaves ``leaves`` sit at ``paths`` (key tuples, as
    :func:`tree_flatten_with_path` gives them); an empty path is a bare
    leaf."""
    out: Any = None
    for path, leaf in zip(paths, leaves):
        if not path:
            return leaf
        if out is None:
            out = {}
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
