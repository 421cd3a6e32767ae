"""Nested parameter trees: the port's stand-in for ``jax.tree``.

A tree is a nested structure of dicts and lists whose leaves are tensors (or
anything that is not a dict, a list or None).  ``None`` is an empty subtree,
as in jax.  Flattening visits dict keys in sorted order and list items in
index order — the order ``jax.tree.leaves`` gives — so a flat buffer of the
port and one of the JAX package compare column for column.  A leaf's path
is the tuple of keys and indices that leads to it; sorting paths gives that
same order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple

Path = Tuple[Any, ...]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf; each tree of ``rest`` has ``tree``'s
    structure as a prefix, so ``fn`` may receive a subtree from them (as
    ``jax.tree.map`` does)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: Path = ()):
    """``fn(path, leaf)`` applied leaf by leaf, keeping the structure (empty
    lists and None subtrees too)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, prefix + (i,))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_from_paths(items: Iterable[Tuple[Path, Any]]):
    """Inverse of ``tree_paths``: rebuild the nested dicts and lists (a path
    step that is an int indexes a list).  Empty subtrees do not come back."""
    root: dict = {}
    for path, leaf in items:
        node = root
        for step in path[:-1]:
            node = node.setdefault(step, {})
        node[path[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in range(len(out))]
        return out

    return listify(root)
