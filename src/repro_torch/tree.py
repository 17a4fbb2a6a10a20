"""Nested-dict parameter trees: flatten in the reference's leaf order.

``jax.tree_util`` flattens a dict by its SORTED keys, and the JAX
package's checkpoint names a leaf by its path joined with ``/``.  The
training path of the port keeps both conventions, so that a global norm
sums its leaves in the reference's order and a checkpoint names its
leaves as the reference does.  ``None`` leaves are empty subtrees, as in
JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

Tree = Any


def named_leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) over ``tree`` in sorted-key order; names are key paths
    joined with ``/`` (list and tuple members by index)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and of the trees of its
    structure in ``rest``; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def rebuild(tree: Tree, table: Dict[str, Any]) -> Tree:
    """A tree of ``tree``'s structure whose leaf named n (as
    :func:`named_leaves` names it) is ``table[n]``."""
    return _rebuild(tree, "", table)


def _rebuild(t: Tree, prefix: str, table: Dict[str, Any]) -> Tree:
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding ``table`` (and its tensors) until the garbage collector
    if isinstance(t, dict):
        return {k: _rebuild(v, f"{prefix}{k}/", table) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(v, f"{prefix}{i}/", table)
                       for i, v in enumerate(t))
    if t is None:
        return None
    return table[prefix[:-1]]


def unflatten_like(tree: Tree, values: List[Any]) -> Tree:
    """A tree of ``tree``'s structure whose leaves, in sorted-key order,
    are ``values``."""
    names = [name for name, _ in named_leaves(tree)]
    if len(names) != len(values):
        raise ValueError(f"{len(values)} values for {len(names)} leaves")
    return rebuild(tree, dict(zip(names, values)))
