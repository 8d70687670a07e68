"""Nested containers of tensors, walked the way ``jax.tree_util`` walks them.

The port keeps parameters, gradients and optimizer state as the JAX package
does: nested dicts (walked in sorted-key order), lists, tuples and
NamedTuples (in field order), with ``None`` an empty node.  The order
matters: Shampoo stacks each eligible leaf's blocks in leaf order, and a
checkpoint names each leaf by its path.  Paths are spelled as
``jax.tree_util.keystr`` pieces joined by ``/`` (``['units']/['wq']``,
``[0]``, ``.mu``), so the two packages name a leaf alike.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten_with_paths", "leaves", "tree_map"]


def _walk(tree, path: Tuple[str, ...], out: List[Tuple[str, Any]]) -> Callable:
    """Append (path, leaf) pairs to ``out``; return a function that rebuilds
    the tree from an iterator over new leaves."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, dict):
        subs = [(k, _walk(tree[k], path + (f"[{k!r}]",), out)) for k in sorted(tree)]
        return lambda it: type(tree)((k, f(it)) for k, f in subs)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        subs = [_walk(v, path + (f".{name}",), out) for name, v in zip(tree._fields, tree)]
        return lambda it: type(tree)(*(f(it) for f in subs))
    if isinstance(tree, (list, tuple)):
        subs = [_walk(v, path + (f"[{i}]",), out) for i, v in enumerate(tree)]
        return lambda it: type(tree)(f(it) for f in subs)
    out.append(("/".join(path), tree))
    return lambda it: next(it)


def flatten_with_paths(tree) -> Tuple[List[str], List[Any], Callable]:
    """``(paths, leaves, rebuild)``; ``rebuild(new_leaves)`` makes a tree of
    the same structure."""
    pairs: List[Tuple[str, Any]] = []
    build = _walk(tree, (), pairs)
    return [p for p, _ in pairs], [v for _, v in pairs], lambda new: build(iter(new))


def leaves(tree) -> List[Any]:
    return flatten_with_paths(tree)[1]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure)."""
    _, xs, rebuild = flatten_with_paths(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(xs):
            raise ValueError(f"tree_map over trees of {len(xs)} and {len(o)} leaves")
    return rebuild([fn(*args) for args in zip(xs, *others)])
