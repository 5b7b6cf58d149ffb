"""Nested containers of tensors: the port's stand-in for JAX pytrees.

Parameters, gradients and optimiser moments are nested dicts of tensors;
optimiser and checkpoint state adds NamedTuples and tuples around them.
Leaves are visited in JAX's order -- dict keys sorted, tuple fields in
order -- so a leaf's index and path in a checkpoint manifest are the same
in both packages.  A path spells each step as the reference's checkpoint
manager does: a dict key or tuple index as itself, a NamedTuple field as
``.name``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree: Any, prefix: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) pairs in JAX's flattening order; ``None`` is an empty
    subtree, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from leaves_with_paths(getattr(tree, name),
                                         prefix + ("." + name,))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from leaves_with_paths(x, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [x for _, x in leaves_with_paths(tree)]


def unflatten_like(tree_like: Any, new_leaves) -> Any:
    """``tree_like``'s structure with its leaves replaced, in the order of
    :func:`leaves_with_paths`."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the caller's key order
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (and of the same structure
    in ``rest``), keeping the dicts' key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
