"""The port's trees: nested dicts, lists, tuples and named tuples with
tensors (or numpy arrays and scalars) at the leaves, such as the param
tree and ``(params, AdamWState)``.

One walker for the optimizer, the train step and checkpoints, so every
flatten and rebuild visits the leaves in one order: a dict's insertion
order, a sequence's index order and a named tuple's field order. A leaf's
path is the tuple of its keys in the reference checkpoint's spelling
(``str`` of a dict key or sequence index, ``.field`` for a named tuple's
field).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

__all__ = ["leaves", "leaves_with_path", "map_with_path", "tree_map",
           "unflatten"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list[tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    return [(str(i), v) for i, v in enumerate(node)]


def _is_container(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def leaves_with_path(tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf of ``tree``, in tree order."""
    if not _is_container(tree):
        yield path, tree
        return
    for k, v in _children(tree):
        yield from leaves_with_path(v, path + (k,))


def leaves(tree) -> list:
    """Every leaf of ``tree``, in tree order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable[[tuple, Any], Any], tree, path: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if not _is_container(tree):
        return fn(path, tree)
    kids = [map_with_path(fn, v, path + (k,)) for k, v in _children(tree)]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), kids))
    if _is_namedtuple(tree):
        return type(tree)(*kids)
    return type(tree)(kids)


def tree_map(fn: Callable[[Any], Any], tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    return map_with_path(lambda _, leaf: fn(leaf), tree)


def unflatten(template, new_leaves: Iterable):
    """A tree shaped as ``template`` whose leaves are ``new_leaves``, taken
    in tree order (as :func:`leaves` gives them)."""
    it = iter(new_leaves)

    def take(_):
        leaf = next(it, it)
        if leaf is it:
            raise ValueError("fewer leaves than the template has")
        return leaf

    out = tree_map(take, template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template has")
    return out
