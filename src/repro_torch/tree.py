"""Nested containers of tensors ("trees"): the port's stand-in for JAX's
pytrees.  Dicts, lists, tuples and NamedTuples are containers; anything
else is a leaf.  :func:`leaves` and :func:`flatten_with_paths` visit dict
keys in sorted order and NamedTuple fields in order, as ``jax.tree``
flattens them, and a path spells each step as JAX prints it: a dict key,
a sequence index, ``.name`` for a NamedTuple field — so a checkpoint's
leaf paths are the reference's."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> List[Tuple[Any, Any]]:
    """(path step, child) pairs of a container, in flattening order."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [("." + f, v) for f, v in zip(tree._fields, tree)]
    return list(enumerate(tree))


def _rebuild(tree: Any, values: List[Any]) -> Any:
    """A container like ``tree`` holding ``values`` (in flattening order)."""
    if isinstance(tree, dict):
        out = dict(zip(sorted(tree), values))
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return type(tree)(values)


def _is_leaf(x: Any) -> bool:
    return not isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    if _is_leaf(tree):
        return [(prefix, tree)]
    out: List[Tuple[Path, Any]] = []
    for step, child in _children(tree):
        out += flatten_with_paths(child, prefix + (step,))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def map(fn: Callable, tree: Any, *rest: Any) -> Any:   # noqa: A001
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    kids = _children(tree)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [map(fn, child, *(o[i][1] for o in others))
                           for i, (_, child) in enumerate(kids)])


def map_with_path(fn: Callable, tree: Any, prefix: Path = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``."""
    if _is_leaf(tree):
        return fn(prefix, tree)
    return _rebuild(tree, [map_with_path(fn, child, prefix + (step,))
                           for step, child in _children(tree)])


def path_str(path: Path) -> str:
    """A path as the reference's checkpoint manifest writes it."""
    return "/".join(str(step) for step in path)


def unflatten(tree: Any, values: List[Any]) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``values``, in
    flattening order."""
    it = iter(values)
    return map(lambda _leaf: next(it), tree)
