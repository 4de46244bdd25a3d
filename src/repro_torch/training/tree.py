"""Trees of tensors as the port keeps them, walked in JAX's flatten order.

A tree is nested dicts (the reference's parameter layout; keys sorted, as
JAX flattens a dict), NamedTuples (``OptState``, ``EFState``: fields in
order), tuples and lists; ``None`` is an empty subtree; anything else is a
leaf.  A leaf's path is a tuple of entries: a dict key, ``"." + field``
for a NamedTuple field (JAX prints a ``GetAttrKey`` so) and the index of
a sequence, as the reference's checkpoint keys spell them.

The walkers are module functions, not closures: a nested function that
calls itself is a reference cycle, and one over a list of leaves would
keep those tensors (a step's gradients) alive until Python's cycle
collector runs.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(node, path: tuple, out: list) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (k,), out)
    elif _is_namedtuple(node):
        for f in node._fields:
            _walk(getattr(node, f), path + (f".{f}",), out)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            _walk(v, path + (i,), out)
    else:
        out.append((path, node))


def flatten(tree: Any) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's flatten order."""
    out: list[tuple[tuple, Any]] = []
    _walk(tree, (), out)
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_build(getattr(node, f), it)
                            for f in node._fields))
    if isinstance(node, (tuple, list)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten(like: Any, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in flatten
    order."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
