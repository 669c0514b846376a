"""Nested dict/list parameter trees, traversed in JAX's pytree order.

Parameter, gradient and optimizer trees are plain nested dicts and lists
of tensors that mirror the reference's layout exactly. Traversal follows
``jax.tree_util``: dict keys sorted, lists and tuples in order. Paths are
rendered as ``jax.tree_util.keystr`` renders them
(``"['stages'][0]['blocks']['attn']['wq']"``, and ``.q`` for a named tuple
field), so the path regexes of ``classify_leaves``, the bucket layouts and
the checkpoint leaf names come out identical on both sides.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["flatten_with_path", "leaves", "tree_map", "unflatten"]


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> Iterator[tuple[str, Any]] | None:
    if isinstance(node, dict):
        return ((f"[{k!r}]", node[k]) for k in sorted(node))
    if _is_namedtuple(node):
        return ((f".{f}", v) for f, v in zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return ((f"[{i}]", v) for i, v in enumerate(node))
    return None


def flatten_with_path(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(keystr path, leaf), ...]`` in JAX's flatten order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for key, child in kids:
        out.extend(flatten_with_path(child, prefix + key))
    return out


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _build(node: Any, it: Iterator[Any]) -> Any:
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if _is_namedtuple(node):
        return type(node)(*(_build(v, it) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten(like: Any, new_leaves) -> Any:
    """A tree shaped like ``like`` whose leaves are ``new_leaves`` in order.

    The recursion is a module function, not a closure: a closure that
    calls itself is a reference cycle, which would hold ``new_leaves``
    (whole trees of gradients or parameters) until the garbage collector
    runs."""
    return _build(like, iter(new_leaves))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
