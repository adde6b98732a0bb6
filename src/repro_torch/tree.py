"""Trees of tensors: the part of ``jax.tree`` the training path uses.

A tree is a NamedTuple, a dict, a list or a plain tuple of subtrees, or a
leaf; ``None`` is an empty subtree (an absent bias, the tied
unembedding, a state without error feedback), as it is in ``jax.tree``.
Leaves are visited in ``jax.tree``'s order: NamedTuple fields in order,
dict keys sorted, sequences in order.  :func:`leaves_with_path` names a
leaf as ``repro.checkpoint.ckpt._path_str`` names it (field names, dict
keys and sequence indices joined by ``/``), so a key names the same leaf
in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    """(name, subtree) of a node, in ``jax.tree``'s order; [] for a leaf
    or ``None``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), t) for i, t in enumerate(tree)]
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (tuple, list, dict))


def _rebuild(like, children: list):
    """A node of ``like``'s kind with ``children`` in ``_children``'s
    order."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*children)
    if isinstance(like, dict):
        return dict(zip(sorted(like), children))
    return type(like)(children)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on the leaves of ``tree`` and the matching leaves of each tree
    in ``rest`` (same structure); ``None`` in ``tree`` stays ``None``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    kids = [[t for _, t in _children(r)] for r in rest]
    out = [tree_map(fn, t, *(k[i] for k in kids))
           for i, (_, t) in enumerate(_children(tree))]
    return _rebuild(tree, out)


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(path, leaf)`` on every leaf, ``path`` as :func:`leaves_with_path`
    names it."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(prefix, tree)
    return _rebuild(tree, [
        map_with_path(fn, t, f"{prefix}/{name}" if prefix else name)
        for name, t in _children(tree)])


def leaves_with_path(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, in order."""
    out: List[Tuple[str, Any]] = []
    map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def leaves(tree) -> list:
    """The leaves of ``tree``, in order."""
    return [x for _, x in leaves_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it: Iterator = iter(new_leaves)
    return tree_map(lambda _: next(it), like)


def tree_map_n(fn: Callable, n: int, tree, *rest) -> tuple:
    """``fn`` returns an n-tuple for each leaf: the n trees of its parts
    (the reference's ``jax.tree.map`` then ``jax.tree.transpose``)."""
    outs: list = []
    tree_map(lambda *a: outs.append(fn(*a)), tree, *rest)
    return tuple(unflatten(tree, [o[i] for o in outs]) for i in range(n))
