"""Nested trees (dicts, tuples, lists) of leaves: the port's one
flattening order and one path naming.

Dict keys are walked sorted at every level, the order in which the
reference's ``jax.tree`` flattens a dict, so the optimizer's moments,
a checkpoint's arrays and a graph's static inputs line up leaf for leaf
with the reference's.  A leaf's path is its keys joined with ``sep``:
``"."`` gives ``state_dict`` names (``layers.uvqk``), ``"/"`` a
checkpoint's keys (``opt/mu/tok``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping


def leaves(tree) -> list:
    """The leaves of ``tree`` in order: dict keys sorted, tuples and
    lists in sequence."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, keeping its nesting and its
    container types."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def flatten(tree: Mapping[str, Any], sep: str) -> Dict[str, Any]:
    """The leaves of a nested dict by path, keys sorted at every level."""
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            flat.update({f"{k}{sep}{p}": x for p, x in flatten(v, sep).items()})
        else:
            flat[str(k)] = v
    return flat


def unflatten(flat: Mapping[str, Any], sep: str) -> Dict[str, Any]:
    """The reverse of ``flatten``: paths to a nested dict."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        *outer, leaf = path.split(sep)
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree
