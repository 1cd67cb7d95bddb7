"""Trees of tensors or arrays (nested dicts, lists, tuples and
``NamedTuple``s, as the port's params and optimizer state and the
reference's converted weights are), walked in one fixed order: dict
insertion order, sequence index order, ``NamedTuple`` field order. Each
leaf has a path, ``"layers/0/attn/wq"``: the checkpoint's keys. Two
trees of the same paths may order their dict keys differently
(``tree_map`` looks the other trees' leaves up by key)."""
from __future__ import annotations


def _items(tree):
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree, prefix: str = ""):
    """[(path, leaf)] in the tree's order."""
    items = _items(tree)
    if items is None:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree):
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves of rest at the same place)`` over ``tree``'s
    structure (``rest`` share it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def unflatten(like, new_leaves):
    """``like``'s structure with ``new_leaves`` in its order."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), like)
