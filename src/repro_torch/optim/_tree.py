"""The few pytree helpers the optimisers need: params, grads and states
are (nested) dicts of tensors, walked in sorted key order as the JAX
package's pytrees are."""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching entries of
    ``rest`` (trees with the same dict keys down to ``tree``'s leaves),
    keeping ``tree``'s structure."""
    if isinstance(tree, dict):
        for r in rest:
            if set(r) != set(tree):
                raise ValueError(
                    f"trees differ in keys: {sorted(set(r) ^ set(tree))}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of ``tree`` in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
