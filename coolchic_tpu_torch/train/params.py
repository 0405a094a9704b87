"""Parameter partitioning for the two-group optimizer setup, and the small
pytree helpers the trainer needs over nested dicts and lists of tensors.

The reference optimizes latent grids with Adam-like settings and network
weights with full SOAP, while freezing the synthesis output transform and
the global-flow buffers (coolchic/training/train.py:103-143).

Leaves are flattened in the order jax.tree_util uses (dict keys sorted,
lists in order), so a flattened leaf list lines up with the JAX package's
(coolchic_tpu/train/params.py:group_tree).
"""

from __future__ import annotations

from typing import Any, Callable

LATENT, WEIGHT, FROZEN = "latent", "weight", "frozen"


def leaf_group(path_str: str) -> str:
    if "latents" in path_str:
        return LATENT
    if "output_transform" in path_str or "global_flow" in path_str:
        return FROZEN
    return WEIGHT


def tree_flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] with jax.tree_util.keystr-style paths, in JAX's
    flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_flatten_with_path(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(tree_flatten_with_path(v, f"{prefix}[{i}]"))
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves: list):
    """A tree of `like`'s structure holding `leaves` (in flattening order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}  # keep the caller's key order
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    assert next(it, None) is None, "more leaves than the tree holds"
    return out


def tree_map(fn: Callable, tree, *rest):
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree),
                                                        *map(tree_leaves, rest))])


def group_tree(params) -> list[str]:
    """Group label per flattened leaf (stable order)."""
    return [leaf_group(path) for path, _ in tree_flatten_with_path(params)]
