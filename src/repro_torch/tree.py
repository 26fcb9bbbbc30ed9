"""Trees of the port: nested dicts and lists with tensor leaves.

The reference's trees are JAX pytrees whose repeated groups are stacked
along a leading axis; the port keeps each group as an element of a list.
:func:`to_numpy` turns a port tree into the reference's layout (each list
stacked along a new leading axis), the form in which parameters, train
states and checkpoints cross between the two packages, and
:func:`from_numpy` turns it back, led by a tree of the port's structure.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["keyed_leaves", "reference_key", "tree_leaves", "tree_map", "to_numpy",
           "from_numpy"]


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, depth first in insertion
    order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def reference_key(path: tuple) -> str:
    """The reference's key of a port path: its dict keys joined by "/"
    (list indices, which stack in the reference, add nothing)."""
    return "/".join(str(p) for p in path if not isinstance(p, int))


def keyed_leaves(tree, path: tuple = (), stack: tuple = ()):
    """``(path, reference key, reference shape, list depth, leaf)`` of every
    leaf of a port tree, in :func:`tree_leaves`' order; the reference shape
    puts the lengths of the lists above a leaf in front of its shape, as
    :func:`to_numpy` stacks them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from keyed_leaves(v, path + (k,), stack)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from keyed_leaves(v, path + (i,), stack + (len(tree),))
    else:
        yield path, reference_key(path), (*stack, *tree.shape), len(stack), tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of same-structured ``rest``,
    matched by key (dicts) and position (lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def to_numpy(tree):
    """A port tree -> the reference's layout as numpy arrays: each list
    becomes one subtree whose leaves are its elements' leaves stacked along
    a new leading axis.  Every array is a copy that owns its memory, so the
    tree may change in place (a train step) while the copy is written."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _stack(tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    return np.array(tree)


def _stack(trees: list):
    """A (nested) list of same-structured trees -> one tree whose leaves
    stack the elements' leaves along the list axes; each leaf is copied
    once, straight from its device into its slice of the stacked array."""
    bottom = trees
    dims = []
    while isinstance(bottom, list):
        dims.append(len(bottom))
        bottom = bottom[0]
    if isinstance(bottom, dict):
        return {k: _stack(_map_nested(lambda d, k=k: d[k], trees)) for k in bottom}
    first = to_numpy(bottom.reshape(-1)[:0]) if isinstance(bottom, torch.Tensor) \
        else np.asarray(bottom)
    out = np.empty((*dims, *np.shape(bottom)), dtype=first.dtype)
    for idx in np.ndindex(*dims):
        leaf = trees
        for i in idx:
            leaf = leaf[i]
        if isinstance(leaf, torch.Tensor):
            torch.from_numpy(out[idx + (Ellipsis,)]).copy_(leaf.detach())
        else:
            out[idx] = leaf
    return out


def _map_nested(fn: Callable, x):
    return [_map_nested(fn, y) for y in x] if isinstance(x, list) else fn(x)


def from_numpy(tree, like, leaf: Callable):
    """The inverse of :func:`to_numpy`: a reference-layout tree in the
    structure of ``like``.  Where ``like`` holds a list, its elements come
    from the leading axis of the subtree's leaves (whose length must be the
    list's); each leaf is ``leaf(array, like_leaf)``."""
    if isinstance(like, dict):
        return {k: from_numpy(tree[k], v, leaf) for k, v in like.items()}
    if isinstance(like, list):
        n = _stack_len(tree)
        if n != len(like):
            raise ValueError(f"a stack of {n} where the port's tree holds {len(like)}")
        return [from_numpy(_index(tree, i), v, leaf) for i, v in enumerate(like)]
    return leaf(tree, like)


def _stack_len(tree) -> int:
    """The leading (stacked) axis of a tree's leaves."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.shape(tree)[0]


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
