"""Parameter trees: the bridge from the JAX package's weights, and their
``nn.Module`` form.

A parameter tree is the JAX package's layout: nested dicts and lists of
arrays, matrices ``[in, out]`` so that a layer is ``x @ W``. The port keeps
that layout, so one set of weights runs through both packages.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch._device import resolve_device


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """Every leaf of a tree of dicts and lists, in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves`' order)
    in place of its own."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_map2(fn: Callable[[Any, Any], Any], a: Any, b: Any) -> Any:
    """``fn`` over the leaves of two trees of one structure, matched by key
    (``a``'s keys; ``b`` may be a dict or a :class:`ParamTree`): two trees
    built in another key order still pair leaf with leaf."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return [tree_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: jax hands out read-only views
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) is unknown to torch.from_numpy: move
        # the raw bits and reinterpret them
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Any, device=None, dtype: torch.dtype | None = None) -> Any:
    """JAX parameter tree (after ``jax.tree.map(np.asarray, params)``) → the
    same tree of torch tensors on ``device``. Works for the encoder and the
    reranker (``head.w``, ``head.b``) alike, and takes numpy bfloat16 arrays.
    ``dtype`` casts every matrix (ndim >= 2), as the encoders' ``param_dtype``
    does; vectors (norms, biases) keep their type."""
    dev = resolve_device(device)

    def leaf(a):
        t = _to_tensor(np.asarray(a))
        if dtype is not None and t.ndim >= 2:
            t = t.to(dtype)
        return t.to(dev)

    return tree_map(leaf, tree)


class ParamTree(nn.Module):
    """``nn.Module`` view of a parameter tree: dict keys become attributes,
    lists ``nn.ModuleList``s and tensors frozen ``nn.Parameter``s. Indexing
    works as on the dict, so the functional forward takes either form."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)
