"""Numerics sanitizers: NaN and Inf checks.

Port of ``surfacenet_tpu/utils/debug.py``.  The reference wraps a jitted
function with ``checkify``, which checks NaNs, divisions and indices
inside the compiled program; PyTorch runs eagerly, so ``checked_fn``
checks what the function returns:

    checked = checked_fn(train_step)
    loss = checked(...)   # raises, naming the output, on NaN or Inf
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


def _leaves(tree, path=""):
    """(path, leaf) pairs of nested dicts, lists and tuples, the paths
    written as ``jax.tree_util.keystr`` writes them (``['a'][0]``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_all_finite(tree, name: str = "tree") -> None:
    """Check that every leaf (tensor, array or number) of a state dict or
    of nested dicts, lists and tuples is finite; raises FloatingPointError
    with the reference's message, naming the first leaf that is not."""
    for path, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().float().cpu().numpy()
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.inexact):
            continue
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in {name}{path}: "
                f"{np.isnan(arr).sum()} NaN / {np.isinf(arr).sum()} Inf "
                f"of {arr.size}"
            )


def checked_fn(fn: Callable) -> Callable:
    """``fn`` whose floating-point outputs are checked for NaN and Inf
    after each call (``assert_all_finite``, the outputs named
    ``<fn> output``); a non-finite output raises FloatingPointError."""
    name = getattr(fn, "__name__", "fn")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_all_finite(out, f"{name} output")
        return out

    return wrapper
