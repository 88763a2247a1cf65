"""Small shared utilities: the pytree sizes of the dry run.

Counterpart of the reference package's ``utils/__init__.py``, for the
helpers the port uses; a tree is nested dicts, lists and tuples of
tensors (anything with ``shape`` and ``dtype``; meta tensors count at the
size they stand for).
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.nets import tree_leaves

Pytree = Any


def tree_bytes(tree: Pytree) -> int:
    """Total bytes of all array leaves."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if hasattr(x, "dtype"))


def tree_count(tree: Pytree) -> int:
    """Total number of scalar parameters."""
    return sum(x.numel() for x in tree_leaves(tree) if hasattr(x, "shape"))
