"""Frozen tensor dataclasses with static fields.

``@tensor_dataclass`` makes a frozen dataclass with a ``replace`` method.
Fields marked with ``static_field()`` describe the layout (widths, counts,
Python ints) and never change after ``create``; every other field holds a
tensor or a nested tensor dataclass.  ``repro_torch.interop`` walks the two
kinds apart to exchange state with the JAX package, whose pytree dataclasses
mark static fields with the same metadata key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

T = TypeVar("T")

STATIC_MARK = "__repro_static__"


def static_field(**kwargs: Any) -> Any:
    """A dataclass field that is part of the layout, not of the state."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata[STATIC_MARK] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def is_static(field: dataclasses.Field) -> bool:
    return bool(field.metadata.get(STATIC_MARK, False))


def tensor_dataclass(cls: type[T]) -> type[T]:
    """Make ``cls`` a frozen dataclass with ``replace(**updates)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self: T, **updates: Any) -> T:
        return dataclasses.replace(self, **updates)

    cls.replace = replace  # type: ignore[attr-defined]
    return cls


def tree_size_bytes(tree: Any) -> int:
    """Total bytes of the tensors (and numpy arrays) in ``tree``: a tensor
    dataclass (its static fields hold none), or a dict, list or tuple of
    them, nested to any depth.  The bytes are those the tensors hold: the
    port keeps hash parameters as int64, so a sketch's ``HashFamily``
    counts 8 bytes a value where the JAX package's uint32 counts 4."""
    if tree is None:
        return 0
    if hasattr(tree, "element_size"):  # a tensor
        return tree.numel() * tree.element_size()
    if hasattr(tree, "nbytes"):  # a numpy array
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tree_size_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree) if not is_static(f))
    return 0
