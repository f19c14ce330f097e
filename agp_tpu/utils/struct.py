"""Immutable dataclass pytrees.

`PyTreeNode` subclasses become frozen dataclasses registered with
`jax.tree_util`: fields are pytree leaves unless declared with
`field(pytree_node=False)`, which makes them static (part of the treedef,
hence of every jit cache key).  `replace(**updates)` returns a copy.
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

import jax

T = TypeVar("T", bound="PyTreeNode")


def field(pytree_node: bool = True, *, metadata=None, **kwargs):
    """`dataclasses.field` with a `pytree_node` flag (False: static)."""
    return dataclasses.field(
        metadata={**(metadata or {}), "pytree_node": pytree_node}, **kwargs
    )


class PyTreeNode:
    """Base class: subclasses are frozen dataclasses and pytree nodes."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        data, meta = [], []
        for f in dataclasses.fields(cls):
            (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
        jax.tree_util.register_dataclass(cls, data, meta)

    def replace(self: T, **updates) -> T:
        return dataclasses.replace(self, **updates)
