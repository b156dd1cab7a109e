"""Frozen pytree dataclasses.

`dataclass` turns a class into a frozen dataclass registered with
``jax.tree_util.register_dataclass``, so instances pass through `jit`,
`vmap`, `lax.while_loop` carries and shardings like any pytree. Fields are
pytree children (traced arrays) unless declared ``field(pytree_node=False)``:
those ride in the treedef as static metadata, so they must be hashable, and a
change of value is a different program to `jit`. ``obj.replace(**kw)``
returns a copy with the named fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Frozen dataclass + pytree registration (see module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)])
    cls.replace = _replace
    return cls
