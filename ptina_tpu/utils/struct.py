'''
Immutable pytree dataclasses.

`dataclass` makes a frozen dataclass and registers it with
jax.tree_util, so instances pass through jit, grad, vmap and shard_map.
Fields declared with `static_field` are part of the tree STRUCTURE
(hashable Python values such as tuples, ints or strings): changing one
retraces, and trace-time code may branch on it.  `.replace(**kw)` returns
a copy with some fields changed.
'''

import dataclasses

import jax

__all__ = ['dataclass', 'static_field']


def static_field(default=dataclasses.MISSING):
    '''A field kept in the pytree structure instead of its leaves.'''
    return dataclasses.field(default=default, metadata={'static': True})


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get('static')],
        meta_fields=[f.name for f in fields if f.metadata.get('static')])
    cls.replace = _replace
    return cls
