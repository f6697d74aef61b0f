'''The in-repo pytree dataclass (utils/struct.py) behind Scene, V3, Hit
and the MLT state.'''

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from ptina_tpu.utils import struct


@struct.dataclass
class Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    tag: str = struct.static_field('x')


def test_leaves_and_static_fields():
    p = Pair(jnp.ones(2), jnp.zeros(3), tag='y')
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 2
    q = jax.tree.unflatten(treedef, leaves)
    assert q.tag == 'y'
    # a static field is part of the structure, not a leaf
    assert treedef != jax.tree.structure(p.replace(tag='z'))


def test_replace_and_frozen():
    p = Pair(jnp.ones(2), jnp.zeros(3))
    q = p.replace(b=jnp.ones(3))
    assert float(q.b.sum()) == 3.0 and float(p.b.sum()) == 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(2)


def test_through_jit_and_grad():
    @jax.jit
    def f(p):
        return jnp.sum(p.a * p.b) if p.tag == 'x' else 0.0
    p = Pair(jnp.arange(3.0), jnp.full(3, 2.0))
    assert float(f(p)) == 6.0
    g = jax.grad(f)(p)
    assert isinstance(g, Pair) and g.tag == 'x'
    assert jnp.allclose(g.a, 2.0) and jnp.allclose(g.b, jnp.arange(3.0))
