'''
SoA 3-vectors: the vector representation of the hot path.

Why not [N, 3] arrays (reference Taichi vectors, ptina/common.py:32-120):
every dot product on an [N, 3] array is a reduce over its minor axis of
size 3, which breaks XLA's elementwise fusions and strides every access.

`V3` stores x/y/z as three independent dense [N]-shaped rows.  All vector
algebra (dot, cross, normalize, reflect, refract, frames) is then pure
elementwise arithmetic that XLA fuses end-to-end.  V3 is a pytree
(utils/struct.py), so it passes through jit/grad/shard_map and jax.tree
utilities transparently.
'''

from __future__ import annotations

from ptina_tpu.utils import struct
import jax.numpy as jnp

from ptina_tpu.utils.mathutils import EPS, TAU, safe_sqrt

__all__ = ['V3', 'v3', 'vdot', 'vdot_or_zero', 'vnorm', 'vnormalize',
           'vcross', 'vlerp', 'vwhere', 'vavg3', 'vreflect', 'vrefract',
           'vtanframe', 'vspherical', 'vdir2tex']


@struct.dataclass
class V3:
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- algebra (scalar operands broadcast over all components) --
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- conversions --
    @classmethod
    def from_array(cls, a):
        '''[..., 3] -> V3 of [...] components.'''
        return cls(a[..., 0], a[..., 1], a[..., 2])

    @classmethod
    def full_like(cls, ref, vals):
        '''Broadcast a constant 3-sequence to the shape of `ref` (a V3).'''
        vx, vy, vz = vals
        return cls(jnp.full_like(ref.x, vx), jnp.full_like(ref.y, vy),
                   jnp.full_like(ref.z, vz))

    def to_array(self):
        '''V3 -> [..., 3] (use only at cold boundaries / tests).'''
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @property
    def shape(self):
        return jnp.shape(self.x)


def v3(x, y, z):
    return V3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vdot_or_zero(a: V3, b: V3):
    return jnp.maximum(0.0, vdot(a, b))


def vnorm(a: V3):
    return safe_sqrt(vdot(a, a))


def vnormalize(a: V3, eps=1e-12):
    inv = 1.0 / jnp.maximum(vnorm(a), eps)
    return a * inv


def vcross(a: V3, b: V3):
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def vlerp(fac, src, dst):
    return src * (1.0 - fac) + dst * fac


def vwhere(mask, a, b):
    '''Component-wise select; a/b may be V3 or scalars.'''
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, V3) else (b, b, b)
    return V3(jnp.where(mask, ax, bx), jnp.where(mask, ay, by),
              jnp.where(mask, az, bz))


def vavg3(a: V3):
    return (a.x + a.y + a.z) * (1.0 / 3.0)


def vreflect(i: V3, n: V3):
    '''Mirror i around n (reference: ptina/common.py:247-249).'''
    return i - n * (2.0 * vdot(n, i))


def vrefract(i: V3, n: V3, eta):
    '''Snell refraction (reference: ptina/common.py:252-260).
    Returns (has_refract mask, unit direction V3; zeros on TIR).'''
    noi = vdot(n, i)
    discr = 1.0 - eta * eta * (1.0 - noi * noi)
    has = discr > 0.0
    t = i * eta - n * (eta * noi + safe_sqrt(discr))
    t = vnormalize(t)
    return has, vwhere(has, t, 0.0)


def vtanframe(nrm: V3, up=(233.0, 666.0, 512.0)):
    '''Tangent frame (tan, bitan) vectors for a unit normal
    (reference: ptina/common.py:213-217).'''
    upv = V3.full_like(nrm, up)
    bitan = vnormalize(vcross(nrm, upv))
    tan = vcross(bitan, nrm)
    return tan, bitan


def vspherical(h, p):
    '''Direction from cos-elevation h and turn fraction p
    (reference: ptina/common.py:221-225).'''
    r = safe_sqrt(1.0 - h * h)
    ang = p * TAU
    return V3(r * jnp.cos(ang), r * jnp.sin(ang), h)


def vdir2tex(d: V3):
    '''Equirectangular direction -> (s, t) (reference common.py:234-239).'''
    d = vnormalize(d)
    s = jnp.arctan2(d.z, d.x) / jnp.pi * 0.5 + 0.5
    t = jnp.arctan2(d.y, safe_sqrt(d.x * d.x + d.z * d.z)) / jnp.pi + 0.5
    return s, t
