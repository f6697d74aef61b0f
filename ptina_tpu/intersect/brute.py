'''
Dense ray-triangle intersection in plain XLA: the reference cast.

The reference traverses a BVH per thread with a 32-deep stack
(reference: ptina/tree/lbvh.py:313-347, ptina/stack.py).  This module
casts every ray against every triangle instead, as dense array work with
no per-ray control flow.  It runs on the CPU, where it is the renderer's
cast, and it is the plain reference that the GPU kernels
(intersect/triton_cast.py) are tested against.

Each triangle is precompiled (scene.precompute_tri_functionals) to a 3x4
matrix M whose rows are affine functionals of a homogeneous point:
    M [p, 1]^T = [ n.p - n.v0 ,  u(p) ,  v(p) ]
with n the unit face normal and u/v barycentric coordinates.
For a ray o + t d:
    a = M [o, 1]^T      b = M [d, 0]^T
    t = -a0 / b0        u = a1 + t b1       v = a2 + t b2
so one cast over N rays and F triangles is two [N, 4] @ [4, 3F]
products, at full float32 precision (Precision.HIGHEST: a TF32 product
keeps about three decimal digits of the plane offsets and barycentrics),
followed by elementwise tests and a masked min-reduction over F.
Triangles are processed in tiles with a running (t, index, uv) minimum to
bound the [N, 3*TILE] intermediate.

Hit semantics match the reference Face.intersect + BVH loop
(ptina/geometries.py:117-148, lbvh.py:313-347): strict t > 0, barycentrics
in the closed unit triangle, `avoid` face excluded, nearest hit wins.
'''

from __future__ import annotations

import functools

from ptina_tpu.utils import struct
import jax
import jax.numpy as jnp

from ptina_tpu.utils.mathutils import EPS, INF
from ptina_tpu.utils.vec import V3

__all__ = ['Hit', 'cast_closest', 'cast_any', 'TILE_F']

TILE_F = 512  # triangles per tile; [N, 3*TILE_F] f32 intermediate
HIGHEST = jax.lax.Precision.HIGHEST


@struct.dataclass
class Hit:
    hit: jnp.ndarray    # [N] bool
    t: jnp.ndarray      # [N] f32 (INF on miss)
    index: jnp.ndarray  # [N] i32 (-1 on miss)
    u: jnp.ndarray      # [N] f32 barycentric weight of v1
    v: jnp.ndarray      # [N] f32 barycentric weight of v2


def _homog(ro, rd):
    '''V3 rays -> homogeneous [N, 4] row matrices for the cast matmul.'''
    one = jnp.ones_like(ro.x)
    zero = jnp.zeros_like(one)
    return (jnp.stack([ro.x, ro.y, ro.z, one], axis=-1),
            jnp.stack([rd.x, rd.y, rd.z, zero], axis=-1))


def _pad_tiles(tri_w2b, tile):
    '''Pad the triangle table to a tile multiple with all-zero rows
    (degenerate functionals are rejected by the |denom| >= EPS test).'''
    f = tri_w2b.shape[0]
    fpad = -f % tile
    if fpad:
        tri_w2b = jnp.pad(tri_w2b, ((0, fpad), (0, 0), (0, 0)))
    return tri_w2b, f + fpad


def _tile_test(o4, d4, m_tile, base, avoid):
    '''Test all rays against one triangle tile.
    o4, d4: [N, 4]; m_tile: [TF, 3, 4]; returns (t [N, TF], u, v).'''
    tf = m_tile.shape[0]
    mt = m_tile.reshape(tf * 3, 4).T  # [4, 3*TF]
    a = jnp.dot(o4, mt, precision=HIGHEST).reshape(-1, tf, 3)
    b = jnp.dot(d4, mt, precision=HIGHEST).reshape(-1, tf, 3)
    denom = b[..., 0]
    live = jnp.abs(denom) >= EPS
    t = -a[..., 0] / jnp.where(live, denom, 1.0)
    u = a[..., 1] + t * b[..., 1]
    v = a[..., 2] + t * b[..., 2]
    ids = base + jnp.arange(tf, dtype=jnp.int32)
    valid = (live & (t > 0.0)
             & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (ids[None, :] != avoid[:, None]))
    return jnp.where(valid, t, INF), u, v


@functools.partial(jax.jit, static_argnames=('tile',))
def cast_closest(ro, rd, tri_w2b, avoid, tile=TILE_F):
    '''Nearest-hit cast.  ro, rd: V3 of [N] rows (rd normalized); tri_w2b:
    [F, 3, 4] (F padded so degenerate padding rows never hit);
    avoid: [N] i32 face index to skip (-1 = none).'''
    n = ro.x.shape[0]
    tile = min(tile, tri_w2b.shape[0])
    tri_w2b, f = _pad_tiles(tri_w2b, tile)
    o4, d4 = _homog(ro, rd)

    def body(carry, m_tile_base):
        m_tile, base = m_tile_base
        tbest, ibest, uvbest = carry
        t, u, v = _tile_test(o4, d4, m_tile, base, avoid)
        j = jnp.argmin(t, axis=-1)  # [N]
        tmin = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
        umin = jnp.take_along_axis(u, j[:, None], axis=-1)[:, 0]
        vmin = jnp.take_along_axis(v, j[:, None], axis=-1)[:, 0]
        better = tmin < tbest
        tbest = jnp.where(better, tmin, tbest)
        ibest = jnp.where(better, base + j.astype(jnp.int32), ibest)
        uvbest = jnp.where(better[:, None], jnp.stack([umin, vmin], -1), uvbest)
        return (tbest, ibest, uvbest), None

    tiles = tri_w2b.reshape(f // tile, tile, 3, 4)
    bases = jnp.arange(f // tile, dtype=jnp.int32) * tile
    init = (jnp.full((n,), INF), jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n, 2)))
    (t, idx, uv), _ = jax.lax.scan(body, init, (tiles, bases))
    return Hit(hit=t < INF, t=t, index=idx, u=uv[:, 0], v=uv[:, 1])


@functools.partial(jax.jit, static_argnames=('tile',))
def cast_any(ro, rd, tri_w2b, avoid, tmax, tile=TILE_F):
    '''Occlusion cast: True where any triangle (except avoid) is hit at
    0 < t < tmax.  Used for shadow rays (reference: ptina/engine/path.py:50-51
    tests occ.depth > li.dis).'''
    tile = min(tile, tri_w2b.shape[0])
    tri_w2b, f = _pad_tiles(tri_w2b, tile)
    o4, d4 = _homog(ro, rd)

    def body(occ, m_tile_base):
        m_tile, base = m_tile_base
        t, _, _ = _tile_test(o4, d4, m_tile, base, avoid)
        # clamp tmax to the far clip: t >= INF is a miss (cast_closest's
        # t < INF hit test) and must not occlude for any tmax
        tm = jnp.minimum(tmax, INF)
        return occ | jnp.any(t < tm[:, None], axis=-1), None

    tiles = tri_w2b.reshape(f // tile, tile, 3, 4)
    bases = jnp.arange(f // tile, dtype=jnp.int32) * tile
    occ, _ = jax.lax.scan(body, jnp.zeros(ro.x.shape[0], bool), (tiles, bases))
    return occ
