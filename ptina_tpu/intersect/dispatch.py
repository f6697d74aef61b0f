'''
Ray casts, routed by platform.

Every cast of the renderer goes through this module.  The implementation
is picked at trace time from the platform the computation is compiled
for, so each jit cache entry gets its own and pays nothing at run time:

  gpu   -> the Pallas kernels of intersect/triton_cast.py;
  cpu   -> intersect/brute.py, the plain XLA cast, which is also the
           reference the kernels are tested against;
  other -> an error: there is no silent fallback.

Rays are detached before the cast.  Intersections are constants of the
estimator (engine/path._cast_and_shade), and the kernels have no VJP.

All entry points speak SoA: rays are V3 component rows, results are
dense [N] rows.
'''

import jax
import jax.numpy as jnp

from ptina_tpu.utils.vec import V3, vnormalize
from ptina_tpu.intersect import brute
from ptina_tpu.intersect.triton_cast import (triton_cast_closest,
                                             triton_cast_any)

__all__ = ['cast_closest', 'cast_any', 'cast_shaded', 'cast_shadow']


def _casts():
    '''(closest, any) cast functions for the current platform.'''
    platform = jax.default_backend()
    if platform == 'gpu':
        return triton_cast_closest, triton_cast_any
    if platform == 'cpu':
        return brute.cast_closest, brute.cast_any
    raise NotImplementedError(f'no ray cast for platform {platform!r}')


def _rays(ro, rd):
    ro = ro if isinstance(ro, V3) else V3.from_array(jnp.asarray(ro))
    rd = rd if isinstance(rd, V3) else V3.from_array(jnp.asarray(rd))
    return jax.lax.stop_gradient((ro, rd))


def cast_closest(ro, rd, tri_w2b, avoid):
    '''Nearest hit (brute.cast_closest's contract) on the platform's cast.'''
    ro, rd = _rays(ro, rd)
    return _casts()[0](ro, rd, tri_w2b, avoid)


def cast_any(ro, rd, tri_w2b, avoid, tmax):
    '''Occlusion (brute.cast_any's contract) on the platform's cast.'''
    ro, rd = _rays(ro, rd)
    return _casts()[1](ro, rd, tri_w2b, avoid, jax.lax.stop_gradient(tmax))


def cast_shadow(scene, ro, rd, avoid, tmax):
    '''Occlusion of shadow rays against the scene's faces.'''
    return cast_any(ro, rd, scene.tri_w2b, avoid, tmax)


def cast_shaded(scene, ro, rd, avoid):
    '''Closest hit + shading attributes.  Returns (hit, normal V3 unit
    (not yet two-sided-flipped), tex_s [N], tex_t [N], mtlid [N] i32
    (-1 on miss)).  The winner's attributes are gathered and
    interpolated here, after the cast.'''
    hit = cast_closest(ro, rd, scene.tri_w2b, avoid)
    idx = jnp.maximum(hit.index, 0)
    w0 = 1.0 - hit.u - hit.v
    nrm = scene.tri_nrm[idx]  # [N, 3, 3]
    uv = scene.tri_uv[idx]
    normal = vnormalize(V3.from_array(
        nrm[:, 0] * w0[:, None] + nrm[:, 1] * hit.u[:, None]
        + nrm[:, 2] * hit.v[:, None]))
    tex = (uv[:, 0] * w0[:, None] + uv[:, 1] * hit.u[:, None]
           + uv[:, 2] * hit.v[:, None])
    mtlid = jnp.where(hit.hit, scene.tri_mtl[idx], -1)
    return hit, normal, tex[:, 0], tex[:, 1], mtlid
