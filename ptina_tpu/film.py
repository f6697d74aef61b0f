'''
Progressive film: [passes, 4, nx, ny] accumulator where channel 3 (.w)
counts samples.

Functional counterpart of the reference FilmTable (ptina/filmtable.py):
render steps return a new film value; `film_to_image` divides rgb by the
sample count and paints empty pixels debug-pink (filmtable.py:52-63).
Pass ids: 0 = Combined, 1 = Albedo, 2 = Normal (reference
blender.py:591-595, things.py:19).

Layout: channel-major ([P, 4, nx, ny], NOT [P, nx, ny, 4]) so each
channel is a dense pixel plane and the integrator's SoA radiance rows
(utils/vec.py) accumulate into it without an interleave.
'''

import jax
import jax.numpy as jnp

__all__ = ['new_film', 'film_add', 'film_splat', 'film_to_image',
           'film_to_flat_rgb', 'PASS_COMBINED', 'PASS_ALBEDO', 'PASS_NORMAL']

PASS_COMBINED = 0
PASS_ALBEDO = 1
PASS_NORMAL = 2

DEBUG_PINK = (0.9, 0.4, 0.9, 0.0)


def new_film(nx, ny, passes=3):
    return jnp.zeros((passes, 4, nx, ny), jnp.float32)


def film_add(film, pass_id, r, g, b, w):
    '''Add per-pixel contributions into one pass.  r/g/b/w: [nx, ny]
    (or [nx*ny], reshaped here).'''
    nx, ny = film.shape[2], film.shape[3]
    rgbw = jnp.stack([x.reshape(nx, ny) for x in (r, g, b, w)])
    return film.at[pass_id].add(rgbw)


def film_splat(film, pass_id, xi, yi, r, g, b, w):
    '''Scatter-add arbitrary splats (for MLT): xi, yi [N] int pixel
    coords, r/g/b/w [N].  Replaces the reference's racing atomic adds
    (ptina/engine/mltpath.py:47-52) with a deterministic scatter-add.'''
    nx, ny = film.shape[2], film.shape[3]
    xi = jnp.clip(xi, 0, nx - 1)
    yi = jnp.clip(yi, 0, ny - 1)
    # advanced indices (xi, yi) separated by the `:` slice are moved to
    # the front of the result, so the update operand is [N, 4]
    rgbw = jnp.stack([r, g, b, w], axis=-1)
    return film.at[pass_id, :, xi, yi].add(rgbw)


def film_to_image(film, pass_id=0):
    '''Normalize a pass to an [nx, ny, 4] image; empty pixels become the
    reference's debug pink (filmtable.py:61).'''
    val = film[pass_id].transpose(1, 2, 0)  # [nx, ny, 4]
    w = val[..., 3:4]
    has = w != 0.0
    rgb = jnp.where(has, val[..., :3] / jnp.where(has, w, 1.0), 0.0)
    out = jnp.concatenate([rgb, jnp.where(has, 1.0, 0.0)], axis=-1)
    pink = jnp.asarray(DEBUG_PINK, val.dtype)
    return jnp.where(has, out, pink)


@jax.jit
def film_to_flat_rgb(film, pass_id=0):
    '''Device-side viewport export: normalize pass `pass_id` and return
    a flat [ny*nx*3] f32 buffer in scanline (y-major) order — ONE fused
    kernel + one readback, the counterpart of the reference's
    fast_export_image kernel (ptina/filmtable.py:65-79).  Empty pixels
    export 0 (the GL blit path wants black, not debug pink).'''
    val = film[pass_id]                      # [4, nx, ny]
    w = val[3]
    has = w != 0.0
    rgb = jnp.where(has[None], val[:3] / jnp.where(has, w, 1.0)[None], 0.0)
    return rgb.transpose(2, 1, 0).reshape(-1)  # [ny, nx, 3] scanlines
