'''
Unidirectional path integrator with multiple importance sampling.

Wavefront counterpart of the reference megakernel
(reference: ptina/engine/path.py:17-93): instead of one divergent
per-pixel loop, the whole [N]-ray batch advances bounce-by-bounce with
alive masks.  Per bounce: closest cast -> direct light hit (MIS against
the previous BSDF pdf) -> env light on miss -> next-event estimation
(light sample + shadow cast + BSDF eval + MIS) -> BSDF bounce.
Max depth 5 and the pdf ~ Vavg(brdf color) MIS approximation are kept
from the reference (path.py:25, path.py:53).

Data layout: everything in the bounce loop is SoA — rays, normals and
colors are V3 component rows, uniforms are dimension-major [D, N] — so
the whole bounce body is elementwise arithmetic XLA fuses end-to-end
(see utils/vec.py).

Random-number contract: each path consumes a fixed [PATH_DIMS, N]
uniform block (2 lens dims + 6 per bounce), supplied by the caller.
This is what lets the same `path_trace` serve the Sobol sampler, plain
RNG and the MLT chain replay (reference RNGProxy,
ptina/sampling/__init__.py:53-64).
'''

import functools

import jax
import jax.numpy as jnp

from ptina_tpu.utils.mathutils import EPS, INF, clamp
from ptina_tpu.utils.vec import V3, vdot, vdot_or_zero, vnormalize, vwhere, vavg3
from ptina_tpu.camera import camera_rays
from ptina_tpu.intersect.dispatch import cast_shadow, cast_shaded
from ptina_tpu.lights import lights_hit, lights_sample, world_at
from ptina_tpu.mtllib import fetch_material
from ptina_tpu.materials.simple import bsdf_eval, bsdf_sample
from ptina_tpu.sampling.sobol import sample_dims, pixel_rotation
from ptina_tpu.film import film_add

__all__ = ['MAX_DEPTH', 'PATH_DIMS', 'power_heuristic',
           'path_trace', 'render_sample', 'render']

MAX_DEPTH = 5         # reference: ptina/engine/path.py:25
PATH_DIMS = 2 + 6 * MAX_DEPTH  # = 32, the reference MLT dim count


def power_heuristic(a, b):
    '''Squared power heuristic (reference: ptina/engine/path.py:10-14).'''
    a = clamp(a, EPS, INF) ** 2
    b = clamp(b, EPS, INF) ** 2
    return a / (a + b)


def _cast_and_shade(scene, ro, rd, avoid):
    '''Closest cast + surface attributes (intersect/dispatch.cast_shaded).
    Mirrors the reference
    ModelPool.get_geometries (ptina/model.py:88-101): smooth normal,
    two-sided flip, texcoord, material fetch.

    Hit results are detached (stop_gradient): gradients flow through
    shading evaluated at fixed hit points, not through the discrete
    intersection — the estimator design required for clean material /
    texture derivatives (see BASELINE.md north star).'''
    hit, normal, tex_s, tex_t, mtlid = cast_shaded(scene, ro, rd, avoid)
    hit = jax.tree.map(jax.lax.stop_gradient, hit)
    normal = jax.lax.stop_gradient(normal)
    tex_s = jax.lax.stop_gradient(tex_s)
    tex_t = jax.lax.stop_gradient(tex_t)
    hitpos = ro + rd * hit.t
    sign = -vdot(rd, normal)
    normal = vwhere(sign < 0, -normal, normal)
    material = fetch_material(scene, mtlid, tex_s, tex_t)
    return hit, hitpos, normal, sign, material


def _bounce(scene, carry, u, model='disney'):
    '''One wavefront bounce: the body the reference runs per iteration of
    its in-kernel depth loop (ptina/engine/path.py:25-62).  carry is the
    per-lane path state; u is this bounce's [6, N] uniform rows
    (3 for the light sample, 3 for the BSDF sample).  model selects the
    BSDF at trace time ('disney' | 'lambert' | 'mirror' | 'phong',
    materials/simple.MATERIAL_MODELS).'''
    ro, rd, throughput, result, last_brdf_pdf, avoid, alive = carry
    rd = vnormalize(rd)
    hit, hitpos, normal, sign, material = _cast_and_shade(scene, ro, rd, avoid)

    # direct light hit with MIS (reference path.py:31-35)
    lit = lights_hit(scene.lights, ro, rd)
    lit_vis = lit['hit'] & (~hit.hit | (lit['dis'] < hit.t))
    mis = power_heuristic(last_brdf_pdf, lit['pdf'])
    result = result + vwhere(alive & lit_vis,
                             throughput * lit['color'] * mis, 0.0)

    # environment light on miss, then the lane dies (path.py:37-39)
    miss = ~hit.hit
    result = result + vwhere(alive & miss,
                             throughput * world_at(scene, rd), 0.0)

    live = alive & ~miss

    # next-event estimation (path.py:48-56).  Lanes with no surface hit
    # get a PARKED degenerate shadow ray (origin 0, +z, tmax 0): their
    # NEE is masked out below either way, and a zero tmax keeps their
    # hitpos = ro + INF*rd (at +-1e6) out of the cast.
    li = lights_sample(scene.lights, hitpos, u[0], u[1], u[2])
    ro_sh = vwhere(hit.hit, hitpos, 0.0)
    rd_sh = vwhere(hit.hit, li['dir'], V3.full_like(hitpos, (0, 0, 1)))
    tmax_sh = jnp.where(hit.hit, li['dis'], 0.0)
    occ = cast_shadow(scene, ro_sh, rd_sh, hit.index, tmax_sh)
    brdf_clr = bsdf_eval(model, material, normal, sign, -rd, li['dir'],
                         zero=scene.materials.zero)
    brdf_pdf = vavg3(brdf_clr)
    mis2 = power_heuristic(li['pdf'], brdf_pdf)
    nee = li['color'] * brdf_clr * (mis2 * vdot_or_zero(normal, li['dir']))
    nee_ok = live & ~occ & ((li['color'].x > 0.0) | (li['color'].y > 0.0)
                            | (li['color'].z > 0.0))
    result = result + vwhere(nee_ok, throughput * nee, 0.0)

    # BSDF bounce (path.py:58-62).  Dead lanes are PARKED on a
    # degenerate ray at the origin pointing +z (their radiance is
    # already final).
    outdir, pdf, color = bsdf_sample(model, material, normal, sign, -rd,
                                     u[3], u[4], u[5],
                                     zero=scene.materials.zero)
    throughput = vwhere(live, throughput * color, throughput)
    park = V3.full_like(hitpos, (0.0, 0.0, 1.0))
    ro = vwhere(live, hitpos, 0.0)
    rd = vwhere(live, outdir, park)
    avoid = jnp.where(live, hit.index, avoid)
    last_brdf_pdf = jnp.where(live, pdf, last_brdf_pdf)
    alive = live \
        & ((throughput.x > 0.0) | (throughput.y > 0.0)
           | (throughput.z > 0.0)) \
        & ((rd.x != 0.0) | (rd.y != 0.0) | (rd.z != 0.0))
    return (ro, rd, throughput, result, last_brdf_pdf, avoid, alive)


def path_trace(scene, ro, rd, uniforms, model='disney'):
    '''Trace [N] rays to completion.  ro, rd: V3 rows; uniforms:
    [2 + 6 * depth, N] with dims 0-1 reserved for the caller's lens
    jitter — the BOUNCE COUNT is carried by the uniform block's row
    count (config.max_depth flows in through render_sample).
    Returns radiance as a V3 of [N] rows.

    Bounces advance under lax.scan (not a Python unroll): every bounce
    is identical modulo its 6 uniform rows, so the XLA graph contains
    ONE bounce body instead of max_depth copies — this is what keeps
    wavefront compile times sane (a 5x unroll of cast+shade+NEE made
    single renders take minutes of XLA:CPU compile).'''
    depth = (uniforms.shape[0] - 2) // 6
    n_sh = ro.x.shape
    zero = jnp.zeros(n_sh)
    result = V3(zero, zero, zero)
    one = jnp.ones(n_sh)
    throughput = V3(one, one, one)
    # last_brdf_pdf starts at INF, not 0: before the first bounce there
    # is no competing light-sampling strategy, so a directly-visible
    # emitter must be collected at full weight (power_heuristic(INF, .)
    # -> 1).  The reference initializes it to 0.0 (ptina/engine/
    # path.py:23), which weights first-hit emitters to ~0 and renders
    # them black — a bug this port fixes (caught by the brute-vs-path
    # cross-check in tests/test_parity.py).
    carry = (ro, rd, throughput, result, jnp.full(n_sh, INF),
             jnp.full(n_sh, -1, jnp.int32), jnp.ones(n_sh, bool))

    bounce_u = uniforms[2:2 + 6 * depth].reshape(
        (depth, 6) + uniforms.shape[1:])
    carry, _ = jax.lax.scan(
        lambda c, u: (_bounce(scene, c, u, model), None), carry, bounce_u)
    return carry[3]


def pixel_grid(nx, ny, x0=0, y0=0):
    '''Flattened global pixel-id rows [N] for an (nx, ny) film tile at
    offset (x0, y0) — the ij arguments of sampling.sobol.sample_dims.'''
    ii, jj = jnp.meshgrid(x0 + jnp.arange(nx), y0 + jnp.arange(ny),
                          indexing='ij')
    return ii.reshape(-1), jj.reshape(-1)


def render_sample(scene, film, sample_index, x0=0, y0=0, full_res=None,
                  model='disney', max_depth=MAX_DEPTH, rot=None):
    '''Accumulate one progressive sample over the film into pass 0
    (reference PathEngine.render/do_render, path.py:75-93).

    The film may be a tile/shard of a larger frame: x0/y0 are its global
    pixel offsets and full_res the full frame (nx, ny) — this one entry
    point serves whole-frame rendering, the reference's dormant tile
    renderer (path.py:95-128) and shard_map device sharding, because the
    NDC mapping and the per-pixel Sobol rotation only depend on global
    pixel ids.

    max_depth: bounce cap (config.max_depth; reference path.py:25).
    rot: optional precomputed per-pixel Cranley-Patterson rotation
    (see sample_dims) — pass it when calling in a per-sample loop.'''
    _, _, nx, ny = film.shape
    fnx, fny = full_res if full_res is not None else (nx, ny)
    ii, jj = pixel_grid(nx, ny, x0, y0)
    dims = 2 + 6 * max_depth
    u = sample_dims(sample_index, ii, jj, dims, rot=rot)
    x = (ii.astype(jnp.float32) + u[0]) / fnx * 2.0 - 1.0
    y = (jj.astype(jnp.float32) + u[1]) / fny * 2.0 - 1.0
    ro, rd = camera_rays(scene.cam_v2w, x, y)
    rad = path_trace(scene, ro, rd, u, model)
    return film_add(film, 0, rad.x, rad.y, rad.z, jnp.ones_like(rad.x))


@functools.partial(jax.jit, donate_argnames=('film',),
                   static_argnames=('model', 'spb', 'max_depth'))
def _render_step(scene, film, sample_index, model='disney', spb=1,
                 max_depth=MAX_DEPTH):
    '''One dispatch of `spb` samples: lax.scan over sample indices with
    the film as carry.  The sample body appears ONCE in the graph (scan,
    not unroll), so compile time is flat in spb while per-dispatch
    overhead divides by it.'''
    if spb == 1:
        return render_sample(scene, film, sample_index, model=model,
                             max_depth=max_depth)
    # the per-pixel rotation is sample-invariant: compute it ONCE per
    # dispatch, not per scanned sample (see sample_dims).
    _, _, nx, ny = film.shape
    ii, jj = pixel_grid(nx, ny)
    rot = pixel_rotation(ii, jj, 2 + 6 * max_depth)
    film, _ = jax.lax.scan(
        lambda f, s: (render_sample(scene, f, s, model=model,
                                    max_depth=max_depth, rot=rot), None),
        film, sample_index + jnp.arange(spb, dtype=jnp.int32))
    return film


SPB = 8  # samples per dispatch: overhead/8 while staying responsive


def render(scene, film, start_sample, spp=1, model='disney', spb=None,
           max_depth=MAX_DEPTH):
    '''Render `spp` progressive samples, batching `spb` samples into
    each device dispatch (None = auto: SPB when spp is a multiple,
    falling back to singles for the remainder).  The film is donated
    through the chain.'''
    if spb is None:
        spb = SPB
    start = jnp.asarray(start_sample, jnp.int32)
    s = 0
    while s < spp:
        step = spb if spp - s >= spb else 1
        film = _render_step(scene, film, start + s, model=model, spb=step,
                            max_depth=max_depth)
        s += step
    return film
