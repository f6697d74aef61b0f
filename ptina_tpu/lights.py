'''
Analytic lights (point spheres / area rects) and the environment light.

SoA counterparts of the reference LightPool
(ptina/light/__init__.py:51-121) and WorldLight (ptina/light/world.py).

Structure: the light pool capacity L is a static shape and small (<= 64,
typically 8), so the per-light tests are UNROLLED at trace time into
pure elementwise [N]-row arithmetic — the wavefront analogue of the
reference's in-kernel `for l in range(count)` loop.  No [N, L]
intermediates, no minor-axis reductions, no gathers: everything fuses
into the surrounding integrator.  Per-light constants are extracted with
host-side indexing on the tiny [L] tables (XLA folds them to scalars).
'''

import jax.numpy as jnp

from ptina_tpu.utils.mathutils import EPS, INF, safe_sqrt
from ptina_tpu.utils.vec import V3, vdot, vnormalize, vcross, vwhere, vspherical
from ptina_tpu.scene import LIGHT_POINT, LIGHT_AREA
from ptina_tpu.texture import sample_texture

__all__ = ['lights_hit', 'lights_sample', 'world_at',
           'ray_sphere', 'ray_rect']


def _slot_v3(table, l):
    '''Row l of a tiny [L, 3] table as a V3 of scalars.'''
    return V3(table[l, 0], table[l, 1], table[l, 2])


def ray_sphere(ro, rd, center, radius2):
    '''Nearest positive sphere hit distance, 0.0 on miss
    (reference: ptina/geometries.py:158-178).  All args V3 / scalar rows.
    This is THE sphere primitive (tests hit it directly) — the one
    implementation of the reference's Sphere.intersect.'''
    op = center - ro
    b = vdot(op, rd)
    det = b * b + radius2 - vdot(op, op)
    sq = safe_sqrt(det)
    t_near = b - sq
    t_far = b + sq
    t = jnp.where(t_near > EPS, t_near, jnp.where(t_far > EPS, t_far, 0.0))
    return jnp.where(det >= 0.0, t, 0.0)


def ray_rect(ro, rd, pos, dirx, diry):
    '''One-sided rectangle test (reference: ptina/geometries.py:57-73).
    pos/dirx/diry: V3 of scalars.  Returns (hit mask, t).  The rect spans
    pos +/- dirx +/- diry, visible only where the ray faces its front
    (NoD > eps, the reference's one-sided Area semantics).'''
    nrm = vnormalize(vcross(dirx, diry))
    nod = vdot(nrm, rd)
    facing = nod > EPS
    t = vdot(nrm, pos - ro) / jnp.where(facing, nod, 1.0)
    p = ro + rd * t - pos
    u = vdot(p, dirx) / jnp.maximum(vdot(dirx, dirx), 1e-20)
    v = vdot(p, diry) / jnp.maximum(vdot(diry, diry), 1e-20)
    hit = facing & (jnp.abs(u) < 1.0) & (jnp.abs(v) < 1.0)
    return hit, jnp.where(hit, t, INF)


def lights_hit(lights, ro, rd):
    '''Direct-hit query against every light (reference hit(),
    ptina/light/__init__.py:51-81).  DELIBERATE DIVERGENCE: the
    reference scans slots in order and stops at the FIRST hit, so with
    overlapping lights a farther list-earlier light can occlude a nearer
    one; here the NEAREST hit wins (same op count: the running-min
    compare replaces the found-flag test); tests/test_lights_film.py
    covers the overlap case.
    ro, rd: V3 rows.  Returns dict(hit [N] bool, dis [N], pdf [N],
    color V3).'''
    L = lights.size.shape[0]
    n_sh = ro.x.shape

    found = jnp.zeros(n_sh, bool)
    dis = jnp.full(n_sh, INF)
    pdf = jnp.zeros(n_sh)
    color = V3(jnp.zeros(n_sh), jnp.zeros(n_sh), jnp.zeros(n_sh))

    has_pt = 'point' in lights.kinds
    has_ar = 'area' in lights.kinds
    for l in range(L):
        live = l < lights.count
        is_point = lights.type[l] == LIGHT_POINT
        is_area = lights.type[l] == LIGHT_AREA
        size = lights.size[l]
        pos = _slot_v3(lights.pos, l)

        # absent kinds drop their geometry at trace time (Lights.kinds)
        t_sph = ray_sphere(ro, rd, pos, size * size) if has_pt else 0.0
        if has_ar:
            dirx = _slot_v3(lights.axes[:, :, 0], l) * size
            diry = _slot_v3(lights.axes[:, :, 1], l) * size
            hit_rect, t_rect = ray_rect(ro, rd, pos, dirx, diry)
            t_ar = jnp.where(is_area & hit_rect, t_rect, 0.0)
        else:
            t_ar = 0.0
        if has_pt and has_ar:
            t = jnp.where(is_point, t_sph, t_ar)
        elif has_pt:
            t = jnp.where(is_point, t_sph, 0.0)
        else:
            t = t_ar
        area = jnp.where(is_point, jnp.pi * size * size, 4.0 * size * size)
        valid = live & (t > 0.0) & (t < dis)  # nearest wins (dis starts INF)

        dis = jnp.where(valid, t, dis)
        pdf = jnp.where(valid, t * t / jnp.maximum(area, 1e-12), pdf)
        color = vwhere(valid, _slot_v3(lights.color, l), color)
        found = found | valid

    return dict(hit=found, dis=dis, pdf=pdf, color=color)


def lights_sample(lights, hitpos, su, sv, sz):
    '''Next-event sample (reference sample()/_sample(),
    ptina/light/__init__.py:83-121).  hitpos: V3 rows; su/sv/sz: [N]
    uniforms (sz picks the light).  Returns dict(dis, dir V3, pdf,
    color V3) with color already divided by pdf and cosine-weighted for
    area lights, exactly like the reference.'''
    L = lights.size.shape[0]
    n_sh = hitpos.x.shape
    count = jnp.maximum(lights.count, 1)
    idx = jnp.clip((sz * count.astype(su.dtype)).astype(jnp.int32),
                   0, count - 1)

    zero = jnp.zeros(n_sh)
    litpos = V3(zero, zero, zero)
    nrm = V3(zero, zero, zero)
    area = zero
    color = V3(zero, zero, zero)
    is_area_sel = jnp.zeros(n_sh, bool)

    # point: surface point on the light sphere — the reference samples
    # spherical(samp.x, ...) whose z >= 0, i.e. the +z hemisphere
    # (light/__init__.py:97-100); kept verbatim for parity.  The trig
    # is skipped at trace time when no point light exists (Lights.kinds).
    has_pt = 'point' in lights.kinds
    has_ar = 'area' in lights.kinds
    disp_pt = vspherical(su, sv) if has_pt else None
    lx = su * 2.0 - 1.0
    ly = sv * 2.0 - 1.0

    for l in range(L):
        sel = idx == l
        size = lights.size[l]
        pos = _slot_v3(lights.pos, l)
        is_area = lights.type[l] == LIGHT_AREA

        lp_pt = pos + disp_pt * size if has_pt else None
        ax_x = _slot_v3(lights.axes[:, :, 0], l)
        ax_y = _slot_v3(lights.axes[:, :, 1], l)
        ax_z = _slot_v3(lights.axes[:, :, 2], l)
        lp_ar = pos + (ax_x * lx + ax_y * ly) * size if has_ar else None

        if has_pt and has_ar:
            lp = vwhere(is_area, lp_ar, lp_pt)
        else:
            z = 0.0 * lx
            lp = lp_ar if has_ar else (lp_pt if has_pt
                                       else pos + V3(z, z, z))
        ar = jnp.where(is_area, 4.0 * size * size, jnp.pi * size * size)
        nr = vwhere(is_area, ax_z, 0.0)

        litpos = vwhere(sel, lp, litpos)
        nrm = vwhere(sel, nr, nrm)
        area = jnp.where(sel, ar, area)
        color = vwhere(sel, _slot_v3(lights.color, l), color)
        is_area_sel = jnp.where(sel, is_area, is_area_sel)

    toli = litpos - hitpos
    dis = jnp.maximum(safe_sqrt(vdot(toli, toli)), 1e-12)
    direction = toli * (1.0 / dis)
    pdf = dis * dis / jnp.maximum(area, 1e-12)
    out_color = color * (1.0 / pdf)
    cosine = jnp.maximum(0.0, vdot(nrm, direction))
    out_color = vwhere(is_area_sel, out_color * cosine, out_color)

    empty = lights.count == 0
    return dict(
        dis=jnp.where(empty, INF, dis),
        dir=vwhere(empty, 0.0, direction),
        pdf=jnp.where(empty, 0.0, pdf),
        color=vwhere(empty, 0.0, out_color),
    )


def world_at(scene, rd):
    '''Environment radiance for V3 directions rd (reference
    WorldLight.at, ptina/light/world.py:22-29, including the blender axis
    swizzle for the equirect lookup).  Returns V3.'''
    fac = scene.world_fac
    no_atlas = (scene.textures.data.shape[1] == 1
                and scene.textures.data.shape[2] == 1)
    if no_atlas or not scene.world_textured:
        # statically constant environment (no atlas, or scene built with
        # world_tex == -1): the equirect fetch and its arctan2s would be
        # dead per-bounce work; skip at trace time
        one = jnp.ones_like(rd.x)
        return V3(fac[0] * one, fac[1] * one, fac[2] * one)
    textured = scene.world_tex >= 0
    texid = jnp.maximum(scene.world_tex, 0)
    from ptina_tpu.utils.vec import vdir2tex
    d = V3(rd.x, rd.z, -rd.y)
    s, t = vdir2tex(d)
    tex = sample_texture(scene.textures, jnp.full(rd.x.shape, texid), s, t)
    texv = V3(tex[..., 0], tex[..., 1], tex[..., 2])
    const = V3.full_like(rd, (fac[0], fac[1], fac[2]))
    return vwhere(textured, texv * const, const)
