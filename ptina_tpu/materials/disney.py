'''
Disney principled BSDF with transmission, fully vectorized & branchless.

Semantics follow the reference implementation closely
(reference: ptina/materials/disney.py) but every data-dependent branch is
re-expressed as masked whole-array arithmetic: for sampling, all three
lobes (clearcoat / specular-with-transmission / diffuse) are evaluated on
every lane and the per-lane result selected by the stream-split decision
masks — the wavefront counterpart of the reference's `Choice` control
flow (disney.py:136-231, materials/__init__.py:21-48).

Representation: colors and directions are SoA V3 rows (see utils/vec.py);
the 11 scalar parameters are dense [..] rows.  Everything below is pure
elementwise arithmetic — one XLA fusion, no padded minor axes, no
reductions.  Derived quantities (tint/spec/sheen colors, alphas) mirror
the reference ctor (disney.py:41-50).

Numerical policy: every division is guarded *before* dividing (the
"double where" pattern) so unselected lanes stay finite — this is what
keeps jax.grad clean through the shader.
'''

import jax.numpy as jnp

from ptina_tpu.utils.mathutils import EPS, PI, lerp, safe_sqrt
from ptina_tpu.utils.vec import (
    V3, vdot, vdot_or_zero, vnormalize, vlerp, vwhere, vavg3, vreflect,
    vrefract, vtanframe, vspherical,
)
from ptina_tpu.materials import choice_split
from ptina_tpu.materials.microfacet import (
    schlick_fresnel, dielectric_fresnel, gtr1, gtr2, smith_ggx,
    sample_gtr1, sample_gtr2,
)

__all__ = ['disney_derive', 'disney_eval', 'disney_sample']


def _sd(num, den, eps=1e-8):
    '''Safe divide with pre-guarded denominator (autodiff friendly).'''
    mag = jnp.maximum(jnp.abs(den), eps)
    return num / jnp.where(den < 0, -mag, mag)


def disney_derive(p):
    '''Derived terms of the reference ctor (disney.py:41-50).
    p: dict with basecolor (V3 or [.., 3] array) and 11 scalar params [..].
    Returns a new dict with tintcolor/speccolor/sheencolor/alpha/ccalpha,
    basecolor normalized to V3.'''
    basecolor = p['basecolor']
    if not isinstance(basecolor, V3):
        basecolor = V3.from_array(jnp.asarray(basecolor))
    lum = 0.3 * basecolor.x + 0.6 * basecolor.y + 0.1 * basecolor.z
    inv_lum = 1.0 / jnp.maximum(lum, EPS)
    tint = vwhere(lum > EPS, basecolor * inv_lum, 1.0)
    mix = vlerp(p['specularTint'], V3.full_like(tint, (1.0, 1.0, 1.0)), tint)
    spec = vlerp(p['metallic'], mix * (p['specular'] * 0.08), basecolor)
    sheen = vlerp(p['sheenTint'], V3.full_like(tint, (1.0, 1.0, 1.0)), tint)
    out = dict(p)
    out['basecolor'] = basecolor
    out['tintcolor'] = tint
    out['speccolor'] = spec
    out['sheencolor'] = sheen
    out['alpha'] = jnp.maximum(0.001, p['roughness'] ** 2)
    out['ccalpha'] = lerp(p['clearcoatGloss'], 0.1, 0.001)
    return out


def _etas(p, sign):
    '''(etai, etao) swap when hitting the back side (disney.py:54-58).'''
    ior = p['ior']
    etai = jnp.where(sign < 0, ior, 1.0)
    etao = jnp.where(sign < 0, 1.0, ior)
    return etai, etao


def disney_eval(p, normal, sign, indir, outdir, zero=()):
    '''BRDF value (reference brdf(), disney.py:52-106).
    p: derived param dict; normal/indir/outdir V3; sign [..].
    zero: STATIC names of parameters identically 0 across the material
    table (scene.Materials.zero) — their terms drop out of the trace
    with bit-identical results (every skipped term is multiplied by the
    zero parameter or gated by a never-taken choice_split).
    Returns V3.'''
    no_trans = 'transmission' in zero
    no_coat = 'clearcoat' in zero
    no_metal = 'metallic' in zero

    halfdir = vnormalize(indir + outdir)
    cosi = vdot(indir, normal)
    coso = vdot(outdir, normal)
    cosh = vdot_or_zero(halfdir, normal)
    cosoh = vdot_or_zero(halfdir, outdir)

    alpha = p['alpha']
    basecolor = p['basecolor']
    metallic = p['metallic']
    transmission = p['transmission']

    ds = gtr2(cosh, alpha)

    # --- reflection side (disney.py:74-104) ---
    fi = schlick_fresnel(cosi)
    fo = schlick_fresnel(coso)
    fd90 = 0.5 + 2.0 * cosoh ** 2 * p['roughness']
    fd = lerp(fi, 1.0, fd90) * lerp(fo, 1.0, fd90)

    if 'subsurface' in zero:
        diff_lobe = fd
    else:
        fss90 = cosoh ** 2 * p['roughness']
        fss = lerp(fi, 1.0, fss90) * lerp(fo, 1.0, fss90)
        ss = 1.25 * (fss * (_sd(1.0, cosi + coso) - 0.5) + 0.5)
        diff_lobe = lerp(p['subsurface'], fd, ss)

    foh = schlick_fresnel(cosoh)
    diffuse = basecolor * ((1.0 / PI) * diff_lobe)
    if 'sheen' not in zero:
        diffuse = diffuse + p['sheencolor'] * (foh * p['sheen'])

    fs = vlerp(foh, p['speccolor'], 1.0)
    gs = smith_ggx(cosi, alpha) * smith_ggx(coso, alpha)
    specular = fs * (gs * ds)
    if not no_coat:
        dr = gtr1(cosh, p['ccalpha'])
        gr = smith_ggx(cosi, 0.25) * smith_ggx(coso, 0.25)
        fr = lerp(foh, 0.04, 1.0)
        specular = specular + (0.25 * p['clearcoat'] * gr * fr * dr)

    kd = 1.0 - metallic if not no_metal else 1.0
    if no_trans:
        above = diffuse * kd + specular
        return vwhere(coso < 0.0, 0.0, above)

    etai, etao = _etas(p, sign)
    fdf = dielectric_fresnel(etao, etai, cosoh)

    # --- transmission side (coso < 0, disney.py:66-72) ---
    transmit_b = basecolor * ((1.0 / PI) * (1.0 - fdf) * ds)
    below = transmit_b * (kd * transmission)
    below = vwhere(cosi >= 0.0, below, 0.0)

    transmit = basecolor * ((1.0 / PI) * fdf * ds)
    above = (diffuse * (kd * (1.0 - transmission))
             + transmit * (kd * transmission)
             + specular * (1.0 - transmission))

    return vwhere(coso < 0.0, below, above)


def disney_sample(p, normal, sign, indir, su, sv, sw, zero=()):
    '''Importance-sample a bounce direction (reference bounce(),
    disney.py:114-233).  su/sv/sw: [..] uniforms (sw drives lobe choice).
    zero: STATIC zero-across-the-table parameter names
    (scene.Materials.zero) — never-taken lobes drop out of the trace
    with identical results: choice_split(w, 0) is (False, w, 1).
    Returns (outdir V3, pdf [..], color V3); invalid samples have
    pdf == 0 and color == 0.'''
    no_trans = 'transmission' in zero
    no_coat = 'clearcoat' in zero
    no_metal = 'metallic' in zero

    basecolor = p['basecolor']
    metallic = p['metallic']
    transmission = p['transmission']
    alpha = p['alpha']

    cosi_s = vdot(indir, normal)
    fi = schlick_fresnel(cosi_s)
    fs_color = vlerp(fi, p['speccolor'], 1.0)

    # --- stream-split lobe decisions (disney.py:128-136) ---
    spec_metal = (vavg3(fs_color) if no_metal
                  else lerp(metallic, vavg3(fs_color), 1.0))
    specrate = spec_metal if no_trans else lerp(transmission, spec_metal, 1.0)
    specrate = lerp(specrate, 0.1, 1.0)

    if no_coat:
        take_coat, w1, pdf_c = None, sw, 1.0
    else:
        coatrate_raw = 0.04 * p['clearcoat']
        coatrate = jnp.where(coatrate_raw != 0.0,
                             lerp(coatrate_raw, 0.1, 1.0), 0.0)
        take_coat, w1, pdf_c = choice_split(sw, coatrate)
    take_spec_r, w2, pdf_s = choice_split(w1, specrate)
    if no_coat:
        take_spec = take_spec_r
    else:
        take_spec = ~take_coat & take_spec_r
    if no_trans:
        take_trans_r, w3, pdf_t = None, w2, 1.0
    else:
        take_trans_r, w3, pdf_t = choice_split(w2, transmission)

    # Tangent frame as separate vectors — elementwise frame application
    # fuses; an [..,3,3] matrix + einsum would materialize padded tiles.
    tan, bitan = vtanframe(normal)

    def to_world(local):
        return tan * local.x + bitan * local.y + normal * local.z

    # ---------------- clearcoat lobe (disney.py:136-157) ----------------
    if not no_coat:
        cc_alpha = p['ccalpha']
        h_cc = to_world(sample_gtr1(su, sv, cc_alpha))
        out_cc = vreflect(-indir, h_cc)
        coso_cc = vdot(out_cc, normal)
        cosh_cc = vdot_or_zero(h_cc, normal)
        cosoh_cc = vdot_or_zero(h_cc, out_cc)
        ok_cc = cosoh_cc > 0.0
        dr = gtr1(cosh_cc, cc_alpha)
        fr = lerp(schlick_fresnel(cosoh_cc), 0.04, 1.0)
        partial_cc = p['clearcoat'] * fr * _sd(coso_cc, cosoh_cc)
        pdf_cc = jnp.where(ok_cc, dr * partial_cc, 0.0)
        col_cc_s = jnp.where(ok_cc, _sd(partial_cc, pdf_c), 0.0)
        col_cc = V3(col_cc_s, col_cc_s, col_cc_s)

    # ---------------- specular lobe (disney.py:159-202) ----------------
    h_sp = to_world(sample_gtr2(su, sv, alpha))
    out_sp = vreflect(-indir, h_sp)
    coso_sp = vdot_or_zero(out_sp, normal)
    cosh_sp = vdot_or_zero(h_sp, normal)
    cosoh_sp = vdot_or_zero(h_sp, out_sp)
    ok_sp = (cosoh_sp > 0.0) & (coso_sp > 0.0) & (cosh_sp > 0.0)
    ds = gtr2(cosh_sp, alpha)

    # non-transmission GGX reflection (disney.py:190-198)
    foh = schlick_fresnel(cosoh_sp)
    fs2 = vlerp(foh, p['speccolor'], 1.0)
    partial_sp = 0.5 * _sd(1.0, cosoh_sp * smith_ggx(coso_sp, alpha))
    pdf_sp_plain = ds * vavg3(fs2) * partial_sp
    col_sp_plain = fs2 * _sd(partial_sp * (1.0 - transmission),
                             pdf_c * pdf_s * pdf_t)

    if no_trans:
        out_spec, pdf_spec, col_spec = out_sp, pdf_sp_plain, col_sp_plain
    else:
        # transmission sub-branch (disney.py:172-188)
        etai, etao = _etas(p, sign)
        eta = etai / etao
        fdf = dielectric_fresnel(etao, etai, cosoh_sp)
        reflrate = lerp(fdf, 0.2, 1.0)
        take_refl_r, _w4, pdf_r = choice_split(w3, reflrate)
        # reflected transmission ray
        pdf_sp_trefl = ds * fdf
        col_sp_trefl = basecolor * _sd(fdf * transmission,
                                       pdf_c * pdf_s * pdf_t * pdf_r)
        # refracted transmission ray
        has_rf, out_rf = vrefract(-indir, h_sp, eta)
        pdf_sp_trefr = jnp.where(has_rf, ds * (1.0 - fdf), 0.0)
        col_sp_trefr = vwhere(
            has_rf,
            basecolor * _sd((1.0 - fdf) * transmission,
                            pdf_c * pdf_s * pdf_t * pdf_r),
            0.0)
        out_spec = vwhere(take_trans_r, vwhere(take_refl_r, out_sp, out_rf),
                          out_sp)
        pdf_spec = jnp.where(take_trans_r,
                             jnp.where(take_refl_r, pdf_sp_trefl,
                                       pdf_sp_trefr),
                             pdf_sp_plain)
        col_spec = vwhere(take_trans_r, vwhere(take_refl_r, col_sp_trefl,
                                               col_sp_trefr),
                          col_sp_plain)
    pdf_spec = jnp.where(ok_sp, pdf_spec, 0.0)
    col_spec = vwhere(ok_sp, col_spec, 0.0)

    # ---------------- diffuse lobe (disney.py:204-231) ----------------
    out_df = to_world(vspherical(safe_sqrt(su), sv))
    half_df = vnormalize(indir + out_df)
    cosi_df = vdot(indir, normal)
    coso_df = vdot(out_df, normal)
    cosoh_df = vdot_or_zero(half_df, out_df)
    fi_d = schlick_fresnel(cosi_df)
    fo_d = schlick_fresnel(coso_df)
    fd90 = 0.5 + 2.0 * cosoh_df ** 2 * p['roughness']
    fd = lerp(fi_d, 1.0, fd90) * lerp(fo_d, 1.0, fd90)
    if 'subsurface' in zero:
        diff_lobe = fd
    else:
        fss90 = cosoh_df ** 2 * p['roughness']
        fss = lerp(fi_d, 1.0, fss90) * lerp(fo_d, 1.0, fss90)
        ss = 1.25 * (fss * (_sd(1.0, cosi_df + coso_df) - 0.5) + 0.5)
        diff_lobe = lerp(p['subsurface'], fd, ss)
    diffuse = basecolor * ((1.0 / PI) * diff_lobe)
    if 'sheen' not in zero:
        diffuse = diffuse + p['sheencolor'] * (
            schlick_fresnel(cosoh_df) * p['sheen'])
    kd = 1.0 if no_metal else 1.0 - metallic
    kt = 1.0 if no_trans else 1.0 - transmission
    col_df = diffuse * (PI * _sd(kd * kt, pdf_c * pdf_s))

    # ---------------- select by lane decision ----------------
    outdir = vwhere(take_spec, out_spec, out_df)
    pdf = jnp.where(take_spec, pdf_spec, 1.0 / PI)
    color = vwhere(take_spec, col_spec, col_df)
    if not no_coat:
        outdir = vwhere(take_coat, out_cc, outdir)
        pdf = jnp.where(take_coat, pdf_cc, pdf)
        color = vwhere(take_coat, col_cc, color)
    return outdir, pdf, color
