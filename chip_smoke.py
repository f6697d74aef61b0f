#!/usr/bin/env python3
'''
Smoke test of the renderer on NVIDIA GPUs: the quickest proof that the
system runs on the card.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One card, in one process, each phase at full size:
  1. device check: a GPU or exit non-zero; the card's name and power
     limit (nvidia-smi); the compile-cache directory;
  2. casts at real widths: the production cast (the platform's route in
     intersect/dispatch.py) against intersect/brute.py at full float32
     precision, on 262,144-ray wavefronts (a 512^2 camera wavefront, its
     diffuse bounce, shadow rays to the light) over the face tables of
     cornell_box, cornell_monkey, matball and cornell_highpoly; both
     against a float64 oracle on a 4,096-ray subsample;
  3. renders: 512x512 at 32 spp of four scenes plus matball after its
     AOV preview; 64x64 at 512 spp against the stored goldens;
  4. large meshes: cornell_highpoly (~102k faces) at 512x512 8 spp, and
     ~306k faces at 256x256 2 spp with a float64 check of its casts;
  5. MLT on cornell_monkey: 2^17 chains x 4 steps at 512x512;
  6. one inverse-rendering gradient step on cornell_box at 256x256;
  7. progressive worker.render calls, as examples/interactive.py makes.

Four cards: render_sharded of a 512x512 8 spp cornell_monkey frame
against a one-card render of the same frame, and train_step_sharded
gradients against one-device gradients.

Tolerances, and why:
  * kernel vs brute.py: hit/miss and face index agree on >= 99.9% of
    rays (ties on shared edges and near-parallel faces may resolve
    differently); where both hit, |t - t_ref| <= 1e-4 * t_ref on
    >= 99.9% of those rays (the two sum the same products in another
    order; near-grazing hits amplify that into t);
  * vs the float64 oracle: >= 99.5% of subsample rays agree within
    2e-3 * t64 or both miss (float32 functionals lose hits on densely
    tessellated meshes, so the oracle is float64);
  * goldens: the mean and blurred-patch tolerances of
    tests/test_parity.py;
  * four cards: the sharded film equals the one-card film within
    tests/test_sharding.py's allclose; gradients agree within
    rtol 1e-3 and an absolute 1e-3 * max |gradient|.  At 512x512 each
    gradient element sums up to 262,144 per-ray contributions by
    scatter-add, in an order that differs between one device and four
    (and between runs), so elements that cancel towards zero keep an
    absolute error of that order; tests/test_sharding.py's 1e-6 holds
    for its 16x8 film on the CPU.  A wrong reduction (a missing mean, a
    shifted band) moves gradients by O(max |gradient|).

Every phase prints its wall time on the host clock; these are set-up
and smoke times, compilation included, not benchmark numbers.  The last
line of standard output is the JSON verdict; a failing phase raises and
the script exits non-zero without it.
'''

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ORACLE_RAYS = 4096
INDEX_AGREE = 0.999
T_RTOL = 1e-4
ORACLE_AGREE = 0.995
ORACLE_RTOL = 2e-3
GRAD_ATOL = 1e-3  # times max |gradient|; see the module docstring


class SmokeError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def phase(name):
    '''Decorator printing a phase's wall time.'''
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            print(f'[smoke] {name}: {time.perf_counter() - t0:.1f} s wall '
                  '(set-up and smoke, compilation included; not a '
                  'benchmark)', flush=True)
            return out
        return run
    return wrap


def card_info():
    '''`name, power.limit` of each card, read by nvidia-smi in a child
    process that stays off JAX.'''
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_check(count):
    import jax
    devices = jax.devices()
    platform = devices[0].platform
    if platform != 'gpu':
        sys.exit(f'chip_smoke: needs a GPU, JAX found {platform!r}')
    if len(devices) < count:
        sys.exit(f'chip_smoke: needs {count} GPUs, JAX found {len(devices)}')
    from ptina_tpu.utils.cache import setup_compile_cache
    print(f'[smoke] card: {card_info()}', flush=True)
    print(f'[smoke] jax {jax.__version__}: {len(devices)} x '
          f'{devices[0].device_kind}', flush=True)
    print(f'[smoke] compile cache: {setup_compile_cache()}', flush=True)
    return devices


# ---------------------------------------------------------------- casts

def wavefronts(scene, res=512, seed=0):
    '''Three [res^2] ray sets of a scene as (name, ro, rd, avoid, tmax,
    live): the camera wavefront (jittered pixel centres), its
    cosine-weighted diffuse bounce from the reference cast's hits, and
    shadow rays from those hits to the first light (tmax = the light's
    distance).  Lanes whose camera ray missed are parked at the origin
    with tmax 0, as the integrator parks them; `live` marks the others.'''
    import jax.numpy as jnp
    from ptina_tpu.camera import camera_rays
    from ptina_tpu.engine.path import pixel_grid
    from ptina_tpu.intersect import brute
    from ptina_tpu.utils.vec import V3, vnormalize

    rng = np.random.default_rng(seed)
    n = res * res
    ii, jj = pixel_grid(res, res)
    jit = jnp.asarray(rng.random((2, n), np.float32))
    ro, rd = camera_rays(scene.cam_v2w, (ii + jit[0]) / res * 2.0 - 1.0,
                         (jj + jit[1]) / res * 2.0 - 1.0)
    none = jnp.full((n,), -1, jnp.int32)
    hit = brute.cast_closest(ro, rd, scene.tri_w2b, none)
    pos = ro + rd * hit.t
    nrm = scene.tri_w2b[jnp.maximum(hit.index, 0), 0, :3]
    nrm = V3(nrm[:, 0], nrm[:, 1], nrm[:, 2])
    facing = (nrm.x * rd.x + nrm.y * rd.y + nrm.z * rd.z) < 0.0
    nrm = V3(*(jnp.where(facing, c, -c) for c in (nrm.x, nrm.y, nrm.z)))
    # cosine-weighted direction: normal + a uniform point on the sphere
    u = jnp.asarray(rng.random((2, n), np.float32))
    z = 1.0 - 2.0 * u[0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * np.pi * u[1]
    bd = vnormalize(nrm + V3(r * jnp.cos(phi), r * jnp.sin(phi), z))
    live = hit.hit

    def park(v, fill):
        return V3(*(jnp.where(live, c, f) for c, f in
                    zip((v.x, v.y, v.z), fill)))
    org = park(pos, (0.0, 0.0, 0.0))
    lp = scene.lights.pos[0]
    to_l = V3(lp[0] - pos.x, lp[1] - pos.y, lp[2] - pos.z)
    dist = jnp.sqrt(to_l.x ** 2 + to_l.y ** 2 + to_l.z ** 2)
    avoid = jnp.where(live, hit.index, -1)
    zero = jnp.zeros((n,), jnp.float32)
    every = np.ones(n, bool)
    live = np.asarray(live)
    return [
        ('camera', ro, rd, none, zero, every),
        ('bounce', org, park(bd, (0.0, 0.0, 1.0)), avoid, zero, live),
        ('shadow', org, park(vnormalize(to_l), (0.0, 0.0, 1.0)), avoid,
         jnp.where(live, dist, 0.0), live),
    ]


def compare_casts(tag, got, ref):
    '''Production cast vs brute.py (Hit pairs) at the tolerances above.'''
    gi, ri = np.asarray(got.index), np.asarray(ref.index)
    agree = float((gi == ri).mean())
    both = np.asarray(got.hit) & np.asarray(ref.hit)
    gt, rt = np.asarray(got.t)[both], np.asarray(ref.t)[both]
    t_ok = float((np.abs(gt - rt) <= T_RTOL * rt).mean()) if both.any() \
        else 1.0
    print(f'[smoke]   {tag}: index agree {agree:.6f}, t within {T_RTOL} '
          f'on {t_ok:.6f} of {int(both.sum())} common hits, hit rate '
          f'{float(np.asarray(ref.hit).mean()):.3f}', flush=True)
    check(agree >= INDEX_AGREE, f'{tag}: index agreement {agree}')
    check(t_ok >= INDEX_AGREE, f'{tag}: t agreement {t_ok}')


def oracle_check(tag, scene, ro, rd, avoid, live, results):
    '''Float64 oracle on an evenly strided subsample of the live lanes
    (a parked ray starts on whatever face passes through the origin, a
    float32 tie the integrator masks out); results: name -> t rows of
    the float32 casts.'''
    from ptina_tpu.intersect.oracle import cast_closest_f64, agreement
    lanes = np.flatnonzero(live)
    sub = lanes[np.linspace(0, lanes.size - 1, ORACLE_RAYS).astype(np.int64)]

    def rows(v):
        return np.stack([np.asarray(v.x), np.asarray(v.y),
                         np.asarray(v.z)], -1)[sub]
    tp = np.asarray(scene.tri_pos)[:int(scene.nfaces)]
    t64, _ = cast_closest_f64(tp, rows(ro), rows(rd), np.asarray(avoid)[sub])
    for name, t in results.items():
        a = agreement(np.asarray(t)[sub], t64, rtol=ORACLE_RTOL)
        print(f'[smoke]   {tag} {name} vs f64 oracle: {a:.4f} of '
              f'{ORACLE_RAYS} rays agree', flush=True)
        check(a >= ORACLE_AGREE, f'{tag} {name}: oracle agreement {a}')


@phase('2 casts at real widths')
def phase_casts(scenes):
    import jax
    from ptina_tpu.intersect import brute, dispatch
    closest, occluded = dispatch._casts()
    print(f'[smoke] cast route: {closest.__module__}.{closest.__name__}, '
          f'{occluded.__module__}.{occluded.__name__}', flush=True)
    for sname, scene in scenes.items():
        f = int(scene.nfaces)
        for wname, ro, rd, avoid, tmax, live in wavefronts(scene):
            tag = f'{sname} ({f} faces) {wname}'
            if wname == 'shadow':
                got = dispatch.cast_any(ro, rd, scene.tri_w2b, avoid, tmax)
                ref = brute.cast_any(ro, rd, scene.tri_w2b, avoid, tmax)
                agree = float((np.asarray(got) == np.asarray(ref)).mean())
                print(f'[smoke]   {tag}: occlusion agree {agree:.6f}, '
                      f'occluded {float(np.asarray(ref).mean()):.3f}',
                      flush=True)
                check(agree >= INDEX_AGREE, f'{tag}: occlusion {agree}')
                continue
            got = dispatch.cast_closest(ro, rd, scene.tri_w2b, avoid)
            ref = brute.cast_closest(ro, rd, scene.tri_w2b, avoid)
            jax.block_until_ready((got, ref))
            compare_casts(tag, got, ref)
            oracle_check(tag, scene, ro, rd, avoid, live,
                         {'production': got.t, 'brute': ref.t})


# -------------------------------------------------------------- renders

def finite_film(tag, film):
    film = np.asarray(film)
    check(np.isfinite(film).all(), f'{tag}: non-finite film')
    check(film[0, 3].min() > 0, f'{tag}: pixels without samples')
    check(film[0, :3].sum() > 0, f'{tag}: black film')
    return film


def print_memory(scene):
    from ptina_tpu.engine.path import _render_step
    from ptina_tpu.film import new_film
    mem = _render_step.lower(scene, new_film(512, 512), 0, spb=8) \
        .compile().memory_analysis()
    print(f'[smoke] memory_analysis of one 512x512 x 8-sample render '
          f'step: {mem}', flush=True)


@phase('3 renders')
def phase_renders():
    from bench import _bench_texture as bench_texture
    from ptina_tpu.engine.path import render
    from ptina_tpu.engine.preview import render_preview
    from ptina_tpu.film import new_film, film_to_image
    from ptina_tpu.io.encoding import decode_numpy_array
    from ptina_tpu.scenes import (cornell_box, cornell_monkey, matball,
                                  envlight_scene)
    print_memory(cornell_box())
    for name, scene in [
            ('cornell_box', cornell_box()),
            ('cornell_monkey', cornell_monkey()),
            ('cornell_textured', cornell_box(textured_image=bench_texture())),
            ('envlight', envlight_scene())]:
        finite_film(name, render(scene, new_film(512, 512), 0, spp=32))
        print(f'[smoke]   {name} 512x512 32 spp: finite', flush=True)

    scene = matball(roughness_tex=bench_texture())
    film = render_preview(scene, new_film(512, 512), 0, spp=1)
    aov = np.asarray(film)
    check(np.isfinite(aov).all(), 'matball AOV: non-finite')
    check(aov[1, 3].min() > 0 and aov[2, 3].min() > 0,
          'matball AOV: albedo/normal passes not filled')
    finite_film('matball', render(scene, film, 0, spp=32))
    print('[smoke]   matball AOV passes filled; 512x512 32 spp finite',
          flush=True)

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'tests', 'golden')
    for name, scene, patch_tol in [('cornell', cornell_box(), 0.05),
                                   ('cornell_monkey', cornell_monkey(), 0.06)]:
        img = np.asarray(film_to_image(
            render(scene, new_film(64, 64), 0, spp=512)))[..., :3]
        with open(os.path.join(golden, f'{name}_64x64_512spp.txt')) as f:
            gold = decode_numpy_array(f.read())
        mean_err = abs(img.mean() - gold.mean()) / gold.mean()
        h, w, c = img.shape

        def blur(a):
            return a.reshape(h // 4, 4, w // 4, 4, c).mean(axis=(1, 3))
        patch = float((np.abs(blur(img) - blur(gold))
                       / (blur(gold) + 0.05)).mean())
        print(f'[smoke]   {name} 64x64 512 spp vs golden: mean error '
              f'{mean_err:.3e} (tol 0.015), patch error {patch:.3e} '
              f'(tol {patch_tol})', flush=True)
        check(mean_err < 0.015 and patch < patch_tol,
              f'{name}: golden mismatch')


@phase('4 large meshes')
def phase_large(highpoly):
    from ptina_tpu.engine.path import render
    from ptina_tpu.film import new_film
    from ptina_tpu.intersect import dispatch
    from ptina_tpu.scenes import cornell_highpoly
    finite_film('cornell_highpoly',
                render(highpoly, new_film(512, 512), 0, spp=8))
    print('[smoke]   cornell_highpoly 512x512 8 spp: finite', flush=True)

    scene = cornell_highpoly(nu=640, nv=240)
    print(f'[smoke]   cornell_highpoly(640, 240): {int(scene.nfaces)} faces',
          flush=True)
    for wname, ro, rd, avoid, _, live in wavefronts(scene, res=256)[:2]:
        hit, *_ = dispatch.cast_shaded(scene, ro, rd, avoid)
        oracle_check(f'306k {wname}', scene, ro, rd, avoid, live,
                     {'cast_shaded': hit.t})
    finite_film('cornell_300k', render(scene, new_film(256, 256), 0, spp=2))
    print('[smoke]   306k faces 256x256 2 spp: finite', flush=True)


@phase('5 MLT')
def phase_mlt():
    import jax
    from ptina_tpu.engine.mlt import mlt_init, render_mlt
    from ptina_tpu.film import new_film
    from ptina_tpu.scenes import cornell_monkey
    state = mlt_init(jax.random.PRNGKey(1), nchains=2 ** 17)
    state, film = render_mlt(cornell_monkey(), state, new_film(512, 512),
                             steps=4)
    film = np.asarray(film)
    check(np.isfinite(film).all(), 'MLT: non-finite film')
    check(film[0, :3].sum() > 0, 'MLT: black film')
    print('[smoke]   MLT 2^17 chains x 4 steps: finite, non-zero',
          flush=True)


def used_params_check(tag, g):
    '''Non-zero exactly where tests/test_grad.py expects: the white
    material's basecolor participates, basecolor's alpha never does.'''
    g = np.asarray(g)
    check(np.isfinite(g).all(), f'{tag}: non-finite gradient')
    check(np.abs(g[0, 0, :3]).sum() > 0, f'{tag}: zero basecolor gradient')
    check(np.abs(g[:, 0, 3]).sum() == 0, f'{tag}: gradient on unused alpha')


@phase('6 gradient step')
def phase_grad():
    import jax.numpy as jnp
    from ptina_tpu.diff import material_grad
    from ptina_tpu.scenes import cornell_box
    scene = cornell_box()
    target = jnp.full((256, 256, 3), 0.5)
    loss, g = material_grad(scene, target)
    check(np.isfinite(float(loss)), 'gradient step: non-finite loss')
    used_params_check('gradient step', g)
    fac = scene.materials.fac - 0.1 * g
    check(np.isfinite(np.asarray(fac)).all(), 'gradient step: bad update')
    print(f'[smoke]   cornell_box 256x256 loss {float(loss):.5f}, '
          'gradient finite, non-zero exactly on used parameters',
          flush=True)


@phase('7 worker')
def phase_worker():
    from ptina_tpu import worker
    from ptina_tpu.scenes import cornell_box_vertices
    from ptina_tpu.utils.control import CamControl
    verts, mtlids, materials = cornell_box_vertices()
    worker.init()
    worker.load_materials(materials)
    worker.load_model(verts, mtlids)
    worker.build_tree()
    cam = CamControl(center=(0.0, 1.0, 0.0), radius=4.5, phi=0.1)
    for nblocks in (2, 1):  # coarse-to-fine, as examples/interactive.py
        worker.set_size(256 // nblocks, 256 // nblocks)
        worker.set_camera(cam.matrix(aspect=1.0))
        for _ in range(3):
            worker.render()
        img = np.asarray(worker.get_image())
        check(np.isfinite(img).all() and img[..., :3].sum() > 0,
              f'worker at {img.shape}: bad image')
    print('[smoke]   worker: 128^2 and 256^2 progressive samples finite',
          flush=True)


# ------------------------------------------------------------ four cards

@phase('four cards: sharded render and training step')
def phase_four_cards(devices, res=512, spp=8):
    import jax
    import jax.numpy as jnp
    from ptina_tpu.engine.path import render, render_sample
    from ptina_tpu.film import new_film, film_to_image
    from ptina_tpu.parallel import make_mesh, render_sharded, \
        train_step_sharded
    from ptina_tpu.scenes import cornell_monkey
    scene = cornell_monkey()
    mesh = make_mesh(devices[:4])
    single = np.asarray(render(scene, new_film(res, res), 0, spp=spp))
    sharded = np.asarray(render_sharded(scene, new_film(res, res), 0, mesh,
                                        spp=spp))
    err = float(np.abs(single - sharded).max())
    print(f'[smoke]   render_sharded vs one card, {res}x{res} {spp} spp: '
          f'max |diff| {err:.3g}', flush=True)
    check(np.allclose(single, sharded, atol=1e-5), 'sharded render differs')

    nx, ny, lr = res, res, 0.1
    target = jnp.zeros((nx, ny, 3))
    film0 = new_film(nx, ny)
    s1, loss = train_step_sharded(scene, film0, target, 0, mesh, lr=lr)
    g_sharded = (np.asarray(scene.materials.fac)
                 - np.asarray(s1.materials.fac)) / lr

    def full_loss(fac):
        sc = scene.replace(materials=scene.materials.replace(fac=fac))
        img = film_to_image(render_sample(sc, film0, 0))[..., :3]
        return jnp.mean((img - target) ** 2)
    g_single = np.asarray(jax.jit(jax.grad(full_loss))(scene.materials.fac))
    err = float(np.abs(g_sharded - g_single).max())
    print(f'[smoke]   train_step_sharded vs one device: loss '
          f'{float(loss):.5f}, max |grad diff| {err:.3g} of max '
          f'{float(np.abs(g_single).max()):.3g}', flush=True)
    check(np.abs(g_single).max() > 0, 'zero single-device gradient')
    check(np.allclose(g_sharded, g_single, rtol=1e-3,
                      atol=GRAD_ATOL * float(np.abs(g_single).max())),
          'sharded gradients differ')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the sharded paths, on four cards')
    args = ap.parse_args()
    count = 4 if args.four_cards else 1
    devices = device_check(count)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(devices)
    else:
        from ptina_tpu.scenes import (cornell_box, cornell_monkey, matball,
                                      cornell_highpoly)
        highpoly = cornell_highpoly()
        phase_casts({'cornell_box': cornell_box(),
                     'cornell_monkey': cornell_monkey(),
                     'matball': matball(),
                     'cornell_highpoly': highpoly})
        phase_renders()
        phase_large(highpoly)
        phase_mlt()
        phase_grad()
        phase_worker()
    print(f'[smoke] all phases passed in {time.perf_counter() - t0:.1f} s',
          flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}}))


if __name__ == '__main__':
    main()
