'''
Cast and render timings on the GPU: the measurement that decides
whether the Pallas cast kernels (intersect/triton_cast.py) stay.

    python tools/time_casts.py

For each of cornell_box, cornell_monkey, matball and cornell_highpoly it
times the kernel and the plain XLA cast (intersect/brute.py at full
float32 precision) on the 262,144-ray camera, bounce and shadow
wavefronts of chip_smoke.py; then `render` end to end on cornell_monkey
(512x512, 32 spp) and cornell_highpoly (512x512, 8 spp) with each cast;
then lbvh_traverse once at the highpoly face count.  Each time is the
median of several runs on the host clock, after a warm-up, ending in
block_until_ready; each JSON line names the card and its power limit.
Exits non-zero without a GPU.
'''

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402


def median_time(fn, reps):
    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def emit(card, **row):
    print(json.dumps(dict(row, device_kind=jax.devices()[0].device_kind,
                          card=card)), flush=True)


def main():
    chip_smoke.device_check(1)
    card = chip_smoke.card_info()
    from ptina_tpu.engine.path import render
    from ptina_tpu.film import new_film
    from ptina_tpu.intersect import brute, dispatch, triton_cast
    from ptina_tpu.intersect.lbvh import lbvh_build, lbvh_traverse
    from ptina_tpu import scenes

    casts = {'kernel': (triton_cast.triton_cast_closest,
                        triton_cast.triton_cast_any),
             'brute': (brute.cast_closest, brute.cast_any)}
    for name in ('cornell_box', 'cornell_monkey', 'matball',
                 'cornell_highpoly'):
        scene = getattr(scenes, name)()
        m = scene.tri_w2b
        for wname, ro, rd, avoid, tmax, _ in chip_smoke.wavefronts(scene):
            for route, (closest, occluded) in casts.items():
                if wname == 'shadow':
                    def fn():
                        return occluded(ro, rd, m, avoid, tmax)
                else:
                    def fn():
                        return closest(ro, rd, m, avoid)
                med, runs = median_time(fn, 5)
                emit(card, metric='cast_ms', scene=name,
                     faces=int(scene.nfaces), rays=int(ro.x.shape[0]),
                     wavefront=wname, route=route, median=med * 1e3,
                     runs=[t * 1e3 for t in runs])

    platform_casts = dispatch._casts
    for name, spp in (('cornell_monkey', 32), ('cornell_highpoly', 8)):
        scene = getattr(scenes, name)()
        for route, fns in casts.items():
            # the route is picked at trace time: retrace for each
            dispatch._casts = lambda fns=fns: fns
            jax.clear_caches()
            med, runs = median_time(
                lambda: render(scene, new_film(512, 512), 0, spp=spp), 2)
            emit(card, metric='render_s', scene=name, res=512, spp=spp,
                 route=route, median=med, runs=runs, sps=spp / med)
    dispatch._casts = platform_casts

    scene = scenes.cornell_highpoly()
    _, ro, rd, avoid, _, _ = chip_smoke.wavefronts(scene)[0]
    nf = int(scene.nfaces)
    t0 = time.perf_counter()
    bvh = jax.block_until_ready(lbvh_build(scene.tri_pos[:nf]))
    build_s = time.perf_counter() - t0
    o = jnp.stack([ro.x, ro.y, ro.z], -1)
    d = jnp.stack([rd.x, rd.y, rd.z], -1)
    med, runs = median_time(
        lambda: lbvh_traverse(bvh, scene.tri_w2b[:nf], o, d, avoid), 3)
    got = lbvh_traverse(bvh, scene.tri_w2b[:nf], o, d, avoid)
    ref = triton_cast.triton_cast_closest(ro, rd, scene.tri_w2b, avoid)
    emit(card, metric='lbvh_traverse_ms', scene='cornell_highpoly',
         faces=nf, rays=int(o.shape[0]), wavefront='camera',
         median=med * 1e3, runs=[t * 1e3 for t in runs],
         build_s_first_call=build_s,
         index_agree_with_kernel=float(jnp.mean(got.index == ref.index)))


if __name__ == '__main__':
    main()
