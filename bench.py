'''
Benchmark: the reference's headline configurations, 512x512, 32 spp,
unidirectional path tracing with MIS (reference exams/benchmark.py:25-38;
baselines on a GeForce 940MX CUDA: cornell two-boxes 7.25 sps
(README.md:44), cornell+monkey 2.88 sps (README.md:50)).

Methodology follows the reference — one warmup render + image readback,
clear the film, then time progressive 32-spp frames — with one
adaptation: the timed region covers SEVERAL back-to-back 32-spp frames
(self-tuned to ~2.5 s of work, frames chosen from a probe frame's
measured speed) with a single device sync at the end, so the host's
sync round trip is amortized over the region.  sps = total timed
samples / elapsed, sync included (amortized, never subtracted).

Runs on a GPU only: without one it exits non-zero and prints nothing.
Every line is stamped with the platform, device kind and device count.

Prints one JSON line per metric; the HEADLINE cornell line is printed
LAST:
  - sps_cornell_monkey_512x512_32spp   (966 tris, vs 2.88 sps)
  - sps_cornell_highpoly_512x512_8spp  (~102k tris; no reference
    baseline row — vs_baseline uses the monkey 2.88, the closest
    published BVH-bound number)
  - sps_cornell_textured_512x512_32spp (walls carry a real 64x64
    basecolor texture fetched per bounce, vs 7.25 — textures are on the
    reference's default path, ptina/mtllib.py:30-38)
  - sps_matball_aov_512x512_32spp      (textured Disney matball + albedo/
    normal AOV passes, BASELINE.json config 3, vs 7.25)
  - sps_envlight_mis_512x512_32spp     (environment-texture light + full
    MIS + Sobol, BASELINE.json config 4, vs 7.25)
  - sps_cornell_300k_256x256_2spp      (~306k tris, casts checked against
    a float64 oracle first; vs the monkey 2.88)
  - mps_mlt_cornell_monkey_512x512     (MLT mutations/s on cornell_monkey,
    BASELINE.json config 5; vs_baseline uses the reference's 2.88 sps *
    512*512 paths/s as the closest published mutation-rate bar,
    exams/metropolis.py methodology)
  - sps_cornell_512x512_32spp          (34 tris, vs 7.25 sps)
'''

import json
import sys
import time

import numpy as np

TARGET_TIMED_S = 2.5   # timed-region length the frame count aims for
MAX_FRAMES = 64


def _sync(film):
    import jax.numpy as jnp
    checksum = float(jnp.sum(film))
    assert np.isfinite(checksum)
    return checksum


def _time_render(scene, res, spp, warm_spp=None, **render_kw):
    import jax.numpy as jnp
    from ptina_tpu.film import new_film, film_to_image
    from ptina_tpu.engine.path import render

    # warmup (compile) + readback, reference-style
    film = new_film(res, res)
    film = render(scene, film, 0, spp=warm_spp or spp, **render_kw)
    _sync(film)
    img = np.asarray(film_to_image(film))
    assert not np.isnan(img).any(), 'nan in benchmark render'

    # COMPILE-FREE probe frame to size the timed region (using the
    # warmup's elapsed time here once under-estimated a 580-sps scene
    # at 0.5 sps and collapsed the timed region to one RTT-bound frame)
    t0 = time.perf_counter()
    film = render(scene, film, 0, spp=spp, **render_kw)
    _sync(film)
    est_sps = spp / (time.perf_counter() - t0)
    frames = int(max(1, min(MAX_FRAMES, round(TARGET_TIMED_S * est_sps / spp))))

    # timed region: `frames` progressive 32-spp frames, one sync at the
    # end (see module docstring for why the sync is amortized)
    film = new_film(res, res)
    t0 = time.perf_counter()
    for k in range(frames):
        film = render(scene, film, k * spp, spp=spp, **render_kw)
    _sync(film)
    elapsed = time.perf_counter() - t0
    img = np.asarray(film_to_image(film))
    assert not np.isnan(img).any(), 'nan in benchmark render'
    return frames * spp / elapsed


def _device():
    '''The device stamp of every line; exits non-zero without a GPU.'''
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        sys.exit(f'bench: needs a GPU, JAX found {devices[0].platform!r}')
    return {'platform': devices[0].platform,
            'device_kind': devices[0].device_kind,
            'device_count': len(devices)}


def _emit(metric, value, baseline, unit='samples/s'):
    row = {
        'metric': metric,
        'value': round(value, 3),
        'unit': unit,
        'vs_baseline': round(value / baseline, 3),
    }
    row.update(_device())
    print(json.dumps(row), flush=True)


def _bench_texture():
    return (np.linspace(0, 1, 64 * 64, dtype=np.float32)
            .reshape(64, 64, 1) * np.ones((1, 1, 3), np.float32))


def _time_mlt(scene, res, nchains=2 ** 17, steps=4, rounds=4):
    '''MLT mutations/s (reference exams/metropolis.py advances
    MLTPathEngine chains; one mutation = one full path replay here too).'''
    import jax
    from ptina_tpu.engine.mlt import mlt_init, render_mlt
    from ptina_tpu.film import new_film

    film = new_film(res, res)
    state = mlt_init(jax.random.PRNGKey(1), nchains=nchains)
    state, film = render_mlt(scene, state, film, steps=steps)  # warmup
    _sync(film)
    t0 = time.perf_counter()
    for _ in range(rounds):
        state, film = render_mlt(scene, state, film, steps=steps)
    _sync(film)
    elapsed = time.perf_counter() - t0
    return rounds * steps * nchains / elapsed


def _bench_300k():
    import jax.numpy as jnp
    from ptina_tpu.scenes import cornell_highpoly
    from ptina_tpu.intersect.dispatch import cast_shaded
    from ptina_tpu.intersect.oracle import cast_closest_f64, agreement
    from ptina_tpu.utils.vec import V3

    scene = cornell_highpoly(nu=640, nv=240)

    # f64 host-oracle subsample through the production cast
    rng = np.random.default_rng(0)
    ron = rng.uniform(-1.5, 1.5, (32, 3)).astype(np.float32) + [0, 1.5, 0]
    dn = rng.normal(0, 1, (32, 3)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=1, keepdims=True)
    hit, *_ = cast_shaded(
        scene, V3.from_array(jnp.asarray(ron)),
        V3.from_array(jnp.asarray(dn)), jnp.full(32, -1, jnp.int32))
    tp = np.asarray(scene.tri_pos)[:int(scene.nfaces)]
    t64, _ = cast_closest_f64(tp, ron, dn)
    agree = agreement(np.asarray(hit.t), t64)
    assert agree >= 31 / 32, f'cast disagrees with the f64 oracle: {agree}'

    return _time_render(scene, 256, 2)


def main():
    _device()
    from ptina_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()
    from ptina_tpu.scenes import (cornell_box, cornell_monkey,
                                  cornell_highpoly, matball, envlight_scene)

    res, spp = 512, 32

    sps = _time_render(cornell_monkey(), res, spp)
    _emit('sps_cornell_monkey_512x512_32spp', sps, 2.88)

    # ~102k faces: the cast's O(rays x faces) work dominates
    sps = _time_render(cornell_highpoly(), res, 8)
    _emit('sps_cornell_highpoly_512x512_8spp', sps, 2.88)

    # textured cornell: walls fetch a real 64x64 basecolor texture each
    # bounce (reference default path, ptina/mtllib.py:30-38)
    scene_tex = cornell_box(textured_image=_bench_texture())
    sps = _time_render(scene_tex, res, spp)
    _emit('sps_cornell_textured_512x512_32spp', sps, 7.25)

    # matball with textured Disney roughness + AOV passes (config 3):
    # render the albedo/normal AOV passes once (reference PreviewEngine),
    # then measure the path-trace sps on the same textured scene
    from ptina_tpu.engine.preview import render_preview
    from ptina_tpu.film import new_film
    scene_mb = matball(roughness_tex=_bench_texture())
    film = new_film(res, res)
    film = render_preview(scene_mb, film, 0, spp=1)
    _sync(film)
    sps = _time_render(scene_mb, res, spp)
    _emit('sps_matball_aov_512x512_32spp', sps, 7.25)

    # environment-light scene with full MIS + Sobol (config 4)
    sps = _time_render(envlight_scene(), res, spp)
    _emit('sps_envlight_mis_512x512_32spp', sps, 7.25)

    # ~306k faces, correctness-checked on a 32-ray subsample against
    # an f64 host oracle (NOT intersect/brute: at this tessellation
    # density a float32 cast can itself lose hits).  No reference
    # baseline row; vs_baseline reuses the monkey 2.88 bar.
    sps = _bench_300k()
    _emit('sps_cornell_300k_256x256_2spp', sps, 2.88)

    # MLT mutations/s on cornell_monkey (config 5); baseline = the
    # reference's 2.88 sps * 512*512 primary paths per sample
    mps = _time_mlt(cornell_monkey(), res)
    _emit('mps_mlt_cornell_monkey_512x512', mps, 2.88 * 512 * 512,
          unit='mutations/s')

    # headline metric LAST: cornell two-boxes vs 7.25 sps CUDA baseline
    sps = _time_render(cornell_box(), res, spp)
    _emit('sps_cornell_512x512_32spp', sps, 7.25)


if __name__ == '__main__':
    main()
