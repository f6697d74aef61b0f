'''
The GPU cast kernels (intersect/triton_cast.py) in interpret mode on the
CPU, against the plain XLA cast (intersect/brute.py) and the float64
oracle (intersect/oracle.py); the platform routing of intersect/dispatch;
gradients through render_sample on the kernel route.

Interpret mode runs the kernel body as written, so these cases cover its
arithmetic, chunking, padding and masking.  What only the GPU compiler
can refuse is covered by the `gpu`-marked tests and chip_smoke.py.
'''

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptina_tpu.scene import precompute_tri_functionals
from ptina_tpu.intersect import brute, dispatch
from ptina_tpu.intersect.oracle import cast_closest_f64, agreement
from ptina_tpu.intersect.triton_cast import (triton_cast_closest,
                                             triton_cast_any, face_table, FC)
from ptina_tpu.utils.vec import V3

closest_k = functools.partial(triton_cast_closest, interpret=True)
any_k = functools.partial(triton_cast_any, interpret=True)


def _setup(nf, n, seed, avoid_mode='none', zero_faces=0):
    rng = np.random.RandomState(seed)
    tris = (rng.randn(nf, 3, 3) * 2).astype(np.float32)
    if zero_faces:
        tris = np.concatenate([tris, np.zeros((zero_faces, 3, 3),
                                              np.float32)])
    ro = (rng.randn(n, 3) * 3).astype(np.float32)
    rd = rng.randn(n, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    if avoid_mode == 'none':
        avoid = np.full(n, -1, np.int32)
    else:
        avoid = rng.randint(-1, nf, n).astype(np.int32)
    m = precompute_tri_functionals(jnp.asarray(tris))
    return (tris, m, ro, rd, avoid, V3.from_array(jnp.asarray(ro)),
            V3.from_array(jnp.asarray(rd)), jnp.asarray(avoid))


# face counts: one face, the cornell box, a count off the chunk multiple,
# the monkey scene's count; ray counts on and off the block multiple
CASES = [(1, 5), (34, 300), (FC + 5, 129), (966, 200), (2 * FC, 128)]


@pytest.mark.parametrize('avoid_mode', ['none', 'random'])
@pytest.mark.parametrize('nf,n', CASES)
def test_closest_kernel_matches_brute(nf, n, avoid_mode):
    _, m, _, _, _, ro, rd, avoid = _setup(nf, n, nf + n, avoid_mode)
    ref = brute.cast_closest(ro, rd, m, avoid)
    got = closest_k(ro, rd, m, avoid)
    np.testing.assert_array_equal(np.asarray(got.index),
                                  np.asarray(ref.index))
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    hit = np.asarray(ref.hit)
    # the kernel sums the same products in another order
    np.testing.assert_allclose(np.asarray(got.t)[hit], np.asarray(ref.t)[hit],
                               rtol=1e-4)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(np.asarray(a)[hit], np.asarray(b)[hit],
                                   rtol=1e-4, atol=1e-5)
    assert (np.asarray(got.t)[~hit] == np.asarray(ref.t)[~hit]).all()


@pytest.mark.parametrize('nf,n', CASES)
def test_any_kernel_matches_brute(nf, n):
    _, m, _, _, _, ro, rd, avoid = _setup(nf, n, 7 * nf + n, 'random')
    tmax = jnp.asarray(np.random.RandomState(n).uniform(0.0, 8.0, n),
                       jnp.float32)
    ref = brute.cast_any(ro, rd, m, avoid, tmax)
    got = any_k(ro, rd, m, avoid, tmax)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize('nf,n', [(34, 300), (966, 200)])
def test_closest_kernel_matches_f64_oracle(nf, n):
    tris, m, ro_n, rd_n, avoid_n, ro, rd, avoid = _setup(nf, n, 3 * nf,
                                                         'random')
    got = closest_k(ro, rd, m, avoid)
    t64, i64 = cast_closest_f64(tris, ro_n, rd_n, avoid_n)
    assert agreement(np.asarray(got.t), t64) >= 0.995
    assert (np.asarray(got.index) == i64).mean() >= 0.99


def test_degenerate_padding_never_hits_kernel():
    '''All-zero faces (the scene's padding) never hit, in either kernel,
    whatever the ray.'''
    _, m, _, _, _, ro, rd, avoid = _setup(3, 64, 5, zero_faces=FC + 1)
    ref = brute.cast_closest(ro, rd, m, avoid)
    got = closest_k(ro, rd, m, avoid)
    assert (np.asarray(got.index) < 3).all()
    np.testing.assert_array_equal(np.asarray(got.index),
                                  np.asarray(ref.index))
    zeros = jnp.zeros((FC, 3, 4))
    assert not np.asarray(closest_k(ro, rd, zeros, avoid).hit).any()
    assert not np.asarray(any_k(ro, rd, zeros, avoid,
                                jnp.full(64, 1e7))).any()


def test_face_table_layout():
    '''[F, 3, 4] functionals -> [12, F_pad]: row 4k + c is coefficient c
    of functional k, zero-padded to a chunk multiple.'''
    m = jnp.arange(5 * 12, dtype=jnp.float32).reshape(5, 3, 4)
    tbl = np.asarray(face_table(m))
    assert tbl.shape == (12, FC)
    np.testing.assert_array_equal(tbl[:, :5],
                                  np.asarray(m).reshape(5, 12).T)
    assert (tbl[:, 5:] == 0).all()


def test_oracle_matches_reference_moller():
    '''The float64 oracle agrees with the per-face Möller reference of
    test_intersect on random triangles.'''
    from test_intersect import _moller_reference
    tris, _, ro, rd, _, _, _, _ = _setup(16, 64, 42)
    t64, i64 = cast_closest_f64(tris, ro, rd)
    rt, ri, _ = _moller_reference(ro, rd, tris)
    assert (i64 == ri).mean() > 0.98
    both = (i64 == ri) & (ri >= 0)
    np.testing.assert_allclose(t64[both], rt[both], rtol=1e-5)  # rt: f32


def test_oracle_excludes_avoided_face():
    tris = np.asarray([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]],
                       [[-1, -1, 1], [1, -1, 1], [0, 1, 1]]], np.float32)
    ro = np.zeros((2, 3))
    ro[:, 2] = -2.0
    rd = np.tile([0.0, 0.0, 1.0], (2, 1))
    t, i = cast_closest_f64(tris, ro, rd, np.asarray([-1, 0]))
    np.testing.assert_allclose(t, [2.0, 3.0])
    np.testing.assert_array_equal(i, [0, 1])


@pytest.mark.parametrize('platform,expected', [
    ('gpu', (triton_cast_closest, triton_cast_any)),
    ('cpu', (brute.cast_closest, brute.cast_any)),
])
def test_dispatch_route_per_platform(monkeypatch, platform, expected):
    monkeypatch.setattr(jax, 'default_backend', lambda: platform)
    assert dispatch._casts() == expected


def test_dispatch_refuses_other_platforms(monkeypatch):
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    with pytest.raises(NotImplementedError):
        dispatch._casts()


def test_grad_through_render_sample_on_kernel_route(monkeypatch):
    '''jax.grad through the wavefront integrator with the kernel cast:
    rays reach the kernel detached, so no VJP of it is needed, and the
    material gradients equal those of the brute route.'''
    from ptina_tpu.scenes import cornell_box
    from ptina_tpu.film import new_film, film_to_image
    from ptina_tpu.engine.path import render_sample

    scene = cornell_box()
    film = new_film(4, 4)

    def loss(fac):
        sc = scene.replace(materials=scene.materials.replace(fac=fac))
        return jnp.mean(film_to_image(render_sample(sc, film, 0,
                                                    max_depth=2))[..., :3])

    g_ref = np.asarray(jax.grad(loss)(scene.materials.fac))
    monkeypatch.setattr(dispatch, '_casts', lambda: (closest_k, any_k))
    g = np.asarray(jax.grad(loss)(scene.materials.fac))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, g_ref, rtol=1e-4,
                               atol=1e-6 * np.abs(g_ref).max())


@pytest.mark.gpu
@pytest.mark.parametrize('scene_name', ['cornell_monkey', 'matball'])
def test_compiled_kernels_match_brute_on_gpu(gpu, scene_name):
    '''The compiled kernels (no interpret mode) at a real wavefront
    width against brute.py at full float32 precision.'''
    import chip_smoke
    from ptina_tpu import scenes
    scene = getattr(scenes, scene_name)()
    for wname, ro, rd, avoid, tmax, _ in chip_smoke.wavefronts(scene,
                                                               res=256):
        if wname == 'shadow':
            got = triton_cast_any(ro, rd, scene.tri_w2b, avoid, tmax)
            ref = brute.cast_any(ro, rd, scene.tri_w2b, avoid, tmax)
            assert (np.asarray(got) == np.asarray(ref)).mean() >= 0.999
        else:
            chip_smoke.compare_casts(
                wname, triton_cast_closest(ro, rd, scene.tri_w2b, avoid),
                brute.cast_closest(ro, rd, scene.tri_w2b, avoid))


@pytest.mark.gpu
def test_dispatch_takes_kernel_on_gpu(gpu):
    assert dispatch._casts() == (triton_cast_closest, triton_cast_any)
