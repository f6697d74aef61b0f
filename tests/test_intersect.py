import numpy as np
import jax.numpy as jnp

from ptina_tpu.scene import precompute_tri_functionals
from ptina_tpu.intersect import cast_closest, cast_any


def _moller_reference(ro, rd, tris):
    '''Numpy nearest-hit oracle (same semantics as reference
    Face.intersect, ptina/geometries.py:117-148).'''
    n = ro.shape[0]
    best_t = np.full(n, 1e6)
    best_i = np.full(n, -1)
    best_uv = np.zeros((n, 2))
    for fi, (v0, v1, v2) in enumerate(tris):
        e1, e2 = v1 - v0, v2 - v0
        nrm = np.cross(e1, e2)
        b = rd @ nrm
        live = np.abs(b) >= 1e-6
        a = -(ro - v0) @ nrm
        t = np.where(live, a / np.where(live, b, 1.0), -1)
        p = ro + t[:, None] * rd
        w = p - v0
        uu, vv, uv = e1 @ e1, e2 @ e2, e1 @ e2
        wu, wv = w @ e1, w @ e2
        D = uv * uv - uu * vv
        s = (uv * wv - vv * wu) / D
        tt = (uv * wu - uu * wv) / D
        hit = live & (t > 0) & (s >= 0) & (s <= 1) & (tt >= 0) & (s + tt <= 1)
        better = hit & (t < best_t)
        best_t = np.where(better, t, best_t)
        best_i = np.where(better, fi, best_i)
        best_uv[better] = np.stack([s, tt], -1)[better]
    return best_t, best_i, best_uv


def _random_scene(rng, nf=16):
    tris = rng.randn(nf, 3, 3).astype(np.float32)
    return tris


def test_cast_matches_numpy_oracle():
    rng = np.random.RandomState(42)
    tris = _random_scene(rng, 16)
    ro = rng.randn(64, 3).astype(np.float32) * 3
    rd = rng.randn(64, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)

    m = precompute_tri_functionals(jnp.asarray(tris))
    hit = cast_closest(jnp.asarray(ro), jnp.asarray(rd), m,
                       jnp.full(64, -1, jnp.int32))

    rt, ri, ruv = _moller_reference(ro, rd, tris)
    got_i = np.asarray(hit.index)
    got_t = np.asarray(hit.t)
    hits = ri >= 0
    assert (got_i == ri).mean() > 0.98  # ties on shared edges may differ
    same = got_i == ri
    assert np.allclose(got_t[hits & same], rt[hits & same], rtol=1e-3, atol=1e-4)
    got_uv = np.stack([np.asarray(hit.u), np.asarray(hit.v)], -1)
    assert np.allclose(got_uv[hits & same], ruv[hits & same],
                       rtol=1e-2, atol=1e-3)


def test_avoid_excludes_face():
    tris = np.asarray([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32)
    m = precompute_tri_functionals(jnp.asarray(tris))
    # pad to tile alignment is not needed (tile = min(tile, F))
    ro = jnp.asarray([[0.0, 0.0, -2.0]])
    rd = jnp.asarray([[0.0, 0.0, 1.0]])
    hit = cast_closest(ro, rd, m, jnp.asarray([-1], jnp.int32))
    assert bool(hit.hit[0]) and abs(float(hit.t[0]) - 2.0) < 1e-5
    hit2 = cast_closest(ro, rd, m, jnp.asarray([0], jnp.int32))
    assert not bool(hit2.hit[0])


def test_cast_any_tmax():
    tris = np.asarray([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float32)
    m = precompute_tri_functionals(jnp.asarray(tris))
    ro = jnp.asarray([[0.0, 0.0, -2.0]])
    rd = jnp.asarray([[0.0, 0.0, 1.0]])
    avoid = jnp.asarray([-1], jnp.int32)
    assert bool(cast_any(ro, rd, m, avoid, jnp.asarray([5.0]))[0])
    assert not bool(cast_any(ro, rd, m, avoid, jnp.asarray([1.5]))[0])


def test_degenerate_padding_never_hits():
    tris = np.zeros((4, 3, 3), np.float32)
    tris[0] = [[-1, -1, 0], [1, -1, 0], [0, 1, 0]]
    m = precompute_tri_functionals(jnp.asarray(tris))
    ro = jnp.asarray([[0.0, 0.0, -2.0]])
    rd = jnp.asarray([[0.0, 0.0, 1.0]])
    hit = cast_closest(ro, rd, m, jnp.asarray([-1], jnp.int32))
    assert int(hit.index[0]) == 0


def test_far_clip_hit_is_miss():
    '''A hit at t >= INF (1e6) is a MISS in every cast implementation:
    brute rejects it via t < INF, and the GPU kernels (here in interpret
    mode) must not report it either — far geometry shadowed instead of
    sampling the environment.'''
    from ptina_tpu.intersect import brute
    from ptina_tpu.intersect.triton_cast import (
        triton_cast_closest, triton_cast_any)
    from ptina_tpu.utils.vec import V3

    # one huge triangle 2e6 away, perpendicular to +z
    tris = np.asarray([[[-4e6, -4e6, 2e6], [4e6, -4e6, 2e6],
                        [0.0, 4e6, 2e6]]], np.float32)
    m = precompute_tri_functionals(jnp.asarray(tris))
    ro = V3.from_array(jnp.zeros((8, 3)))
    rd = V3.from_array(jnp.asarray([[0.0, 0.0, 1.0]] * 8))
    avoid = jnp.full(8, -1, jnp.int32)

    ref = brute.cast_closest(ro, rd, m, avoid)
    assert not np.asarray(ref.hit).any()
    hit = triton_cast_closest(ro, rd, m, avoid, interpret=True)
    assert not np.asarray(hit.hit).any()
    # a far-clip miss must not occlude, even for tmax beyond INF
    tmax = jnp.full(8, 3e6)
    assert not np.asarray(brute.cast_any(ro, rd, m, avoid, tmax)).any()
    occ = triton_cast_any(ro, rd, m, avoid, tmax, interpret=True)
    assert not np.asarray(occ).any()
