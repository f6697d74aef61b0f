import numpy as np
import jax.numpy as jnp

from ptina_tpu.scene import make_lights, LIGHT_POINT, LIGHT_AREA
from ptina_tpu.lights import lights_hit, lights_sample
from ptina_tpu.utils.vec import V3


def _v3(a):
    return V3.from_array(jnp.asarray(a, jnp.float32))
from ptina_tpu.film import new_film, film_add, film_splat, film_to_image
from ptina_tpu.lights import ray_sphere, ray_rect
from ptina_tpu.intersect.lbvh import ray_aabb


def test_ray_aabb():
    ro = jnp.asarray([[0.0, 0.0, -5.0], [3.0, 0.0, -5.0], [0.5, 0.5, 0.5]])
    rd = jnp.asarray([[0.0, 0.0, 1.0]] * 3)
    lo = jnp.asarray([-1.0, -1.0, -1.0])
    hi = jnp.asarray([1.0, 1.0, 1.0])
    hit, near, far = ray_aabb(ro, rd, lo, hi, jnp.full(3, 1e6))
    assert bool(hit[0])
    assert abs(float(near[0]) - 4.0) < 1e-5
    assert abs(float(far[0]) - 6.0) < 1e-5
    assert not bool(hit[1])
    assert bool(hit[2])  # origin inside: near clamps to 0
    assert float(near[2]) == 0.0
    assert abs(float(far[2]) - 0.5) < 1e-5


def test_ray_sphere():
    ro = _v3([[0.0, 0.0, -5.0]])
    rd = _v3([[0.0, 0.0, 1.0]])
    t = ray_sphere(ro, rd, _v3([[0.0, 0.0, 0.0]]), jnp.asarray(1.0))
    assert abs(float(t[0]) - 4.0) < 1e-5


def test_ray_rect_one_sided():
    pos = _v3([[0.0, 0.0, 0.0]])
    dirx = _v3([[1.0, 0.0, 0.0]])
    diry = _v3([[0.0, 1.0, 0.0]])
    # normal = dirx x diry = +z; visible when ray.d . n > 0
    ro = _v3([[0.2, 0.2, -3.0], [0.2, 0.2, 3.0]])
    rd = _v3([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    hit, t = ray_rect(ro, rd, pos, dirx, diry)
    assert bool(hit[0]) and abs(float(t[0]) - 3.0) < 1e-5
    assert not bool(hit[1])


def test_lights_hit_point():
    lights = make_lights()  # default point light at (1,2,3), r=0.5
    ro = jnp.asarray([[1.0, 2.0, 0.0]])
    rd = jnp.asarray([[0.0, 0.0, 1.0]])
    out = lights_hit(lights, _v3(ro), _v3(rd))
    assert bool(out['hit'][0])
    assert abs(float(out['dis'][0]) - 2.5) < 1e-4
    # pdf = dis^2 / (pi r^2)
    assert abs(float(out['pdf'][0]) - 2.5 ** 2 / (np.pi * 0.25)) < 1e-2


def test_lights_sample_area_cosine():
    axes = np.eye(3)
    lights = make_lights([dict(color=(10, 10, 10), pos=(0, 0, 2), size=1.0,
                               type=LIGHT_AREA, axes=axes)])
    hitpos = jnp.asarray([[0.0, 0.0, 0.0]])
    # samp (0.5, 0.5, 0.1): center of the rect
    out = lights_sample(lights, _v3(hitpos), jnp.asarray([0.5]),
                        jnp.asarray([0.5]), jnp.asarray([0.1]))
    assert abs(float(out['dis'][0]) - 2.0) < 1e-5
    # pdf = dis^2/area = 4/4 = 1; color = 10/1 * cos(normal=+z, dir=+z)=10
    assert abs(float(out['pdf'][0]) - 1.0) < 1e-5
    assert np.allclose(np.asarray(out['color'].to_array()[0]), 10.0, atol=1e-4)


def test_lights_hit_nearest_wins():
    # Two lights on the same ray, the NEARER one listed SECOND: the
    # reference's first-hit-wins scan would return the farther slot-0
    # light; this framework deliberately keeps the nearest (see
    # lights.lights_hit docstring).  Both implementations must agree.
    lights = make_lights([
        dict(color=(1, 0, 0), pos=(0, 0, 8), size=0.5, type=LIGHT_POINT),
        dict(color=(0, 1, 0), pos=(0, 0, 3), size=0.5, type=LIGHT_POINT),
    ])
    ro = _v3(jnp.zeros((1, 3)))
    rd = _v3(jnp.asarray([[0.0, 0.0, 1.0]]))
    out = lights_hit(lights, ro, rd)
    assert bool(out['hit'][0])
    assert abs(float(out['dis'][0]) - 2.5) < 1e-4  # 3 - 0.5 radius
    assert np.allclose(np.asarray(out['color'].to_array()[0]), [0, 1, 0])


def test_lights_sample_empty_pool():
    lights = make_lights([], default_light=False)
    half = jnp.full((4,), 0.5)
    out = lights_sample(lights, _v3(jnp.zeros((4, 3))), half, half, half)
    assert (np.asarray(out['pdf']) == 0).all()
    assert (np.asarray(out['color'].to_array()) == 0).all()


def test_film_accumulate_and_image():
    film = new_film(4, 4)
    one = jnp.ones((4, 4))
    film = film_add(film, 0, one, one, one, one)
    film = film_add(film, 0, 3.0 * one, 3.0 * one, 3.0 * one, one)
    img = np.asarray(film_to_image(film, 0))
    assert np.allclose(img[..., :3], 2.0)  # (1+3)/2 samples
    # untouched pass renders debug pink
    img1 = np.asarray(film_to_image(film, 1))
    assert np.allclose(img1[..., :3], [0.9, 0.4, 0.9])


def test_film_flat_rgb_export():
    from ptina_tpu.film import film_to_flat_rgb
    film = new_film(4, 6)
    r = jnp.arange(24, dtype=jnp.float32).reshape(4, 6)
    film = film_add(film, 0, r, 2.0 * r, 3.0 * r, jnp.ones((4, 6)))
    flat = np.asarray(film_to_flat_rgb(film, 0))
    # scanline (y-major) order of the normalized rgb, like the
    # reference's fast_export_image (ptina/filmtable.py:65-79)
    img = np.asarray(film_to_image(film, 0))
    ref = np.transpose(img[..., :3], (1, 0, 2)).reshape(-1)
    np.testing.assert_allclose(flat, ref, rtol=1e-6)
    # untouched pass exports zeros (GL blit wants black, not pink)
    assert (np.asarray(film_to_flat_rgb(film, 1)) == 0).all()


def test_film_splat_scatter():
    film = new_film(8, 8)
    xi = jnp.asarray([1, 1, 5], jnp.int32)
    yi = jnp.asarray([2, 2, 7], jnp.int32)
    one = jnp.ones((3,))
    film = film_splat(film, 0, xi, yi, one, one, one, one)
    assert float(film[0, 0, 1, 2]) == 2.0
    assert float(film[0, 0, 5, 7]) == 1.0
