import numpy as np
import jax
import jax.numpy as jnp

from ptina_tpu.scenes import cornell_box
from ptina_tpu.film import new_film, film_to_image
from ptina_tpu.engine.path import render_sample


def _loss(fac, scene, film):
    sc = scene.replace(materials=scene.materials.replace(fac=fac))
    out = render_sample(sc, film, 0)
    img = film_to_image(out)[..., :3]
    return jnp.mean(img)


def test_material_gradients_match_finite_difference():
    '''Pixel gradients w.r.t. the Disney material factors: autodiff vs
    central finite differences on the white wall basecolor.'''
    scene = cornell_box()
    film = new_film(8, 8)
    fac = scene.materials.fac

    g = jax.grad(_loss)(fac, scene, film)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    # perturb white material (row 0) basecolor red channel (param 0, ch 0)
    eps = 1e-2
    idx = (0, 0, 0)
    fp = fac.at[idx].add(eps)
    fm = fac.at[idx].add(-eps)
    lp = float(_loss(fp, scene, film))
    lm = float(_loss(fm, scene, film))
    fd = (lp - lm) / (2 * eps)
    assert fd > 0  # more albedo -> brighter
    assert abs(g[idx] - fd) < 0.05 * max(abs(fd), 1e-3)


def test_texture_gradients_match_finite_difference():
    '''North-star capability (BASELINE.md): pixel gradients w.r.t.
    TEXTURE texels — autodiff through diff.texture_grad on the matball
    roughness-texture scene vs central finite differences at the
    highest-gradient texel.  (The reference has no gradients at all.)'''
    from ptina_tpu.scenes import matball
    from ptina_tpu.diff import texture_grad, image_loss

    tex = np.full((8, 8, 3), 0.5, np.float32)
    scene = matball(roughness_tex=tex)
    target = jnp.zeros((8, 8, 3))
    loss, g = texture_grad(scene, target)
    g = np.asarray(g)
    assert np.isfinite(g).all() and float(loss) > 0

    xi, yi = np.unravel_index(np.abs(g[0, :, :, 0]).argmax(),
                              g[0, :, :, 0].shape)
    eps = 1e-2
    data = scene.textures.data

    def loss_at(d):
        sc = scene.replace(textures=scene.textures.replace(data=d))
        return float(image_loss(sc, target))

    fd = (loss_at(data.at[0, xi, yi, 0].add(eps))
          - loss_at(data.at[0, xi, yi, 0].add(-eps))) / (2 * eps)
    ad = g[0, xi, yi, 0]
    assert abs(ad - fd) < 0.05 * max(abs(fd), 1e-4), (ad, fd)


def test_texture_gradient_localization():
    '''Gradient mass must be CONCENTRATED on texels the camera actually
    sees: the roughness texture is read only at UVs of visible sphere
    points, so a minority of texels carry it, only channel 0 (the
    channel the scalar-parameter fetch reads) participates, and the
    rest are exactly zero.'''
    from ptina_tpu.scenes import matball
    from ptina_tpu.diff import texture_grad

    tex = np.full((8, 8, 3), 0.5, np.float32)
    scene = matball(roughness_tex=tex)
    _, g = texture_grad(scene, jnp.zeros((8, 8, 3)))
    g = np.asarray(g)
    # only the fetched channel participates
    assert np.abs(g[0, :, :, 1:]).sum() == 0
    ch0 = np.abs(g[0, :, :, 0])
    assert ch0.sum() > 0
    frac = (ch0 > 1e-3 * ch0.max()).mean()
    assert 0.02 < frac < 0.75, frac  # localized, not smeared everywhere


def test_world_fac_gradient_matches_fd():
    '''Gradients through the environment light: an open scene where most
    paths escape to the constant world color.'''
    from ptina_tpu.scene import make_scene
    verts = np.zeros((6, 8), np.float32)
    verts[:, 0:3] = [[-3, 0, 3], [3, 0, 3], [3, 0, -3],
                     [-3, 0, 3], [3, 0, -3], [-3, 0, -3]]
    verts[:, 4] = 1.0
    scene = make_scene(verts)
    film = new_film(8, 8)

    def loss(wf):
        sc = scene.replace(world_fac=wf)
        img = film_to_image(render_sample(sc, film, 0))[..., :3]
        return jnp.mean(img)

    g = np.asarray(jax.grad(loss)(scene.world_fac))
    assert np.isfinite(g).all() and abs(g[0]) > 0
    eps = 1e-2
    wf = scene.world_fac
    fd = (float(loss(wf.at[0].add(eps)))
          - float(loss(wf.at[0].add(-eps)))) / (2 * eps)
    assert abs(g[0] - fd) < 0.05 * max(abs(fd), 1e-4), (g[0], fd)


def test_light_color_gradient_matches_fd():
    '''Gradients through the analytic light pool's emission color (both
    the direct-hit MIS term and NEE read it).'''
    scene = cornell_box()
    film = new_film(8, 8)

    def loss(color):
        sc = scene.replace(lights=scene.lights.replace(color=color))
        img = film_to_image(render_sample(sc, film, 0))[..., :3]
        return jnp.mean(img)

    g = np.asarray(jax.grad(loss)(scene.lights.color))
    assert np.isfinite(g).all() and abs(g[0, 0]) > 0
    eps = 1e-1
    c = scene.lights.color
    fd = (float(loss(c.at[0, 0].add(eps)))
          - float(loss(c.at[0, 0].add(-eps)))) / (2 * eps)
    assert abs(g[0, 0] - fd) < 0.05 * max(abs(fd), 1e-5), (g[0, 0], fd)


def test_gradient_nonzero_only_for_used_params():
    scene = cornell_box()
    film = new_film(8, 8)
    g = np.asarray(jax.grad(_loss)(scene.materials.fac, scene, film))
    # basecolor of the white material participates
    assert np.abs(g[0, 0, :3]).sum() > 0
    # channel 3 (alpha) of basecolor is unused by shading
    assert np.abs(g[:, 0, 3]).sum() == 0
