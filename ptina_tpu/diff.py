'''
Differentiable rendering utilities.

The new capability the reference lacks entirely: pixel gradients with
respect to material factors and textures via autodiff through the
shading path (intersections detached — see engine/path.get_geometries).

Typical use: inverse-rendering a material to match a target image.
'''

import functools

import jax
import jax.numpy as jnp

from ptina_tpu.engine.path import render_sample
from ptina_tpu.film import new_film, film_to_image

__all__ = ['render_image_diff', 'image_loss', 'material_grad',
           'texture_grad', 'inverse_render_step']


def render_image_diff(scene, nx, ny, sample_index=0, spp=1):
    '''Differentiable render: returns the [nx, ny, 3] mean-radiance image
    as a traced function of the scene pytree, differentiating straight
    through the wavefront integrator.'''
    film = new_film(nx, ny)
    for s in range(spp):
        film = render_sample(scene, film, sample_index + s)
    return film_to_image(film)[..., :3]


def image_loss(scene, target, sample_index=0, spp=1):
    '''MSE against a target image [nx, ny, 3].'''
    img = render_image_diff(scene, target.shape[0], target.shape[1],
                            sample_index, spp)
    return jnp.mean((img - target) ** 2)


@functools.partial(jax.jit, static_argnames=('spp',))
def material_grad(scene, target, sample_index=0, spp=1):
    '''d(loss)/d(material factors): [M+1, 12, 4].'''
    def f(fac):
        sc = scene.replace(materials=scene.materials.replace(fac=fac))
        return image_loss(sc, target, sample_index, spp)
    return jax.value_and_grad(f)(scene.materials.fac)


@functools.partial(jax.jit, static_argnames=('spp',))
def texture_grad(scene, target, sample_index=0, spp=1):
    '''d(loss)/d(texture atlas texels): [T, H, W, 4].'''
    def f(data):
        sc = scene.replace(textures=scene.textures.replace(data=data))
        return image_loss(sc, target, sample_index, spp)
    return jax.value_and_grad(f)(scene.textures.data)


@functools.partial(jax.jit, static_argnames=('spp',))
def inverse_render_step(scene, target, sample_index=0, spp=1, lr=0.1):
    '''One SGD step on the material factors toward the target image.
    Returns (scene', loss).'''
    loss, g = material_grad(scene, target, sample_index, spp)
    fac = scene.materials.fac - lr * g
    return scene.replace(materials=scene.materials.replace(fac=fac)), loss
