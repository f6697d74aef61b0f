import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ptina_tpu.scenes import cornell_box
from ptina_tpu.film import new_film
from ptina_tpu.engine.path import render
from ptina_tpu.parallel import make_mesh, render_sharded, train_step_sharded


@pytest.fixture(scope='module')
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices (see conftest XLA_FLAGS)')
    return jax.devices()[:8]


def test_sharded_render_matches_single_device(eight_devices):
    scene = cornell_box()
    mesh = make_mesh(eight_devices)
    nx, ny = 16, 8
    single = render(scene, new_film(nx, ny), 0, spp=1)
    sharded = render_sharded(scene, new_film(nx, ny), 0, mesh, spp=1)
    assert np.allclose(np.asarray(single), np.asarray(sharded), atol=1e-5)


def test_sharded_render_is_collective_free(eight_devices):
    '''Rendering must stay communication-free at any mesh size — every
    device owns its film band outright.'''
    from ptina_tpu.parallel.sharding import _render_fn
    scene = cornell_box()
    mesh = make_mesh(eight_devices)
    nx, ny = 16, 8
    fn = _render_fn(mesh, nx, ny, 1)
    hlo = fn.lower(scene, new_film(nx, ny),
                   jnp.asarray(0, jnp.int32)).compile().as_text()
    for op in ('all-reduce', 'all-gather', 'all-to-all',
               'collective-permute', 'reduce-scatter'):
        assert op not in hlo, f'render HLO contains {op}'


def test_init_distributed_single_process_noop():
    from ptina_tpu.parallel import init_distributed, is_distributed
    assert init_distributed() is False  # no coordinator configured
    assert is_distributed() is False


def test_sharded_gradients_equal_single_device(eight_devices):
    '''The psum'd data-parallel material gradient must EQUAL the
    single-device gradient of the same full-film loss (equal-size film
    bands make the pmean of local means the global mean), not merely
    descend.'''
    from ptina_tpu.film import film_to_image
    from ptina_tpu.engine.path import render_sample

    scene = cornell_box()
    mesh = make_mesh(eight_devices)
    nx, ny = 16, 8
    target = jnp.zeros((nx, ny, 3))
    film0 = new_film(nx, ny)
    lr = 0.1
    s1, _ = train_step_sharded(scene, film0, target, 0, mesh, lr=lr)
    g_sharded = (np.asarray(scene.materials.fac)
                 - np.asarray(s1.materials.fac)) / lr

    def full_loss(fac):
        sc = scene.replace(materials=scene.materials.replace(fac=fac))
        film = render_sample(sc, film0, 0)
        img = film_to_image(film)[..., :3]
        return jnp.mean((img - target) ** 2)

    g_single = np.asarray(jax.grad(full_loss)(scene.materials.fac))
    assert np.abs(g_single).max() > 0
    assert np.allclose(g_sharded, g_single, rtol=1e-3,
                       atol=1e-6 * max(np.abs(g_single).max(), 1e-9))


def test_train_step_sharded_runs_and_descends(eight_devices):
    scene = cornell_box()
    mesh = make_mesh(eight_devices)
    nx, ny = 16, 8
    target = jnp.zeros((nx, ny, 3))
    film0 = new_film(nx, ny)
    s1, l1 = train_step_sharded(scene, film0, target, 0, mesh, lr=0.1)
    s2, l2 = train_step_sharded(s1, film0, target, 0, mesh, lr=0.1)
    assert np.isfinite(float(l1)) and np.isfinite(float(l2))
    assert float(l2) <= float(l1) + 1e-3  # same sample index -> descends
