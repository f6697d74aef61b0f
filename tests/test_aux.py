'''Auxiliary subsystems: tone mapping, array codec, orbit camera,
params registry, daemon thread shim, middle-split BVH.'''

import numpy as np
import jax.numpy as jnp

from ptina_tpu.tone import tonemap_filmic, tonemap_aces, apply_exposure_gamma
from ptina_tpu.io.encoding import encode_numpy_array, decode_numpy_array
from ptina_tpu.utils.control import CamControl
from ptina_tpu.utils.params import Params
from ptina_tpu.utils import daemon


def test_tonemaps_monotone_and_bounded():
    x = jnp.linspace(0.0, 20.0, 256)
    rgb = jnp.stack([x, x, x], -1)
    for f in (tonemap_filmic, tonemap_aces):
        y = np.asarray(f(rgb))[:, 0]
        assert (np.diff(y) >= -1e-6).all()
        assert y.min() >= 0.0 and y.max() <= 1.0 + 1e-6
    g = np.asarray(apply_exposure_gamma(rgb, exposure=2.0))
    assert np.isfinite(g).all()


def test_encoding_roundtrip():
    rng = np.random.RandomState(0)
    for arr in [rng.randn(17, 3).astype(np.float32),
                rng.randint(0, 255, (5, 5), np.uint8),
                np.arange(7, dtype=np.int64)]:
        text = encode_numpy_array(arr)
        back = decode_numpy_array(text)
        assert back.dtype == arr.dtype and back.shape == arr.shape
        assert np.array_equal(back, arr)


def test_cam_control_produces_valid_matrix():
    cam = CamControl(radius=3.0)
    m0 = cam.matrix(aspect=1.0)
    assert m0.shape == (4, 4) and np.isfinite(m0).all()
    cam.orbit(0.1, 0.05)
    cam.pan(0.02, -0.01)
    cam.zoom(2)
    m1 = cam.matrix(aspect=1.5)
    assert np.isfinite(m1).all()
    assert not np.allclose(m0, m1)
    # zooming in shrinks the radius
    assert cam.radius < 3.0


def test_params_registry():
    p = Params()
    p.add('roughness', 0.4, 0.0, 1.0)
    assert p.get('roughness') == 0.4
    p.set('roughness', 2.0)  # clamped
    assert p.get('roughness') == 1.0
    assert list(p.items()) == [('roughness', 1.0, 0.0, 1.0)]


def test_daemon_module_serializes_calls():
    import types
    mod = types.SimpleNamespace()
    mod.calls = []
    mod.record = lambda x: (mod.calls.append(x), x * 2)[1]
    dm = daemon.DaemonModule(mod)
    assert dm.record(21) == 42
    assert mod.calls == [21]

    def boom():
        raise ValueError('boom')
    mod.boom = boom
    try:
        dm.boom()
        raised = False
    except ValueError:
        raised = True
    assert raised
    dm.stop()


def test_middlebvh_matches_brute():
    from ptina_tpu.scene import precompute_tri_functionals
    from ptina_tpu.intersect.brute import cast_closest
    from ptina_tpu.intersect.lbvh import lbvh_traverse
    from ptina_tpu.intersect.middlebvh import middlebvh_build
    from ptina_tpu.utils.vec import V3

    rng = np.random.RandomState(7)
    tris = jnp.asarray(rng.randn(48, 3, 3).astype(np.float32))
    m = precompute_tri_functionals(tris)
    bvh = middlebvh_build(tris)

    nr = 96
    ro = rng.randn(nr, 3).astype(np.float32) * 4
    rd = rng.randn(nr, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    avoid = jnp.full((nr,), -1, jnp.int32)

    hb = cast_closest(V3.from_array(jnp.asarray(ro)),
                      V3.from_array(jnp.asarray(rd)), m, avoid)
    ht = lbvh_traverse(bvh, m, jnp.asarray(ro), jnp.asarray(rd), avoid)
    same = np.asarray(hb.index) == np.asarray(ht.index)
    assert same.mean() > 0.97
    hits = np.asarray(hb.hit) & same
    assert np.allclose(np.asarray(hb.t)[hits], np.asarray(ht.t)[hits],
                       rtol=1e-4, atol=1e-4)
