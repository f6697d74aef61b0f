'''
Generate the committed golden renders for tests/test_parity.py.

Goldens are low-res, high-spp path-engine renders of the two benchmark
scenes (the repo's own converged references — the reference project has
no stored goldens at all, only an eyeball check,
/root/reference/exams/coverage.py:24-29).  Stored via io/encoding.py as
base85 text under tests/golden/.

Run on CPU for platform-stable generation:
    python tools/make_golden.py
'''

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

os.environ['JAX_PLATFORMS'] = 'cpu'

import numpy as np  # noqa: E402

RES = 64
SPP = 512
OUT = os.path.join(os.path.dirname(__file__), '..', 'tests', 'golden')


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from ptina_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()
    from ptina_tpu.scenes import cornell_box, cornell_monkey
    from ptina_tpu.film import new_film, film_to_image
    from ptina_tpu.engine.path import render
    from ptina_tpu.io.encoding import encode_numpy_array

    os.makedirs(OUT, exist_ok=True)
    for name, build in (('cornell', cornell_box),
                        ('cornell_monkey', cornell_monkey)):
        scene = build()
        film = new_film(RES, RES)
        film = render(scene, film, 0, spp=SPP)
        img = np.asarray(film_to_image(film))[..., :3].astype(np.float32)
        path = os.path.join(OUT, f'{name}_{RES}x{RES}_{SPP}spp.txt')
        with open(path, 'w') as f:
            f.write(encode_numpy_array(img))
        print(f'{name}: mean={img.mean():.5f} -> {path}')


if __name__ == '__main__':
    main()
