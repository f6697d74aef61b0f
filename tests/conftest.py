'''
Test configuration: the CPU platform with 8 virtual devices, so the
whole suite (including the sharding tests) runs without an accelerator.
Must run before jax is imported anywhere.

Tests marked `gpu` need the card and take the `gpu` fixture, which skips
them elsewhere.  On a machine with the card they run with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
'''

import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
_flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (_flags + ' --xla_force_host_platform_device_count=8').strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

from ptina_tpu.utils.cache import setup_compile_cache  # noqa: E402

# Persistent compilation cache: the suite is compile-dominated (every
# engine variant traces a 5-bounce wavefront graph), so cache compiled
# executables across test processes and reruns.
setup_compile_cache()


@pytest.fixture
def gpu():
    '''Skip unless JAX's default device is a GPU.'''
    if jax.devices()[0].platform != 'gpu':
        pytest.skip('needs a GPU (chip_smoke.py covers this on the card)')
