'''
Persistent XLA compilation cache.

The wavefront render graphs take seconds to minutes to compile, so every
entry point (bench.py, chip_smoke.py, __graft_entry__.py, the test
suite, tools) keeps compiled executables on disk.  The directory is
JAX_COMPILATION_CACHE_DIR when that is set; otherwise `.jax_cache/` at
the repository root, a fixed path, because the path is part of the
cache's key.
'''

import os

__all__ = ['compile_cache_dir', 'setup_compile_cache']

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir():
    return (os.environ.get('JAX_COMPILATION_CACHE_DIR')
            or os.path.join(_REPO, '.jax_cache'))


def setup_compile_cache():
    '''Point JAX's persistent cache at compile_cache_dir(); returns it.'''
    import jax
    path = compile_cache_dir()
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.3)
    return path
