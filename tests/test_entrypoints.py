'''
The entry points around the renderer: the compile-cache location they
share, and the GPU-only scripts refusing to run without a GPU.
'''

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from ptina_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('env_dir', [None, 'cache-from-env'])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    '''JAX_COMPILATION_CACHE_DIR when set, else .jax_cache/ at the
    repository root — a fixed path, whatever the process.'''
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        expected = os.path.join(REPO, '.jax_cache')
    else:
        expected = str(tmp_path / env_dir)
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', expected)
    try:
        assert cache.compile_cache_dir() == expected
        assert cache.setup_compile_cache() == expected
        assert jax.config.jax_compilation_cache_dir == expected
    finally:
        jax.config.update('jax_compilation_cache_dir', before)


def _run(script_dir, script, *args):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, script, *args], cwd=script_dir,
                          capture_output=True, text=True, timeout=240,
                          env=env)


def _no_ok_line(r):
    lines = [l for l in r.stdout.splitlines() if l.startswith('{')]
    return not any(json.loads(l).get('ok') for l in lines)


@pytest.mark.parametrize('args', [(), ('--four-cards',)])
def test_chip_smoke_refuses_cpu(args):
    r = _run(REPO, 'chip_smoke.py', *args)
    assert r.returncode != 0
    assert _no_ok_line(r) and r.stdout == ''
    assert 'needs a GPU' in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    '''Copied away from the repository, the script has no renderer to
    run and must fail without a verdict.'''
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    r = _run(str(tmp_path), 'chip_smoke.py')
    assert r.returncode != 0 and _no_ok_line(r)


def test_bench_refuses_cpu():
    r = _run(REPO, 'bench.py')
    assert r.returncode != 0 and r.stdout == ''
    assert 'needs a GPU' in r.stderr


def test_bench_lines_carry_device_stamp(capsys, monkeypatch):
    sys.path.insert(0, REPO)
    import bench
    with pytest.raises(SystemExit):
        bench._device()  # the suite runs on the CPU
    monkeypatch.setattr(bench, '_device', lambda: {
        'platform': 'gpu', 'device_kind': 'H100', 'device_count': 1})
    bench._emit('sps_example', 12.5, 2.5)
    row = json.loads(capsys.readouterr().out)
    assert row == {'metric': 'sps_example', 'value': 12.5,
                   'unit': 'samples/s', 'vs_baseline': 5.0,
                   'platform': 'gpu', 'device_kind': 'H100',
                   'device_count': 1}
