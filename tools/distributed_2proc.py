'''
Two-process jax.distributed check, on the CPU.

This is a CPU tool: it pins both worker processes to the CPU platform
with one XLA:CPU device each, so it never competes for an accelerator.
The launcher picks a free localhost port for the coordinator, then
starts two `jax.distributed` worker processes that render one film
row-sharded over the 2-process global mesh
(parallel/sharding.render_sharded) and check their bands against a
local single-process render of the same frame.  It exercises the real
multi-process runtime (coordinator, global mesh, cross-process arrays);
it measures no rate, because a CPU run cannot give one.

Usage:
    python tools/distributed_2proc.py --res 64 --spp 2 [--out result.json]
'''

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def worker_env():
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    env['XLA_FLAGS'] = '--xla_force_host_platform_device_count=1'
    return env


def run_worker(args):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, REPO)
    from ptina_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()
    # must run before ANY backend-initialising jax call (including the
    # first jnp array the scene builder creates)
    from ptina_tpu.parallel.distributed import (init_distributed,
                                                is_distributed, global_mesh)
    active = init_distributed(
        coordinator_address=f'localhost:{args.port}',
        num_processes=2, process_id=args.process_id)
    assert active, 'distributed runtime not active'

    import numpy as np
    from ptina_tpu.scenes import cornell_box
    from ptina_tpu.film import new_film
    from ptina_tpu.engine.path import render
    from ptina_tpu.parallel.sharding import render_sharded

    assert is_distributed()
    assert jax.process_count() == 2
    assert len(jax.devices()) == 2, 'expected 1 device per process'

    res, spp = args.res, args.spp
    scene = cornell_box()
    film = render_sharded(scene, np.asarray(new_film(res, res)), 0,
                          global_mesh(), spp=spp)
    local = np.asarray(render(scene, new_film(res, res), 0, spp=spp, spb=1))
    band_ok = True
    for shard in film.addressable_shards:
        band_ok &= bool(np.allclose(np.asarray(shard.data),
                                    local[shard.index],
                                    rtol=1e-5, atol=1e-5))
    print(json.dumps({'role': f'worker{args.process_id}',
                      'band_ok': band_ok,
                      'process_count': jax.process_count()}), flush=True)


def launch(args):
    port = free_port()
    cmd = [sys.executable, os.path.abspath(__file__), '--res', str(args.res),
           '--spp', str(args.spp), '--port', str(port)]
    procs = [subprocess.Popen(cmd + ['--process-id', str(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=worker_env(), cwd=REPO)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=900)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads([l for l in out.splitlines()
                                    if l.startswith('{')][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    result = {
        'procs': 2,
        'devices_per_proc': 1,
        'res': args.res,
        'spp': args.spp,
        'band_allclose': all(o['band_ok'] for o in outs),
        'process_count_seen': [o['process_count'] for o in outs],
    }
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--res', type=int, default=64)
    ap.add_argument('--spp', type=int, default=2)
    ap.add_argument('--process-id', type=int, default=None)
    ap.add_argument('--port', type=int, default=None)
    ap.add_argument('--out', default=None, help='also write the result '
                    'JSON to this path')
    args = ap.parse_args()
    if args.process_id is not None:
        run_worker(args)
    else:
        launch(args)


if __name__ == '__main__':
    main()
