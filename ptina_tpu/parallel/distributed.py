'''
Multi-host entry hooks.

The reference is single-process/single-GPU.  The design needs nothing
new at multi-host scale — the film's row axis just spans a mesh whose
devices live on several hosts, rendering stays communication-free
(parallel/sharding.py) and gradient all-reduces cross the host network —
but each host process must join the jax.distributed runtime before any
device use.  This module is that hook.
'''

import os

import jax

__all__ = ['init_distributed', 'global_mesh', 'is_distributed']

_initialized = False


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kw):
    '''Join (or bootstrap) a multi-host jax runtime.

    With no arguments, reads the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) and
    no-ops in single-process runs.  Safe to call more than once.
    Returns True if a multi-process runtime is active.'''
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        'JAX_COORDINATOR_ADDRESS')
    if num_processes is None:
        env = os.environ.get('JAX_NUM_PROCESSES')
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get('JAX_PROCESS_ID')
        process_id = int(env) if env else None
    # join only on explicit configuration: jax.distributed.initialize()
    # without a coordinator fails where no cluster is detected
    if coordinator_address or num_processes:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kw)
        _initialized = True
    return jax.process_count() > 1


def is_distributed():
    return jax.process_count() > 1


def global_mesh(axis='rays'):
    '''1-D mesh over every device of every participating host (call
    init_distributed first in multi-host runs).  Shard films over this
    and per-host bands fall out automatically: jax places each host's
    film rows on its local chips, renders locally, and only gradient
    all-reduces cross hosts.'''
    from ptina_tpu.parallel.sharding import make_mesh
    return make_mesh(jax.devices(), axis=axis)
