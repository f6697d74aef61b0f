'''
Tracing / profiling / structured logging.

The reference has no profiling beyond wall-clock prints with subsystem
prefixes ("[TinaBVH] ...", SURVEY.md §5).  Here:

  * `log(subsystem, msg)` — the same prefixed console logging, with a
    global verbosity switch;
  * `timed(name)` — context manager measuring wall-clock (with
    block_until_ready on exit so device work is included);
  * `profile_trace(dir)` — context manager around jax.profiler for
    traces of the device execution.
'''

import contextlib
import time

import jax

__all__ = ['log', 'set_verbosity', 'timed', 'profile_trace', 'timings']

_VERBOSITY = 1
timings = {}  # name -> [seconds, ...] of all `timed` blocks


def set_verbosity(level):
    '''0 = silent, 1 = info (default), 2 = debug.'''
    global _VERBOSITY
    _VERBOSITY = int(level)


def log(subsystem, msg, level=1):
    if _VERBOSITY >= level:
        print(f'[{subsystem}] {msg}')


@contextlib.contextmanager
def timed(name, sync=None, quiet=False):
    '''Measure a block; pass sync=array/pytree to block on device work.'''
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if sync is not None:
            jax.block_until_ready(sync)
        elif 'sync' in box:
            jax.block_until_ready(box['sync'])
        dt = time.perf_counter() - t0
        timings.setdefault(name, []).append(dt)
        if not quiet:
            log('Timing', f'{name}: {dt * 1e3:.2f} ms', level=2)


@contextlib.contextmanager
def profile_trace(logdir='/tmp/ptina_trace'):
    '''Capture an xprof trace of everything inside the block.'''
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
        log('Trace', f'profile written to {logdir}')
