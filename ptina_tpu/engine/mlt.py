'''
Primary-sample-space Metropolis light transport.

Counterpart of the reference MLTPathEngine (ptina/engine/mltpath.py):
parallel Markov chains over a 32-dim primary sample space; each step
proposes either a large step (fresh uniforms, prob LSP) or a Gaussian
mutation (sigma, wrapped mod 1), replays the path integrator with the
chain's uniforms as the random stream, splats into the film, and
Metropolis-accepts on luminance ratio.

Differences from the reference:
  * chains are a dimension-major [D, C] array advanced by one jitted
    step — the reference's per-thread loop becomes whole-array ops, and
    each primary-sample dimension is a dense row feeding the SoA
    integrator directly;
  * cached radiance is a V3 of [C] rows;
  * film splats are deterministic scatter-adds (film_splat) instead of
    racing atomics.

Estimator: the default mode='kelemen' is the standard normalized PSSMLT
estimator (Kelemen et al. 2002) the reference never finished — its
shipped engine splats raw proposal radiance with the normalization
commented out ("having bug", ptina/engine/mltpath.py:38-45), and its
wip two-way prototype (ptina/wip/metropolis.py:62-70) weights by
acceptance but still lacks brightness normalization (measured round 3:
58% brightness error on cornell).  Here every chain-step splats the
importance-COMPENSATED radiance L/lum(L) weighted by the acceptance
(new state) and its complement (current state), and the film's sample
count accumulates the uniform b-normalization C / (b * npixels) per
round, where b (mean image luminance) is estimated online from the
large-step proposals — which are exactly uniform samples of the primary
space.  film_to_image's rgb/w division then yields an actual radiance
estimate, quantitatively comparable to the path engine
(tests/test_mlt_quant.py).  mode='reference' reproduces the reference's
shipped unnormalized behavior for parity.
'''

import functools

from ptina_tpu.utils import struct
import jax
import jax.numpy as jnp

from ptina_tpu.utils.mathutils import normaldist
from ptina_tpu.utils.vec import V3, vavg3, vwhere
from ptina_tpu.camera import camera_rays
from ptina_tpu.engine.path import path_trace, PATH_DIMS
from ptina_tpu.film import film_splat

__all__ = ['MLTState', 'mlt_init', 'mlt_step', 'render_mlt']

LSP = 0.25    # large-step probability (reference mltpath.py:25-28)
SIGMA = 0.01  # mutation size


@struct.dataclass
class MLTState:
    x: jnp.ndarray      # [D, C] primary samples (dimension-major)
    l: V3               # cached radiance, [C] rows
    b_sum: jnp.ndarray  # [] running sum of large-step luminances
    b_cnt: jnp.ndarray  # [] number of large-step proposals seen
    step: jnp.ndarray   # [] i32 mutation-round counter (drives the
    # wang-hash proposal streams, cheaper than jax.random's threefry
    # for the same [D, C] block)


def mlt_init(key, nchains=2 ** 18, ndims=PATH_DIMS):
    '''Fresh chains (reference reset(), mltpath.py:30-36).  `key` seeds
    the initial primary samples; stepping uses counter-hashed streams.'''
    return MLTState(
        x=jax.random.uniform(key, (ndims, nchains)),
        l=V3(jnp.zeros((nchains,)), jnp.zeros((nchains,)),
             jnp.zeros((nchains,))),
        b_sum=jnp.zeros(()),
        b_cnt=jnp.zeros(()),
        step=jnp.zeros((), jnp.int32),
    )


def _replay(scene, x):
    '''Trace the path encoded by primary samples x [D, C]
    (reference mltpath.py:67-69: dims 0,1 are the lens) through the
    wavefront integrator, with the chain state as its random stream —
    the reference's chains run the same kernel as its path engine
    (mltpath.py:54-83).'''
    ro, rd = camera_rays(scene.cam_v2w, x[0] * 2.0 - 1.0, x[1] * 2.0 - 1.0)
    return path_trace(scene, ro, rd, x)


def mlt_step(scene, state, film, lsp=LSP, sigma=SIGMA, mode='kelemen'):
    '''One mutation round for every chain.  Returns (state, film).'''
    d, c = state.x.shape
    nx, ny = film.shape[2], film.shape[3]
    # counter-hashed proposal streams (sampling.hash_uniform family,
    # the same generator the pixel streams use): dims 0..d-1 are the
    # proposal block, d the large-step coin, d+1 the acceptance roll
    from ptina_tpu.sampling import hash_uniform
    chain = jnp.arange(c, dtype=jnp.int32)
    dim = jnp.arange(d + 2, dtype=jnp.int32)[:, None]
    # golden-ratio stride 0x9e3779b9 as its signed-i32 bit pattern
    u = hash_uniform(state.step * jnp.int32(-1640531527) + dim, chain)
    large = u[d] < lsp
    fresh = u[:d]
    mutated = jnp.mod(state.x + sigma * normaldist(fresh), 1.0)
    x_new = jnp.where(large[None, :], fresh, mutated)

    l_new = _replay(scene, x_new)

    al_new = vavg3(l_new) + 1e-10
    al_old = vavg3(state.l) + 1e-10
    accept = jnp.minimum(1.0, al_new / al_old)

    # online brightness estimate from the large-step (= uniform) proposals
    b_sum = state.b_sum + jnp.sum(jnp.where(large, al_new, 0.0))
    b_cnt = state.b_cnt + jnp.sum(large.astype(jnp.float32))
    b = b_sum / jnp.maximum(b_cnt, 1.0)

    def pix(x):
        xi = jnp.floor(x[0] * nx).astype(jnp.int32)
        yi = jnp.floor(x[1] * ny).astype(jnp.int32)
        return xi, yi

    if mode == 'reference':
        # shipped behavior (mltpath.py:47-52,75-76): splat the proposal
        # with unit importance
        xi, yi = pix(x_new)
        film = film_splat(film, 0, xi, yi, l_new.x, l_new.y, l_new.z,
                          jnp.ones((c,)))
    else:
        # Kelemen estimator: splat importance-compensated radiance
        # L/lum at both states, weighted by acceptance / its
        # complement; the normalization C / (b * npix) accumulates
        # uniformly in the sample-count channel so film_to_image's
        # rgb/w division produces actual radiance.  Both states ride
        # ONE concatenated scatter instead of two.
        w_new = accept / al_new
        w_old = (1.0 - accept) / al_old
        xi_n, yi_n = pix(x_new)
        xi_o, yi_o = pix(state.x)
        film = film_splat(
            film, 0,
            jnp.concatenate([xi_n, xi_o]), jnp.concatenate([yi_n, yi_o]),
            jnp.concatenate([l_new.x * w_new, state.l.x * w_old]),
            jnp.concatenate([l_new.y * w_new, state.l.y * w_old]),
            jnp.concatenate([l_new.z * w_new, state.l.z * w_old]),
            jnp.zeros((2 * c,)))
        film = film.at[0, 3].add(c / (b * nx * ny))

    take = u[d + 1] < accept
    return MLTState(
        x=jnp.where(take[None, :], x_new, state.x),
        l=vwhere(take, l_new, state.l),
        b_sum=b_sum,
        b_cnt=b_cnt,
        step=state.step + 1,
    ), film


@functools.partial(jax.jit,
                   static_argnames=('steps', 'mode'),
                   donate_argnames=('state', 'film'))
def render_mlt(scene, state, film, steps=1, lsp=LSP, sigma=SIGMA,
               mode='kelemen'):
    '''Advance all chains `steps` rounds under one jit.'''
    def body(_, carry):
        st, f = carry
        return mlt_step(scene, st, f, lsp=lsp, sigma=sigma, mode=mode)
    state, film = jax.lax.fori_loop(0, steps, body, (state, film))
    return state, film
