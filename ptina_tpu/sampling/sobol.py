'''
Stateless Sobol quasi-random sequence.

The reference keeps a mutable gray-code Sobol state advanced once per
frame for all 21201 dimensions (reference: ptina/sampling/sobol.py:99-125,
with Joe-Kuo direction numbers from the pysobol package).  A stateful
XOR update would serialize the samples; instead we make the sequence a pure
function of (sample_index, dimension):

    x(n, d) = XOR_{bit b set in gray(n)} V[d, b]

where gray(n) = n ^ (n >> 1) and V is the direction-number grid.  This is
bit-identical to iterating the gray-code update n times, but jit- and
shard-friendly: any device can evaluate any slice of the sequence.

Direction numbers come from scipy's Joe-Kuo table (scipy.stats._sobol),
the same dataset the reference pulls from pysobol.

Pixel decorrelation: the reference assigns every pixel a random starting
dimension in the 21201-dim sequence (wanghash2(i,j) % 21201,
ptina/sampling/sobol.py:107-125).  We instead give every path the same
well-distributed low dimensions and decorrelate pixels with a
Cranley-Patterson rotation (the reference ships the same tool as RNGShift,
ptina/sampling/__init__.py:67-75) — standard QMC practice that preserves
the low-discrepancy structure per pixel.
'''

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ptina_tpu.sampling import wanghash, wanghash2

__all__ = ['sobol_vgrid', 'sobol', 'sobol_block', 'sample_dims', 'pixel_rotation']

SOBOL_BITS = 31  # keep values inside int32
SKIP = 64  # burn-in matching the reference (ptina/sampling/sobol.py:75)


@functools.lru_cache(maxsize=None)
def _vgrid_np(ndims: int) -> np.ndarray:
    '''Direction-number grid [ndims, SOBOL_BITS] as int32 (bit-reversed so
    value/2^31 is the float sample).'''
    from scipy.stats import _sobol as sp_sobol
    v = np.zeros((ndims, 32), dtype=np.uint64)
    sp_sobol._initialize_v(v, dim=ndims, bits=32)
    # scipy builds v so that x/2^32 is the sample; drop to 31 bits.
    v = (v >> np.uint64(1)).astype(np.int64)
    return v[:, :SOBOL_BITS].astype(np.int32)


def sobol_vgrid(ndims: int) -> jnp.ndarray:
    return jnp.asarray(_vgrid_np(ndims))


def sobol(index, vgrid):
    '''Sobol point for integer sample `index` ([...]-shaped int32) over all
    dimensions of vgrid [D, B].  Returns [..., D] floats in [0, 1).'''
    index = jnp.asarray(index, jnp.int32)
    gray = index ^ (index >> 1)
    bits = (gray[..., None] >> jnp.arange(SOBOL_BITS, dtype=jnp.int32)) & 1
    # XOR-accumulate selected direction numbers: mask then xor-reduce.
    sel = bits[..., None, :] * vgrid  # [..., D, B] via broadcast
    x = jax.lax.reduce(sel, jnp.int32(0), jax.lax.bitwise_xor, [sel.ndim - 1])
    return x.astype(jnp.float32) * jnp.float32(1.0 / (1 << SOBOL_BITS))


def sobol_block(sample_index, ndims):
    '''The [ndims] Sobol point for one sample index (with reference-matching
    SKIP burn-in offset).'''
    vg = sobol_vgrid(ndims)
    return sobol(jnp.asarray(sample_index, jnp.int32) + SKIP, vg)


def pixel_rotation(pix_i, pix_j, ndims):
    '''Per-pixel Cranley-Patterson rotation offsets [ndims, ...] in [0,1).
    Deterministic in (pixel, dimension); constant across sample indices so
    the rotated sequence stays low-discrepancy per pixel.

    Dimension-major layout: each uniforms[d] is a dense [...]-shaped row
    (pixel axes minor), so per-dimension slices in the integrator are
    contiguous.'''
    base = wanghash2(pix_i, pix_j)
    dims = jnp.arange(ndims, dtype=jnp.uint32)
    dims = dims.reshape((ndims,) + (1,) * jnp.ndim(base))
    h = wanghash(base[None] + dims * jnp.uint32(0x9e3779b9))
    return h.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0)


def sample_dims(sample_index, pix_i, pix_j, ndims, rot=None):
    '''Per-pixel uniforms for one sample: rotated Sobol.
    pix_i/pix_j: [...] int arrays; returns [ndims, ...] in [0,1)
    (dimension-major; see pixel_rotation).

    rot: optional precomputed pixel_rotation(pix_i, pix_j, ndims).  The
    rotation is constant across sample indices but costs ~10 int-hash
    ops per (dim, pixel), and XLA does NOT hoist it out of a scan over
    samples (the hoisted value would be a 33 MB live buffer at
    512x512x32 dims).  Per-sample loops should compute it once and pass
    it in.'''
    pt = sobol_block(sample_index, ndims)  # [ndims]
    pt = pt.reshape((ndims,) + (1,) * jnp.ndim(pix_i))
    if rot is None:
        rot = pixel_rotation(pix_i, pix_j, ndims)  # [ndims, ...]
    return jnp.mod(pt + rot, 1.0)
