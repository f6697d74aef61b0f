'''
Ray casts as Pallas kernels on the Triton route (GPU).

The plain cast (intersect/brute.py) runs each face tile as a K=4 matmul
whose [N, 3 * TILE_F] outputs go through device memory: about 8 * F
bytes per ray per cast for work that is compute-bound once fused.  Here
one program owns a block of BR rays and walks the whole face table in
chunks of FC faces inside the kernel; the table is read from global
memory (served from L2), and nothing per (ray, face) pair leaves
registers.  The only device-memory traffic is the rays in and one
(t, face) pair per ray out.

Arithmetic is the same affine-functional test as brute.py, written as
explicit float32 multiply-adds: K=4 is no tensor-core shape, and FMAs
keep TF32 out.  Hit semantics match brute.py exactly: strict t > 0,
closed barycentrics, the `avoid` face excluded, t >= INF a miss, and
cast_any's tmax clamped to INF.

Each program keeps a [BR, FC] running minimum (t and face id per lane)
and reduces it across the chunk axis once, at the end: equal t resolve
to the lowest face id, as brute.py's argmin does.  The winner's
barycentrics are recomputed after the kernel from a gather of its
functional rows, so the kernel carries two values per lane, not four.

The kernels have no VJP.  Callers pass detached rays (intersections are
treated as constants, see engine/path._cast_and_shade).
'''

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ptina_tpu.utils.mathutils import EPS, INF
from ptina_tpu.intersect.brute import Hit

__all__ = ['triton_cast_closest', 'triton_cast_any', 'face_table',
           'BR', 'FC']

# Block sizes measured on an H100 at 262,144 rays x ~102k faces: of
# BR in {32, 64, 128, 256}, FC in {8, 16, 32, 64} and 2, 4 or 8 warps,
# (32, 32, 4) was fastest.
BR = 32       # rays per program
FC = 32       # faces per inner-loop chunk
NUM_WARPS = 4


def face_table(tri_w2b):
    '''[F, 3, 4] functionals -> [12, F_pad] rows (plane, u, v functionals,
    4 coefficients each), F padded to a chunk multiple with zero columns,
    which the |denominator| >= EPS test rejects.'''
    f = tri_w2b.shape[0]
    tbl = tri_w2b.reshape(f, 12).T
    return jnp.pad(tbl, ((0, 0), (0, -f % FC)))


def _chunk_t(o, d, tbl_ref, avoid, c):
    '''t [BR, FC] of the rays against faces [c*FC, (c+1)*FC), INF where
    the pair misses; and the chunk's face ids.'''
    s = pl.multiple_of(c * FC, FC)
    r = [tbl_ref[k, pl.ds(s, FC)][None, :] for k in range(12)]

    def affine(k, p, w):
        acc = p[0] * r[k] + p[1] * r[k + 1] + p[2] * r[k + 2]
        return acc + r[k + 3] if w else acc

    a0, b0 = affine(0, o, True), affine(0, d, False)
    live = jnp.abs(b0) >= EPS
    t = -a0 / jnp.where(live, b0, 1.0)
    u = affine(4, o, True) + t * affine(4, d, False)
    v = affine(8, o, True) + t * affine(8, d, False)
    ids = s + jax.lax.broadcasted_iota(jnp.int32, (BR, FC), 1)
    ok = (live & (t > 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (ids != avoid))
    return jnp.where(ok, t, INF), ids


def _load_rays(refs):
    ox, oy, oz, dx, dy, dz, av = (r[...] for r in refs)
    return ([ox[:, None], oy[:, None], oz[:, None]],
            [dx[:, None], dy[:, None], dz[:, None]], av[:, None])


def _closest_kernel(*refs, nchunks):
    *ray_refs, tbl_ref, t_ref, i_ref = refs
    o, d, avoid = _load_rays(ray_refs)

    def body(c, carry):
        tb, ib = carry
        t, ids = _chunk_t(o, d, tbl_ref, avoid, c)
        better = t < tb
        return jnp.where(better, t, tb), jnp.where(better, ids, ib)

    tb, ib = jax.lax.fori_loop(
        0, nchunks, body,
        (jnp.full((BR, FC), INF, jnp.float32),
         jnp.full((BR, FC), -1, jnp.int32)))
    tmin = jnp.min(tb, axis=1)
    imin = jnp.min(jnp.where(tb == tmin[:, None], ib, jnp.int32(2 ** 30)),
                   axis=1)
    t_ref[...] = tmin
    i_ref[...] = jnp.where(tmin < INF, imin, -1)


def _any_kernel(*refs, nchunks):
    *ray_refs, tmax_ref, tbl_ref, occ_ref = refs
    o, d, avoid = _load_rays(ray_refs)
    tm = jnp.minimum(tmax_ref[...], INF)[:, None]

    def body(c, occ):
        t, _ = _chunk_t(o, d, tbl_ref, avoid, c)
        return jnp.maximum(occ, (t < tm).astype(jnp.int32))

    occ = jax.lax.fori_loop(0, nchunks, body,
                            jnp.zeros((BR, FC), jnp.int32))
    occ_ref[...] = jnp.max(occ, axis=1)


def _ray_rows(ro, rd, avoid, extra=()):
    '''Ray component rows padded to a block multiple; padding rays have
    a zero direction, so every face rejects them.'''
    n = ro.x.shape[0]
    pad = -n % BR

    def padded(r, value=0):
        return jnp.pad(r, (0, pad), constant_values=value) if pad else r
    rows = ([padded(r) for r in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
            + [padded(avoid, -1)] + [padded(r) for r in extra])
    return rows, n + pad


def _call(kernel, rows, tbl, npad, out_dtypes, interpret, name):
    spec = pl.BlockSpec((BR,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(kernel, nchunks=tbl.shape[1] // FC),
        grid=(npad // BR,),
        in_specs=[spec] * len(rows) + [pl.BlockSpec(tbl.shape,
                                                    lambda i: (0, 0))],
        out_specs=[spec] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((npad,), dt) for dt in out_dtypes],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        backend='triton',
        interpret=interpret,
        name=name,
    )(*rows, tbl)


def _winner_uv(ro, rd, tri_w2b, t, idx):
    '''Barycentrics of the winning face, by the same functional rows the
    kernel tested (elementwise, so no matmul precision applies).'''
    m = tri_w2b[jnp.maximum(idx, 0)]  # [N, 3, 4]

    def row(k):
        a = m[:, k, 0] * ro.x + m[:, k, 1] * ro.y + m[:, k, 2] * ro.z \
            + m[:, k, 3]
        b = m[:, k, 0] * rd.x + m[:, k, 1] * rd.y + m[:, k, 2] * rd.z
        return jnp.where(idx >= 0, a + t * b, 0.0)
    return row(1), row(2)


@functools.partial(jax.jit, static_argnames=('interpret',))
def triton_cast_closest(ro, rd, tri_w2b, avoid, interpret=False):
    '''Nearest-hit cast with brute.cast_closest's contract.  ro, rd: V3
    of [N] rows; tri_w2b: [F, 3, 4]; avoid: [N] i32 (-1 = none).'''
    rows, npad = _ray_rows(ro, rd, avoid)
    n = ro.x.shape[0]
    t, idx = _call(_closest_kernel, rows, face_table(tri_w2b), npad,
                   (jnp.float32, jnp.int32), interpret, 'cast_closest')
    t, idx = t[:n], idx[:n]
    u, v = _winner_uv(ro, rd, tri_w2b, t, idx)
    return Hit(hit=idx >= 0, t=t, index=idx, u=u, v=v)


@functools.partial(jax.jit, static_argnames=('interpret',))
def triton_cast_any(ro, rd, tri_w2b, avoid, tmax, interpret=False):
    '''Occlusion cast with brute.cast_any's contract: True where a face
    other than `avoid` is hit at 0 < t < min(tmax, INF).'''
    rows, npad = _ray_rows(ro, rd, avoid, extra=(tmax,))
    (occ,) = _call(_any_kernel, rows, face_table(tri_w2b), npad,
                   (jnp.int32,), interpret, 'cast_any')
    return occ[:ro.x.shape[0]] > 0
