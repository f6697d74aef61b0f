'''
Linear BVH (Karras construction), built entirely on device.

Counterpart of the reference's LBVH (ptina/tree/lbvh.py) with the same
structure — 30-bit Morton codes over centroid AABB, sorted leaf order,
Karras internal-node ranges/splits, bottom-up AABB fitting — but
on device in every step the reference does serially or on the host:

  * the Morton sort is jnp.argsort on device (the reference round-trips
    through numpy, lbvh.py:204-208);
  * ranges/splits use the standard index-augmented delta from the Karras
    paper (equal codes fall back to clz(i ^ j)), replacing the
    reference's special-case scan for equal codes (lbvh.py:101-109), and
    the exponential/binary searches run as fixed-trip vectorized
    fori_loops over all n-1 internal nodes at once;
  * AABB fitting keeps the reference's elegant relaxation formulation
    (lbvh.py:251-294) as a lax.while_loop — each round resolves one tree
    level, so it converges in O(depth) rounds.

Node indexing matches the reference: internal nodes are 0..n-2, ids >= n
in child links mean "internal node id - n"... inverted here for clarity:
child ids < n are leaves (sorted-order leaf slots), ids >= n are internal
node (id - n).

Traversal: `lbvh_traverse` advances every ray's fixed-depth stack in
lockstep (one node visit per ray per iteration, masked), in plain lax.
No production cast route uses it yet: it is a test oracle for the dense
casts and the candidate for a sub-linear large-mesh route.
'''

import functools

from ptina_tpu.utils import struct
import jax
import jax.numpy as jnp

from ptina_tpu.utils.mathutils import EPS, INF
from ptina_tpu.intersect.brute import Hit

__all__ = ['LBVH', 'lbvh_build', 'lbvh_traverse', 'ray_aabb', 'STACK_DEPTH']

STACK_DEPTH = 32  # matches the reference stack capacity (stack.py:11)


@struct.dataclass
class LBVH:
    leaf: jnp.ndarray    # [n] i32 face id per sorted leaf slot
    child: jnp.ndarray   # [n-1, 2] i32 child ids (< n leaf, >= n internal+n)
    bmin: jnp.ndarray    # [n-1, 3] internal node AABB min
    bmax: jnp.ndarray    # [n-1, 3]
    leaf_bmin: jnp.ndarray  # [n, 3] per-leaf AABB
    leaf_bmax: jnp.ndarray  # [n, 3]


def _expand_bits(v):
    '''Spread 10 bits to every 3rd position (Morton interleave).'''
    u = jnp.uint32
    v = (v * u(0x00010001)) & u(0xFF0000FF)
    v = (v * u(0x00000101)) & u(0x0F00F00F)
    v = (v * u(0x00000011)) & u(0xC30C30C3)
    v = (v * u(0x00000005)) & u(0x49249249)
    return v


def morton3d(p):
    '''30-bit Morton code for points p [.., 3] normalized to [0, 1].'''
    q = jnp.clip(jnp.floor(p * 1024.0), 0, 1023).astype(jnp.uint32)
    return (_expand_bits(q[..., 0]) * 4 + _expand_bits(q[..., 1]) * 2
            + _expand_bits(q[..., 2])).astype(jnp.int32)


def _delta(codes, n, i, j):
    '''Karras common-prefix metric with index augmentation for equal
    codes; -1 outside [0, n).'''
    valid = (j >= 0) & (j < n)
    jc = jnp.clip(j, 0, n - 1)
    ci = codes[i]
    cj = codes[jc]
    x = ci ^ cj
    d = jnp.where(x == 0,
                  32 + jax.lax.clz((i ^ jc).astype(jnp.uint32)).astype(jnp.int32),
                  jax.lax.clz(x.astype(jnp.uint32)).astype(jnp.int32))
    return jnp.where(valid, d, -1)


def lbvh_build(tri_pos):
    '''Build over all F triangles of tri_pos [F, 3, 3] (degenerate
    padding triangles participate harmlessly: their AABBs are points at
    the origin... callers should pass only live faces).'''
    f = tri_pos.shape[0]
    assert f >= 2, 'LBVH needs at least 2 faces'
    n = f

    centers = jnp.mean(tri_pos, axis=1)
    cmin = jnp.min(centers, axis=0)
    cmax = jnp.max(centers, axis=0)
    norm = (centers - cmin) / jnp.maximum(cmax - cmin, 1e-12)
    codes_unsorted = morton3d(norm)

    order = jnp.argsort(codes_unsorted)
    codes = codes_unsorted[order]
    leaf = order.astype(jnp.int32)

    tmin = jnp.min(tri_pos, axis=1)
    tmax = jnp.max(tri_pos, axis=1)
    leaf_bmin = tmin[leaf]
    leaf_bmax = tmax[leaf]

    # --- Karras ranges and splits, vectorized over internal nodes ---
    i = jnp.arange(n - 1, dtype=jnp.int32)
    d = jnp.sign(_delta(codes, n, i, i + 1) - _delta(codes, n, i, i - 1))
    d = jnp.where(d == 0, 1, d)
    dmin = _delta(codes, n, i, i - d)

    # exponential search for the range length upper bound
    lmax = jnp.full_like(i, 2)
    nbits = int(jnp.ceil(jnp.log2(max(n, 2)))) + 2

    def exp_body(_, lm):
        grow = _delta(codes, n, i, i + lm * d) > dmin
        return jnp.where(grow, lm * 2, lm)
    lmax = jax.lax.fori_loop(0, nbits, exp_body, lmax)

    # binary search the exact other end
    def bin_body(k, carry):
        l, t = carry
        t = jnp.maximum(t // 2, 1) if False else t
        probe = _delta(codes, n, i, i + (l + t) * d) > dmin
        l = jnp.where((t > 0) & probe, l + t, l)
        return (l, t // 2)
    l, _ = jax.lax.fori_loop(0, nbits + 1, bin_body,
                             (jnp.zeros_like(i), lmax // 2))
    j = i + l * d  # other end of the range
    lo = jnp.minimum(i, j)
    hi = jnp.maximum(i, j)

    # binary search the split position (highest differing bit)
    dnode = _delta(codes, n, i, j)

    # ceil-halving series t = ceil(len/2), ceil(t/2), ..., 1 (Karras)
    def split_body(k, carry):
        s, t = carry
        probe = _delta(codes, n, i, i + (s + t) * d) > dnode
        s = jnp.where((t > 0) & probe, s + t, s)
        return (s, jnp.where(t > 1, (t + 1) // 2, 0))
    s0 = jnp.zeros_like(i)
    t0 = hi - lo  # range length
    s, _ = jax.lax.fori_loop(0, nbits + 2, split_body, (s0, (t0 + 1) // 2))
    gamma = i + s * d + jnp.minimum(d, 0)

    left = jnp.where(lo == gamma, gamma, gamma + n)
    right = jnp.where(hi == gamma + 1, gamma + 1, gamma + 1 + n)
    child = jnp.stack([left, right], axis=1).astype(jnp.int32)

    # --- bottom-up AABB fit by relaxation (reference lbvh.py:251-294) ---
    def get_box(ready, bmin, bmax, cid):
        is_leaf = cid < n
        li = jnp.clip(cid, 0, n - 1)
        ni = jnp.clip(cid - n, 0, n - 2)
        r = jnp.where(is_leaf, True, ready[ni])
        mn = jnp.where(is_leaf[:, None], leaf_bmin[li], bmin[ni])
        mx = jnp.where(is_leaf[:, None], leaf_bmax[li], bmax[ni])
        return r, mn, mx

    def cond(state):
        ready, _, _ = state
        return ~jnp.all(ready)

    def step(state):
        ready, bmin, bmax = state
        r1, mn1, mx1 = get_box(ready, bmin, bmax, child[:, 0])
        r2, mn2, mx2 = get_box(ready, bmin, bmax, child[:, 1])
        can = r1 & r2 & ~ready
        bmin = jnp.where(can[:, None], jnp.minimum(mn1, mn2), bmin)
        bmax = jnp.where(can[:, None], jnp.maximum(mx1, mx2), bmax)
        return ready | can, bmin, bmax

    ready0 = jnp.zeros(n - 1, bool)
    bmin0 = jnp.zeros((n - 1, 3))
    bmax0 = jnp.zeros((n - 1, 3))
    _, bmin, bmax = jax.lax.while_loop(cond, step, (ready0, bmin0, bmax0))

    return LBVH(leaf=leaf, child=child, bmin=bmin, bmax=bmax,
                leaf_bmin=leaf_bmin, leaf_bmax=leaf_bmax)


def ray_aabb(ro, rd, lo, hi, tmax):
    '''Slab test — THE ray/box implementation (reference Box.intersect,
    ptina/geometries.py:23-46).  ro, rd: [.., 3]; lo, hi: box corners
    (broadcastable).  Returns (hit, near, far) with near clamped to 0
    for origins inside the box, matching the reference semantics.'''
    inv = 1.0 / jnp.where(jnp.abs(rd) < 1e-12, 1e-12, rd)
    t1 = (lo - ro) * inv
    t2 = (hi - ro) * inv
    near = jnp.max(jnp.minimum(t1, t2), axis=-1)
    far = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (near <= far) & (far > 0.0) & (near < tmax)
    return hit, jnp.maximum(near, 0.0), far


def _ray_box(ro, rd, lo, hi, tmax):
    return ray_aabb(ro, rd, lo, hi, tmax)[0]


def _tri_hit(tri_w2b, fid, ro, rd):
    '''Single-face Möller test via the affine functionals, per lane.'''
    m = tri_w2b[fid]  # [N, 3, 4] gather
    o4 = jnp.concatenate([ro, jnp.ones_like(ro[:, :1])], 1)
    d4 = jnp.concatenate([rd, jnp.zeros_like(rd[:, :1])], 1)
    a = jnp.einsum('nkc,nc->nk', m, o4, precision=jax.lax.Precision.HIGHEST)
    b = jnp.einsum('nkc,nc->nk', m, d4, precision=jax.lax.Precision.HIGHEST)
    live = jnp.abs(b[:, 0]) >= EPS
    t = -a[:, 0] / jnp.where(live, b[:, 0], 1.0)
    u = a[:, 1] + t * b[:, 1]
    v = a[:, 2] + t * b[:, 2]
    ok = live & (t > 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    return ok, t, u, v


@jax.jit
def lbvh_traverse(bvh, tri_w2b, ro, rd, avoid):
    '''Closest-hit traversal for all rays in lockstep.  Every iteration
    each active ray pops one node: internal -> box-test + push children;
    leaf -> triangle test.  Matches reference traversal semantics
    (lbvh.py:313-347) incl. `avoid`.'''
    n = bvh.leaf.shape[0]
    nr = ro.shape[0]

    stack = jnp.zeros((nr, STACK_DEPTH), jnp.int32)
    stack = stack.at[:, 0].set(n)  # root: internal node 0
    sp = jnp.ones(nr, jnp.int32)

    best_t = jnp.full(nr, INF)
    best_i = jnp.full(nr, -1, jnp.int32)
    best_u = jnp.zeros(nr)
    best_v = jnp.zeros(nr)

    def cond(state):
        sp = state[0]
        return jnp.any(sp > 0)

    def body(state):
        sp, stack, bt, bi, bu, bv = state
        active = sp > 0
        top = jnp.clip(sp - 1, 0, STACK_DEPTH - 1)
        node = stack[jnp.arange(nr), top]
        sp2 = jnp.where(active, sp - 1, sp)

        is_leaf = node < n
        # --- leaf: test triangle ---
        li = jnp.clip(node, 0, n - 1)
        fid = bvh.leaf[li]
        ok, t, u, v = _tri_hit(tri_w2b, fid, ro, rd)
        take = active & is_leaf & ok & (fid != avoid) & (t < bt)
        bt = jnp.where(take, t, bt)
        bi = jnp.where(take, fid, bi)
        bu = jnp.where(take, u, bu)
        bv = jnp.where(take, v, bv)

        # --- internal: box test, push children ---
        ni = jnp.clip(node - n, 0, n - 2)
        hitbox = _ray_box(ro, rd, bvh.bmin[ni], bvh.bmax[ni], bt)
        push = active & ~is_leaf & hitbox
        c0 = bvh.child[ni, 0]
        c1 = bvh.child[ni, 1]
        idx0 = jnp.clip(sp2, 0, STACK_DEPTH - 1)
        stack = stack.at[jnp.arange(nr), idx0].set(
            jnp.where(push, c0, stack[jnp.arange(nr), idx0]))
        sp3 = jnp.where(push, jnp.minimum(sp2 + 1, STACK_DEPTH), sp2)
        idx1 = jnp.clip(sp3, 0, STACK_DEPTH - 1)
        stack = stack.at[jnp.arange(nr), idx1].set(
            jnp.where(push, c1, stack[jnp.arange(nr), idx1]))
        sp4 = jnp.where(push, jnp.minimum(sp3 + 1, STACK_DEPTH), sp3)
        return (sp4, stack, bt, bi, bu, bv)

    sp, stack, bt, bi, bu, bv = jax.lax.while_loop(
        cond, body, (sp, stack, best_t, best_i, best_u, best_v))
    return Hit(hit=bi >= 0, t=bt, index=bi, u=bu, v=bv)
