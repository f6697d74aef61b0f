'''
Float64 host oracle for ray casts.

Möller–Trumbore in float64 numpy on the raw vertex positions: it shares
no code and no precompiled table with the casts it checks.  At high
tessellation (hundreds of thousands of faces) the float32 casts can
themselves lose hits, so correctness there is judged against this.

The work is split into ray chunks run on a thread pool: numpy releases
the interpreter lock inside its array operations.
'''

import concurrent.futures
import os

import numpy as np

from ptina_tpu.utils.mathutils import INF

__all__ = ['cast_closest_f64', 'agreement']

_PAIRS_PER_CHUNK = 1 << 21  # (ray, face) pairs per worker task


def _closest_chunk(face, ro, rd, avoid):
    '''Möller–Trumbore for rays [R] x faces [F].  Its determinant and
    scaled (u, v, t) are scalar triple products; each is written as a sum
    of [R, 3] @ [3, F] products by expanding o - v0, so no [R, F, 3]
    temporaries are built.'''
    e1, e2, n, e2xv0, v0xe1, v0n = face
    oxd = np.cross(ro, rd)
    det = -(rd @ n.T)                        # e1 . (d x e2)
    ok = np.abs(det) > 1e-300
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    u = (oxd @ e2.T - rd @ e2xv0.T) * inv     # (o - v0) . (d x e2)
    v = (-(oxd @ e1.T) - rd @ v0xe1.T) * inv  # d . ((o - v0) x e1)
    t = (ro @ n.T - v0n[None, :]) * inv       # e2 . ((o - v0) x e1)
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
    hit &= np.arange(n.shape[0])[None, :] != avoid[:, None]
    t = np.where(hit, t, np.inf)
    idx = np.argmin(t, axis=1)
    tmin = t[np.arange(t.shape[0]), idx]
    return tmin, np.where(np.isfinite(tmin), idx, -1)


def cast_closest_f64(tri_pos, ro, rd, avoid=None):
    '''Nearest hit of every ray.  tri_pos: [F, 3, 3] live faces;
    ro, rd: [N, 3]; avoid: [N] face index to skip (-1 = none).
    Returns (t [N] float64, inf on miss; index [N] int, -1 on miss).'''
    tp = np.asarray(tri_pos, np.float64)
    v0, e1, e2 = tp[:, 0], tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]
    n = np.cross(e1, e2)
    face = (e1, e2, n, np.cross(e2, v0), np.cross(v0, e1),
            np.einsum('fc,fc->f', v0, n))
    ro = np.asarray(ro, np.float64)
    rd = np.asarray(rd, np.float64)
    n = ro.shape[0]
    avoid = (np.full(n, -1) if avoid is None
             else np.asarray(avoid).astype(np.int64))
    step = max(1, _PAIRS_PER_CHUNK // max(tp.shape[0], 1))
    starts = range(0, n, step)
    workers = min(16, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        parts = list(pool.map(
            lambda s: _closest_chunk(face, ro[s:s + step],
                                     rd[s:s + step], avoid[s:s + step]),
            starts))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def agreement(t, t64, rtol=2e-3):
    '''Share of rays whose float32 cast agrees with the oracle: both
    miss (t >= INF, t64 = inf), or both hit within rtol * t64.'''
    t = np.asarray(t, np.float64)
    miss64 = ~np.isfinite(t64)
    t64f = np.where(miss64, 1.0, t64)
    ok = np.where(miss64, t >= INF,
                  (t < INF) & (np.abs(t - t64f) < rtol * t64f))
    return float(ok.mean())
