'''
Math commons for the path tracer.

Pure-jnp counterparts of the reference's Taichi vector helpers
(reference: ptina/common.py:32-352).  Everything here operates on
arrays with an arbitrary batch prefix and a trailing component axis
([..., 3] vectors), so the same code serves scalars in tests and
million-ray wavefronts in the integrator.
'''

import jax
import jax.numpy as jnp

EPS = 1e-6
INF = 1e6
PI = jnp.pi
TAU = 2.0 * jnp.pi

__all__ = [
    'EPS', 'INF', 'PI', 'TAU',
    'clamp', 'lerp', 'unlerp', 'smoothstep',
    'dot', 'dot_or_zero', 'norm', 'normalize', 'cross', 'vavg',
    'tanframe', 'tanspace', 'spherical', 'unspherical', 'dir2tex',
    'reflect', 'refract', 'normaldist', 'safe_div', 'safe_sqrt',
]


def safe_sqrt(x):
    '''sqrt clamped at zero with a zero (not inf/nan) gradient at x <= 0.
    Every sqrt in the shading path that can see an exact zero must use
    this, or masked-out lanes poison autodiff via 0 * inf = nan.'''
    m = x > 0.0
    return jnp.where(m, jnp.sqrt(jnp.where(m, x, 1.0)), 0.0)


def clamp(x, lo=0.0, hi=1.0):
    return jnp.clip(x, lo, hi)


def lerp(fac, src, dst):
    '''src*(1-fac) + dst*fac (reference: ptina/common.py:269-271).'''
    return src * (1.0 - fac) + dst * fac


def unlerp(val, src, dst):
    return (val - src) / (dst - src)


def smoothstep(x, a=0.0, b=1.0):
    t = clamp((x - a) / (b - a))
    return t * t * (3.0 - 2.0 * t)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def dot_or_zero(a, b):
    '''max(0, a.b) (reference: ptina/common.py:178-180).'''
    return jnp.maximum(0.0, dot(a, b))


def norm(v):
    return safe_sqrt(jnp.sum(v * v, axis=-1))


def normalize(v, eps=1e-12):
    return v / jnp.maximum(norm(v), eps)[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def vavg(v):
    '''Component mean of a vector (reference Vavg, ptina/common.py:73-77).'''
    return jnp.mean(v, axis=-1)


def safe_div(a, b, eps=1e-12):
    '''a/b with sign-preserving clamped denominator (never nan/inf).'''
    mag = jnp.maximum(jnp.abs(b), eps)
    return a / jnp.where(b < 0, -mag, mag)


def tanframe(nrm, up=(233.0, 666.0, 512.0)):
    '''Tangent frame (tan, bitan) for a [..., 3] normal
    (reference: ptina/common.py:213-217).  Returned as two separate
    [..., 3] vectors, so frame application stays elementwise:
    world = tan*l.x + bitan*l.y + nrm*l.z.'''
    up = jnp.asarray(up, dtype=nrm.dtype)
    up = jnp.broadcast_to(up, nrm.shape)
    bitan = normalize(cross(nrm, up))
    tan = cross(bitan, nrm)
    return tan, bitan


def tanspace(nrm, up=(233.0, 666.0, 512.0)):
    '''Tangent frame columns [tan, bitan, nrm] as an [..., 3, 3] matrix.
    Prefer `tanframe` in hot paths (see its docstring).'''
    tan, bitan = tanframe(nrm, up)
    return jnp.stack([tan, bitan, nrm], axis=-1)


def spherical(h, p):
    '''Direction from cos-elevation h and turn fraction p
    (reference: ptina/common.py:221-225).  h, p: [...] -> [..., 3].'''
    r = safe_sqrt(1.0 - h * h)
    ang = p * TAU
    return jnp.stack([r * jnp.cos(ang), r * jnp.sin(ang), h], axis=-1)


def unspherical(d):
    '''Inverse of spherical (reference: ptina/common.py:228-231).'''
    p = jnp.arctan2(d[..., 1], d[..., 0]) / TAU
    return d[..., 2], p % 1.0


def dir2tex(d):
    '''Equirectangular mapping direction -> (s, t) in [0,1]
    (reference: ptina/common.py:234-239).'''
    d = normalize(d)
    s = jnp.arctan2(d[..., 2], d[..., 0]) / PI * 0.5 + 0.5
    t = jnp.arctan2(d[..., 1], norm(d[..., [0, 2]])) / PI + 0.5
    return s, t


def reflect(i, n):
    '''Mirror i around n (reference: ptina/common.py:247-249).'''
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i, n, eta):
    '''Snell refraction of incident i at normal n with ratio eta.
    Returns (has_refract [...], direction [..., 3])
    (reference: ptina/common.py:252-260).'''
    noi = dot(n, i)
    eta = jnp.broadcast_to(jnp.asarray(eta, dtype=i.dtype), noi.shape)
    discr = 1.0 - eta * eta * (1.0 - noi * noi)
    has = discr > 0.0
    t = eta[..., None] * i - n * (eta * noi + safe_sqrt(discr))[..., None]
    t = normalize(t)
    return has, jnp.where(has[..., None], t, jnp.zeros_like(t))


def normaldist(samp):
    '''Uniform [0,1) -> standard normal via inverse error function
    (reference: ptina/common.py:336-352).

    Implemented as the classic two-branch single-precision erfinv
    polynomial (Giles 2010, "Approximating the erfinv function", ~1e-6
    relative), cheaper than jax.scipy.special.erfinv's high-precision
    expansion.  The construction is EXACTLY odd
    around samp = 0.5 (both branches are odd multiples of s), so the
    Metropolis proposal stays exactly symmetric.'''
    s = jnp.clip(samp * 2.0 - 1.0, -1.0 + 1e-7, 1.0 - 1e-7)
    w = -jnp.log((1.0 - s) * (1.0 + s))
    # central branch (|s| <~ 0.993): polynomial in w - 2.5
    wc = w - 2.5
    pc = 2.81022636e-08
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              2.1858087e-04, -1.25372503e-03, -4.17768164e-03,
              2.46640727e-01, 1.50140941):
        pc = pc * wc + c
    # tail branch: polynomial in sqrt(w) - 3
    wt = jnp.sqrt(w) - 3.0
    pt = -2.00214257e-04
    for c in (1.00950558e-04, 1.34934322e-03, -3.67342844e-03,
              5.73950773e-03, -7.62246130e-03, 9.43887047e-03,
              1.00167406, 2.83297682):
        pt = pt * wt + c
    erfinv_s = jnp.where(w < 5.0, pc, pt) * s
    return jnp.sqrt(2.0) * erfinv_s
