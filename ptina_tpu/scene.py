'''
Scene representation: one immutable pytree of static-shaped arrays.

The reference scatters scene state across process-wide singleton pools
(ModelPool/MaterialPool/ImagePool/LightPool/WorldLight/Camera, built by
init_things — reference: ptina/things.py:12-28).  This design
replaces all of them with a single value: a `Scene` dataclass whose
fields are jnp arrays.  Rendering is then a pure function
film' = render(scene, film, sample_index), which is what makes jit,
autodiff (gradients w.r.t. scene.materials / scene.textures) and
shard_map work without any plumbing.

Triangles are stored SoA and, at build time, each triangle is compiled to
a 3x4 affine functional matrix (`tri_w2b`): its rows evaluate the plane
equation and the two barycentric coordinates of a point.  Every cast
evaluates these functionals (intersect/brute.py, intersect/triton_cast.py).
'''

from __future__ import annotations

from ptina_tpu.utils import struct
import jax.numpy as jnp
import numpy as np

from ptina_tpu.utils.mathutils import cross, dot

__all__ = ['Scene', 'Materials', 'Lights', 'TextureAtlas', 'make_scene',
           'DEFAULT_MATERIAL', 'MATERIAL_PARAMS', 'LIGHT_POINT', 'LIGHT_AREA',
           'precompute_tri_functionals']

# Disney parameter layout (order matches the reference's MaterialPool,
# ptina/mtllib.py:58-77).
MATERIAL_PARAMS = (
    'basecolor', 'metallic', 'roughness', 'specular', 'specularTint',
    'subsurface', 'sheen', 'sheenTint', 'clearcoat', 'clearcoatGloss',
    'transmission', 'ior',
)

# Defaults used for faces without a material (mtlid == -1), matching
# reference ptina/mtllib.py:79-95.
DEFAULT_MATERIAL = {
    'basecolor': 0.8, 'metallic': 0.0, 'roughness': 0.4, 'specular': 0.5,
    'specularTint': 0.4, 'subsurface': 0.0, 'sheen': 0.0, 'sheenTint': 0.4,
    'clearcoat': 0.0, 'clearcoatGloss': 0.5, 'transmission': 0.0, 'ior': 1.45,
}

LIGHT_POINT = 1  # reference: ptina/light/__init__.py:11
LIGHT_AREA = 2


@struct.dataclass
class Materials:
    '''Material table: [M+1, 12, 4] factors and [M+1, 12] texture ids.
    Row M (the last row) holds the defaults for mtlid == -1.  A parameter's
    value is fac * texture(uv) when its texture id is >= 0
    (reference ParameterPair, ptina/mtllib.py:30-38).

    `zero` is the STATIC tuple of parameter names whose factor is 0 in
    every row (a zero factor annihilates any texture): the Disney
    evaluator skips those lobes at trace time — exactly equivalent
    because choice_split(w, 0) passes the uniform through with pdf 1 —
    which drops the clearcoat lobe, the transmission sub-branch
    (dielectric Fresnel + refraction), sheen and subsurface terms from
    scenes that do not use them.  Being part of the pytree STRUCTURE,
    a material edit that turns a lobe on recompiles automatically.'''
    fac: jnp.ndarray   # [M+1, 12, 4] f32
    tex: jnp.ndarray   # [M+1, 12] i32
    zero: tuple = struct.static_field(())


# lobes the Disney evaluator can statically drop when the parameter is
# zero across the whole table (materials/disney.py consumes this via
# Materials.zero)
SPECIALIZABLE_PARAMS = ('metallic', 'subsurface', 'sheen', 'clearcoat',
                        'transmission')


@struct.dataclass
class Lights:
    '''Analytic light pool, SoA over a fixed capacity L
    (reference: ptina/light/__init__.py:13-19).  `count` is a traced
    scalar; slots >= count are masked out.

    `kinds` is the STATIC tuple of light kinds present ('point'/'area',
    set by make_lights): the unrolled light loops drop the geometry of
    absent kinds at trace time — e.g. an area-only scene (the cornell
    benchmarks) skips the sphere-sample trig entirely.'''
    color: jnp.ndarray  # [L, 3]
    pos: jnp.ndarray    # [L, 3]
    axes: jnp.ndarray   # [L, 3, 3]
    size: jnp.ndarray   # [L]
    type: jnp.ndarray   # [L] i32 (0 = empty slot)
    count: jnp.ndarray  # [] i32
    kinds: tuple = struct.static_field(('point', 'area'))


@struct.dataclass
class TextureAtlas:
    '''All textures padded to a common [H, W] and stacked
    (replaces the reference's first-fit texel allocator,
    ptina/allocator.py + ptina/image.py, with static shapes for XLA).'''
    data: jnp.ndarray  # [T, H, W, 4] f32
    nx: jnp.ndarray    # [T] i32 actual width  (first axis extent)
    ny: jnp.ndarray    # [T] i32 actual height (second axis extent)


@struct.dataclass
class Scene:
    # Geometry (SoA triangle soup; reference layout ptina/model.py:15,
    # ptina/multimesh.py:25-29 — here split per attribute instead of
    # interleaved 8-float vertices).
    tri_pos: jnp.ndarray   # [F, 3, 3] f32 vertex positions
    tri_nrm: jnp.ndarray   # [F, 3, 3] f32 vertex normals
    tri_uv: jnp.ndarray    # [F, 3, 2] f32 vertex texcoords
    tri_mtl: jnp.ndarray   # [F] i32 material id (-1 = default)
    tri_w2b: jnp.ndarray   # [F, 3, 4] f32 world->barycentric functionals
    nfaces: jnp.ndarray    # [] i32 live faces (slots >= nfaces are padding)

    materials: Materials
    textures: TextureAtlas
    lights: Lights

    # Environment light (reference WorldLight, ptina/light/world.py).
    world_fac: jnp.ndarray  # [4] f32
    world_tex: jnp.ndarray  # [] i32 (-1 = constant color)

    # Camera view<->world 4x4s (reference: ptina/camera.py:10-22).
    cam_v2w: jnp.ndarray   # [4, 4] f32
    cam_w2v: jnp.ndarray   # [4, 4] f32

    # STATIC mirror of `world_tex` (set by make_scene; -1 = constant
    # environment): lets trace-time code (world_at's gather) specialize
    # on whether a texture lights the environment.
    world_tex_id: int = struct.static_field(-1)

    @property
    def world_textured(self):
        return self.world_tex_id >= 0


def precompute_tri_functionals(tri_pos):
    '''Per-triangle 3x4 affine functionals M such that for a point p:
        M[0] . [p, 1] = n . p - n . v0        (plane equation, n = e1 x e2)
        M[1] . [p, 1] = u barycentric coord   (weight of v1)
        M[2] . [p, 1] = v barycentric coord   (weight of v2)
    Degenerate triangles get all-zero rows, which the cast kernel rejects
    via its |denominator| > eps test.'''
    v0 = tri_pos[:, 0]
    e1 = tri_pos[:, 1] - v0
    e2 = tri_pos[:, 2] - v0
    n = cross(e1, e2)
    nn = dot(n, n)
    ok = nn > 1e-20
    inv_nn = jnp.where(ok, 1.0 / jnp.where(ok, nn, 1.0), 0.0)
    # u(p) = (p - v0).(e2 x n)/n.n and v(p) = (p - v0).(n x e1)/n.n: by the
    # scalar triple product, u(v0+e1) = n.(e1 x e2)/n.n = 1 and v(v0+e2) = 1.
    gu = cross(e2, n) * inv_nn[:, None]
    gv = cross(n, e1) * inv_nn[:, None]
    # NORMALIZE the plane row: |n| scales with triangle AREA, so on a
    # densely tessellated mesh (~3e-5-area faces at 300k) the raw cross
    # product made b0 = n . d fall below brute.cast's 1e-6 parallel-ray
    # epsilon for EVERY ray, so real hits were rejected.  t = -a0/b0
    # is invariant under positive row scaling, so every consumer agrees;
    # with a unit normal the epsilon means "within 1e-6 of parallel".
    n = n * jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, nn, 1.0)),
                      0.0)[:, None]
    rows = jnp.stack([
        jnp.concatenate([n, -dot(n, v0)[:, None]], axis=-1),
        jnp.concatenate([gu, -dot(gu, v0)[:, None]], axis=-1),
        jnp.concatenate([gv, -dot(gv, v0)[:, None]], axis=-1),
    ], axis=1)  # [F, 3, 4]
    return rows


def make_materials(materials=None, max_materials=None):
    '''Build the Materials table from a list of 12-tuples of (fac, texid)
    pairs in MATERIAL_PARAMS order (the reference's load format,
    ptina/mtllib.py:58-77).  fac may be scalar, 3- or 4-sequence.

    Capacity defaults to the scene's material count (the reference
    reserves 64 slots, ptina/things.py:16 — here the table is UNROLLED
    into the shading pipeline (mtllib.fetch_material), so every unused
    slot costs real per-bounce selects AND XLA trace/compile time; a
    64-slot table made one wavefront render graph take minutes to
    compile on CPU).  Pass max_materials to reserve extra slots.'''
    m = max_materials if max_materials is not None else len(materials or [])
    fac = np.ones((m + 1, 12, 4), np.float32)
    tex = np.full((m + 1, 12), -1, np.int32)
    for p, name in enumerate(MATERIAL_PARAMS):
        fac[:, p, :] = DEFAULT_MATERIAL[name]
    if materials:
        assert len(materials) <= m, 'too many materials'
        for i, mat in enumerate(materials):
            for p, pair in enumerate(mat):
                f, t = pair
                if f is None:
                    f = 1.0
                f = np.asarray(f, np.float32).reshape(-1)
                if f.size == 1:
                    f = np.repeat(f, 4)
                elif f.size == 3:
                    f = np.concatenate([f, [1.0]]).astype(np.float32)
                fac[i, p, :] = f[:4]
                tex[i, p] = -1 if t is None else int(t)
    zero = tuple(
        name for p, name in enumerate(MATERIAL_PARAMS)
        if name in SPECIALIZABLE_PARAMS and not fac[:, p, :3].any())
    return Materials(fac=jnp.asarray(fac), tex=jnp.asarray(tex), zero=zero)


def make_textures(images=None):
    '''Pad and stack numpy images [nx, ny, c] into a TextureAtlas.
    Handles uint8 -> float, grey -> RGB, RGB -> RGBA like the reference
    loader (ptina/image.py:69-89).'''
    if not images:
        return TextureAtlas(
            data=jnp.zeros((1, 1, 1, 4), jnp.float32),
            nx=jnp.ones((1,), jnp.int32), ny=jnp.ones((1,), jnp.int32))
    arrs = []
    for arr in images:
        arr = np.asarray(arr)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape[2] == 1:
            arr = np.repeat(arr, 3, axis=2)
        if arr.shape[2] == 3:
            arr = np.concatenate([arr, np.ones_like(arr[:, :, :1])], axis=2)
        arrs.append(arr)
    H = max(a.shape[0] for a in arrs)
    W = max(a.shape[1] for a in arrs)
    data = np.zeros((len(arrs), H, W, 4), np.float32)
    nx = np.zeros(len(arrs), np.int32)
    ny = np.zeros(len(arrs), np.int32)
    for i, a in enumerate(arrs):
        data[i, :a.shape[0], :a.shape[1]] = a
        nx[i], ny[i] = a.shape[0], a.shape[1]
    return TextureAtlas(data=jnp.asarray(data), nx=jnp.asarray(nx), ny=jnp.asarray(ny))


def make_lights(lights=None, max_lights=None, default_light=True):
    '''Build the light pool.  `lights` is a list of dicts with keys
    pos/color/size/type and optional axes (3x3).  With no lights and
    default_light=True, installs the reference's default point light:
    color (32,32,32), pos (1,2,3), size 0.5
    (reference: ptina/light/__init__.py:22-29).

    Capacity defaults to exactly the scene's light count (the reference
    reserves 64 slots, ptina/things.py:17 — here the light loops are
    UNROLLED per slot in the wavefront light queries, so every unused
    slot costs real per-bounce work; pass max_lights to reserve
    headroom).'''
    if lights is None and default_light:
        lights = [dict(color=(32, 32, 32), pos=(1, 2, 3), size=0.5,
                       type=LIGHT_POINT)]
    lights = lights or []
    if max_lights is None:
        max_lights = max(1, len(lights))
    L = max_lights
    color = np.zeros((L, 3), np.float32)
    pos = np.zeros((L, 3), np.float32)
    axes = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
    size = np.zeros(L, np.float32)
    ltype = np.zeros(L, np.int32)
    assert len(lights) <= L, 'too many lights'
    for i, l in enumerate(lights):
        color[i] = l['color']
        pos[i] = l['pos']
        size[i] = l['size']
        ltype[i] = l['type']
        if 'axes' in l:
            axes[i] = l['axes']
    kinds = tuple(k for k, t in (('point', LIGHT_POINT), ('area', LIGHT_AREA))
                  if any(int(x) == t for x in ltype[:len(lights)]))
    return Lights(color=jnp.asarray(color), pos=jnp.asarray(pos),
                  axes=jnp.asarray(axes), size=jnp.asarray(size),
                  type=jnp.asarray(ltype),
                  count=jnp.asarray(len(lights), jnp.int32),
                  kinds=kinds)


def make_scene(vertices, mtlids=None, materials=None, images=None,
               lights=None, world_fac=(0.1, 0.1, 0.1, 0.1), world_tex=-1,
               cam_pers=None, default_light=True, pad_faces_to=8,
               max_lights=None, max_materials=None):
    '''Assemble a Scene from host-side numpy data.

    vertices: [F*3, 8] float array (pos3 + nrm3 + uv2 per vertex, the
    reference's flat layout, ptina/model.py:15) or a dict from readobj.
    mtlids: [F] int material ids (-1 = default material).
    cam_pers: 4x4 projection @ view matrix (world -> clip).
    '''
    from ptina_tpu.io.matrix import ortho, lookat
    if isinstance(vertices, dict):
        from ptina_tpu.io.readobj import obj_to_vertices
        vertices = obj_to_vertices(vertices)
    vertices = np.asarray(vertices, np.float32)
    assert vertices.ndim == 2 and vertices.shape[1] == 8 and vertices.shape[0] % 3 == 0
    nfaces = vertices.shape[0] // 3
    if mtlids is None:
        mtlids = -np.ones(nfaces, np.int32)
    mtlids = np.asarray(mtlids, np.int32)
    assert mtlids.shape[0] == nfaces

    # pad face count to a multiple (tile-friendly static shapes)
    fpad = max(pad_faces_to, ((nfaces + pad_faces_to - 1) // pad_faces_to) * pad_faces_to)
    tri = vertices.reshape(nfaces, 3, 8)
    tri_pos = np.zeros((fpad, 3, 3), np.float32)
    tri_nrm = np.zeros((fpad, 3, 3), np.float32)
    tri_uv = np.zeros((fpad, 3, 2), np.float32)
    tri_mtl = -np.ones(fpad, np.int32)
    tri_pos[:nfaces] = tri[:, :, 0:3]
    tri_nrm[:nfaces] = tri[:, :, 3:6]
    tri_uv[:nfaces] = tri[:, :, 6:8]
    tri_mtl[:nfaces] = mtlids
    # padding triangles are degenerate (all-zero) -> never hit

    tri_pos_j = jnp.asarray(tri_pos)
    tri_nrm_j = jnp.asarray(tri_nrm)
    tri_uv_j = jnp.asarray(tri_uv)
    tri_mtl_j = jnp.asarray(tri_mtl)
    if cam_pers is None:
        cam_pers = ortho() @ lookat()
    cam_pers = np.asarray(cam_pers, np.float32)

    return Scene(
        tri_pos=tri_pos_j,
        tri_nrm=tri_nrm_j,
        tri_uv=tri_uv_j,
        tri_mtl=tri_mtl_j,
        tri_w2b=precompute_tri_functionals(tri_pos_j),
        nfaces=jnp.asarray(nfaces, jnp.int32),
        materials=make_materials(materials, max_materials=max_materials),
        textures=make_textures(images),
        lights=make_lights(lights, max_lights=max_lights,
                           default_light=default_light),
        world_fac=jnp.asarray(world_fac, jnp.float32),
        world_tex=jnp.asarray(world_tex, jnp.int32),
        cam_v2w=jnp.asarray(np.linalg.inv(cam_pers), jnp.float32),
        cam_w2v=jnp.asarray(cam_pers, jnp.float32),
        world_tex_id=int(world_tex),
    )
