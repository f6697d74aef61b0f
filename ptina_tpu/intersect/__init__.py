'''
Ray-scene intersection backends.

  * dispatch:    the renderer's entry; picks the platform's cast.
  * triton_cast: the GPU cast kernels (Pallas, Triton route).
  * brute:       dense all-triangles test in plain XLA: the CPU cast and
                 the reference the kernels are tested against.
  * lbvh:        device-built Karras linear BVH (build) + batched stack
                 traversal (traverse): a test oracle and the candidate
                 sub-linear route for big scenes.

The dense casts implement the same contract:
    cast_closest(ro, rd, scene_tris, avoid) -> Hit
    cast_any(ro, rd, scene_tris, avoid, tmax) -> occluded mask
'''

from ptina_tpu.intersect.brute import Hit  # noqa: F401
from ptina_tpu.intersect.dispatch import cast_closest, cast_any  # noqa: F401
