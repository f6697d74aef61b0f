'''
ptina_tpu — a differentiable Monte-Carlo path tracer in JAX.

Brand-new JAX/XLA/Pallas implementation with the capability set of the
reference renderer archibate/ptina (see SURVEY.md): Disney BSDF with
transmission, linear-BVH build + traversal, point/area/environment lights
with multiple importance sampling, textures, Sobol quasi-random sampling,
Metropolis light transport, albedo/normal AOVs, progressive film
accumulation, and OBJ/GLTF scene loading — re-architected from the
reference's per-pixel megakernel (reference: ptina/engine/path.py) into a
wavefront pipeline of jit-compiled, differentiable whole-array ops over
struct-of-array ray batches.  Its accelerator is an NVIDIA GPU; the CPU
runs the same program for tests.

Design points (none of these exist in the reference):
  * Each triangle is precompiled to a 3x4 affine functional, so a ray
    cast is a dense test of every ray against every face: a Pallas
    kernel on the GPU (intersect/triton_cast.py), plain XLA on the CPU
    (intersect/brute.py).
  * The integrator is wavefront: [N]-shaped SoA ray state advanced by
    lax.scan over bounces with alive masks, instead of per-thread
    divergent loops (engine/path.py).
  * Sampling is stateless: Sobol points are pure functions of
    (sample_index, dimension) so they jit and shard freely
    (sampling/sobol.py).
  * Scenes/films are pytrees; multi-device scaling is shard_map over the
    film rows with per-device film shards (parallel/).
'''

__version__ = '0.1.0'

from ptina_tpu.utils.mathutils import *  # noqa: F401,F403
