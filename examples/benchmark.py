'''Benchmark example — DELEGATES to the root harness (bench.py) so
contributors measure exactly what bench.py measures (one warmup +
self-tuned sustained timed region with a single amortized sync; see
bench.py's module docstring for the methodology and how it maps onto
the reference's exams/benchmark.py:25-38).

    python examples/benchmark.py [scene] [spp]
'''
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import bench
from ptina_tpu import scenes
from ptina_tpu.utils.cache import setup_compile_cache

bench._device()
setup_compile_cache()

name = sys.argv[1] if len(sys.argv) > 1 else 'cornell_monkey'
spp = int(sys.argv[2]) if len(sys.argv) > 2 else 32
scene = getattr(scenes, name)()
sps = bench._time_render(scene, 512, spp)
print(f'{name}: {sps:.3f} sps ({spp} spp frames, 512x512)')
