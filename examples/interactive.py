'''
Headless progressive-refinement loop — the counterpart of the
reference's interactive viewport (ptina/blender.py:714-784 semantics and
exams/interactive.py): render starts at a coarse resolution
(start_pixel_size-for-1 blocks), each completed pass halves the block
size (nblocks //= 2, blender.py:763) until full resolution, then keeps
accumulating samples progressively.  Camera moves (here: a scripted
orbit) reset the refinement.

Writes refine_<step>.png snapshots instead of blitting to a GL window
(no display on a headless render host).
'''

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from ptina_tpu import worker
from ptina_tpu.scenes import cornell_box_vertices
from ptina_tpu.utils.control import CamControl
from ptina_tpu.tone import apply_exposure_gamma


def save_png(path, img01):
    try:
        from PIL import Image
    except ImportError:
        np.save(path + '.npy', img01)
        return
    arr = (np.clip(img01, 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr.transpose(1, 0, 2)[::-1]).save(path)


def main():
    res = 256
    start_pixel_size = 8   # reference TinaRenderProperties default region
    refine_samples = 1
    final_samples = 32

    verts, mtlids, materials = cornell_box_vertices()
    worker.init()
    worker.load_materials(materials)
    worker.load_model(verts, mtlids)
    worker.build_tree()

    cam = CamControl(center=(0.0, 1.0, 0.0), radius=4.5, phi=0.1)

    for frame in range(3):  # scripted "camera interaction"
        cam.orbit(0.06 * frame, 0.0)
        nblocks = start_pixel_size
        step = 0
        t0 = time.time()
        # coarse-to-fine: the reference halves the block size each pass
        while nblocks >= 1:
            nx, ny = res // nblocks, res // nblocks
            worker.set_size(nx, ny)
            worker.set_camera(cam.matrix(aspect=1.0))
            worker.render()
            if nblocks > 1:
                worker.render()  # a couple samples at coarse levels
            img = worker.get_image()
            out = apply_exposure_gamma(img[..., :3], exposure=1.0)
            save_png(f'refine_f{frame}_s{step}.png', np.asarray(out))
            print(f'frame {frame} pass {step}: {nx}x{ny} '
                  f'({time.time() - t0:.2f}s)')
            nblocks //= 2
            step += 1
        # progressive accumulation at full resolution
        for _ in range(final_samples - refine_samples):
            worker.render()
        img = worker.get_image()
        out = apply_exposure_gamma(img[..., :3])
        save_png(f'refine_f{frame}_final.png', np.asarray(out))
        print(f'frame {frame}: {final_samples} samples in '
              f'{time.time() - t0:.2f}s')


if __name__ == '__main__':
    main()
