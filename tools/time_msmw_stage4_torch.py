#!/usr/bin/env python3
"""Stage 4 of the msmw engines on a rendered scene's tiles, timed on one
CUDA card.

Usage, from the root of a checkout on a machine with one CUDA card and
nvcc:

    python3 tools/time_msmw_stage4_torch.py render out/s4
    python3 tools/time_msmw_stage4_torch.py time out/s4 change
    python3 tools/time_msmw_stage4_torch.py compare out/s4 parent change

``render`` draws ``chip_smoke.py``'s scene (two 2000 x 2800 images, an ROI
of 6 tiles of 800 px) and runs ``pipeline.main`` on it (stages 1 to 7, the
default matcher) into ``DIR/scene``: the rectified tiles that stage 4
reads.  ``time`` copies each tile's stage-4 inputs under ``DIR/LABEL`` and
runs ``pipeline.stereo_matching_all`` with ``msmw`` and then
``hirschmuller02`` over the 6 tiles, each after a warm-up on the first
tile (the kernels' build and the card's first launches), the wall on the
host clock ending in ``torch.cuda.synchronize()``; it prints the card's
name and power limit, each matcher's seconds and its launch counts, and
one JSON line.  ``compare`` checks that two labels' stage-4 files are
equal byte for byte.

To compare two commits on one card, unpack the older one into a
git-ignored directory (``git archive <commit> | tar -x -C out/parent``),
copy this file into its ``tools/`` and run ``time`` from each tree with
its own label on the same DIR, in the order parent, change, change,
parent (labels ``parent``, ``change``, ``change2``, ``parent2``).
"""

import glob
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ALGOS = ('msmw', 'hirschmuller02')
INPUTS = ('rectified_ref.tif', 'rectified_sec.tif', 'disp_min_max.txt')
OUTPUTS = ('rectified_disp.tif', 'rectified_mask.png')


def card():
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()


def render(root):
    import chip_smoke
    from s2p_tpu_torch import pipeline
    config = chip_smoke.render_scene(os.path.join(root, 'scene'))
    t0 = time.perf_counter()
    pipeline.main(pipeline.read_config_file(config))
    print(f'the scene through main: {time.perf_counter() - t0:.3f} s',
          flush=True)


def copy_tiles(pdirs, root):
    tiles = []
    for k, p in enumerate(pdirs):
        d = os.path.join(root, f'tile_{k}')
        os.makedirs(os.path.join(d, 'pair_1'))
        for n in INPUTS:
            shutil.copy(os.path.join(p, n), os.path.join(d, 'pair_1'))
        tiles.append(({'dir': d}, 1))
    return tiles


def time_stage4(root, label):
    import dataclasses
    import torch
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.ops import _build, msmw
    scene = os.path.join(root, 'scene')
    user = pipeline.read_config_file(os.path.join(scene, 'config.json'))
    cfg = pipeline.build_cfg(user)
    pdirs = sorted(glob.glob(os.path.join(user['out_dir'], 'tiles', '*',
                                          '*', 'pair_1')))
    _, build_s = _build.build()
    name = card()
    print(f'{label}: {name}; {len(pdirs)} tiles; kernels built in '
          f'{build_s:.1f} s', flush=True)
    walls, launches = {}, {}
    for algo in ALGOS:
        out = os.path.join(root, label, algo)
        warm = dataclasses.replace(cfg, matching_algorithm=algo,
                                   out_dir=os.path.join(out, 'warm'))
        pipeline.stereo_matching_all(
            warm, copy_tiles(pdirs[:1], os.path.join(out, 'warm')))
        torch.cuda.synchronize()
        c = dataclasses.replace(cfg, matching_algorithm=algo, out_dir=out)
        tiles = copy_tiles(pdirs, out)
        msmw.reset_launch_counts()
        t0 = time.perf_counter()
        pipeline.stereo_matching_all(c, tiles)
        torch.cuda.synchronize()
        walls[algo] = time.perf_counter() - t0
        launches[algo] = msmw.launch_counts()
        print(f'  {label} {algo}: stage 4 of {len(tiles)} tiles '
              f'{walls[algo]:.4f} s; launches {launches[algo]}', flush=True)
    print(json.dumps({'label': label, 'card': name, 'tiles': len(pdirs),
                      'stage4_s': walls, 'launches': launches}))


def compare(root, a, b):
    n = 0
    for algo in ALGOS:
        for p in sorted(glob.glob(os.path.join(root, a, algo, 'tile_*',
                                               'pair_1'))):
            q = p.replace(os.path.join(root, a), os.path.join(root, b), 1)
            for f in OUTPUTS:
                with open(os.path.join(p, f), 'rb') as x, \
                        open(os.path.join(q, f), 'rb') as y:
                    if x.read() != y.read():
                        raise AssertionError(f'{algo} {p} {f}: {a} and {b} '
                                             'differ')
                n += 1
    if not n:
        raise AssertionError(f'no stage-4 files under {root}/{a}')
    print(f'{a} and {b}: {n} stage-4 files equal byte for byte', flush=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('time_msmw_stage4_torch: CUDA is not available',
              file=sys.stderr)
        return 1
    cmd, root = argv[0], os.path.abspath(argv[1])
    if cmd == 'render':
        render(root)
    elif cmd == 'time':
        time_stage4(root, argv[2])
    elif cmd == 'compare':
        compare(root, argv[2], argv[3])
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
