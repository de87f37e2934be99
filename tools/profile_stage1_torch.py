#!/usr/bin/env python3
"""Where stage 1 of the PyTorch/CUDA port spends its time, on one GPU.

Usage (from the repo root, on a machine with a CUDA card):

    python3 tools/profile_stage1_torch.py

Renders ``chip_smoke.py``'s scene (two 2000 x 2800 GeoTIFFs and a config
file), tiles it as ``pipeline.main`` does (6 tiles of 800) and runs stage 1's SIFT part
(``ops.sift.matches_on_rpc_roi_batch`` over the 6 tile pairs) as the
first device work of the process (cold), then twice more (warm), each
split into its parts (the detection wave with its pyramid, orientation
and descriptor waves, the match wave, RANSAC); then the per-tile fit, the
whole ``pipeline.pointing_correction_all`` once warm, and the SIFT part
once more under ``torch.profiler``: its CUDA kernels, their summed
device time and the device's idle share against the warm wall time.  It
prints the card's name and power limit first and ends with the numbers
as one JSON line.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PARTS = ('detection', 'pyramid', 'orientation', 'descriptor', 'match',
         'ransac')


def main():
    import torch
    if not torch.cuda.is_available():
        print('profile_stage1_torch: CUDA is not available', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from s2p_tpu_torch import pipeline, tiling
    from s2p_tpu_torch.core import pointing
    from s2p_tpu_torch.ops import sift

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = {'card': card}
    tmp = tempfile.mkdtemp(prefix='s2p_stage1_')
    try:
        cfg = pipeline.build_cfg(pipeline.read_config_file(
            cs.render_scene(os.path.join(tmp, 'scene'))))
        tiles = tiling.tiles_full_info(
            cfg, *tiling.adjust_tile_size(cfg),
            os.path.join(cfg.out_dir, 'tiles.txt'), create_masks=True)
        pairs = [(t, 1) for t in tiles]
        t0 = time.perf_counter()
        jobs = pipeline._pointing_jobs(cfg, pairs)
        out['image_reads_s'] = time.perf_counter() - t0
        for run in ('cold', 'warm_1', 'warm_2'):
            st = {}
            t0 = time.perf_counter()
            matches = sift.matches_on_rpc_roi_batch(jobs, stats=st)
            torch.cuda.synchronize()
            out[run] = {'sift_s': time.perf_counter() - t0,
                        **{k: st[k] for k in PARTS}}
            print(f'  SIFT, {run}: {out[run]["sift_s"]:.3f} s; ' + ', '.join(
                f'{k} {st[k]:.3f} s' for k in PARTS), flush=True)
        t0 = time.perf_counter()
        for (t, _), m in zip(pairs, matches):
            pointing.local_translation(
                cfg.images[0].rpcm, cfg.images[1].rpcm, *t['coordinates'], m,
                cfg.n_gcp_per_axis, **pipeline._alt_kwargs(cfg))
        out['fit_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipeline.pointing_correction_all(cfg, pairs)
        torch.cuda.synchronize()
        out['stage1_warm_s'] = time.perf_counter() - t0
        print(f"  per-tile fit {out['fit_s']:.3f} s; pointing_correction_all"
              f" warm {out['stage1_warm_s']:.3f} s", flush=True)
        kernels, dev_ms = cs.count_launches(
            lambda: sift.matches_on_rpc_roi_batch(jobs))
        warm = min(out['warm_1']['sift_s'], out['warm_2']['sift_s'])
        out.update(kernels=kernels, device_ms=dev_ms,
                   idle_share=1 - dev_ms / 1e3 / warm)
        print(f'  SIFT under the profiler: {kernels} CUDA kernels, '
              f'{dev_ms:.1f} ms of device time; idle share against the '
              f"warm wall time {out['idle_share']:.3f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
