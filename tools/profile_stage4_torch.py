#!/usr/bin/env python3
"""Where stage 4 of the PyTorch/CUDA port spends its time, on one GPU.

Usage (from the repo root, on a machine with a CUDA card):

    python3 tools/profile_stage4_torch.py [A|B]

Writes the synthetic tiles of ``chip_smoke.py``'s bucket A (8 tiles,
448 x 512, 80 candidates; the default) or B (2 tiles, 832 x 896, 96
candidates), runs ``pipeline.stereo_matching_all`` once to build and warm
up, then once more under ``torch.profiler``.  It prints the wall time,
the host time of each step of stereo_matching_all (TIFF reads, the
enqueue of the batched matcher, rejection mask, erosion, file writes,
and the rest: padding, transfers and waits on the device), the device
time of each kernel and the device's idle share, and ends with the same
numbers as one JSON line.  It imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(bucket_name='A'):
    import torch
    if not torch.cuda.is_available():
        print('profile_stage4_torch: CUDA is not available', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.config import Config

    bucket = {'A': cs.BUCKET_A, 'B': cs.BUCKET_B}[bucket_name]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    host = defaultdict(float)

    def timed(owner, name, label):
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[label] += time.perf_counter() - t0
        setattr(owner, name, wrapper)

    timed(pipeline.geotiff, 'read', 'read tiff')
    timed(pipeline.geotiff, 'write', 'write tiff')
    timed(pipeline.geotiff, 'write_png', 'write png')
    timed(pipeline, 'mgm_binary_match_batch', 'matcher call (enqueue)')
    timed(pipeline.matching, 'finalize_disparity', 'rejection mask')
    timed(pipeline.masking, 'erosion', 'erosion')

    tmp = tempfile.mkdtemp(prefix='s2p_profile_')
    try:
        specs = cs.tile_specs(bucket, 0)
        tiles = [(cs.write_tile(tmp, s, *cs.make_pair(s)), 1) for s in specs]
        cfg = Config(out_dir=tmp)
        pipeline.stereo_matching_all(cfg, tiles)          # build, warm up
        torch.cuda.synchronize()
        host.clear()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            pipeline.stereo_matching_all(cfg, tiles)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = defaultdict(float)
    for e in prof.key_averages():
        # device-side events only: a CPU op's device time repeats its kernels
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] += e.self_device_time_total / 1e3
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(f'bucket {bucket_name}: {len(specs)} tiles, wall {wall:.4f} s, '
          f'device busy {busy_ms:.3f} ms, idle share '
          f'{1 - busy_ms / 1e3 / wall:.4f}')
    host['other (padding, transfers, device wait)'] = wall - sum(host.values())
    for label, s in sorted(host.items(), key=lambda kv: -kv[1]):
        print(f'  host {label:40s} {s:.4f} s')
    for name, ms in top:
        print(f'  device {ms:9.3f} ms  {name[:90]}')
    print(json.dumps({
        'bucket': bucket_name, 'tiles': len(specs), 'card': card,
        'wall_s': wall, 'device_busy_ms': busy_ms,
        'idle_share': 1 - busy_ms / 1e3 / wall,
        'host_s': dict(host), 'device_ms_top': dict(top)}))
    return 0


if __name__ == '__main__':
    sys.exit(main(*sys.argv[1:]))
