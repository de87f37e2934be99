#!/usr/bin/env python3
"""Where the classic SGM matcher of the PyTorch/CUDA port spends its time.

Usage (from the repo root, on a machine with a CUDA card):

    python3 tools/profile_sgm_torch.py [pair|tile] [volume|full]

Makes ``chip_smoke.py``'s classic pair (512 x 512, 64 candidates from -8;
the default) or tile (800 x 800, padded to 832 x 832 x 96), runs
``ops.sgm.match_pair`` once to build and warm up, then once more under
``torch.profiler`` with the given ``lr_mode`` (default 'volume').  It
prints the wall time, the device time of each kernel (the port's CUDA
kernels and PyTorch's own, grouped by name), the device's busy time and
idle share, and ends with the same numbers as one JSON line.  It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(cell='pair', lr_mode='volume'):
    import torch
    if not torch.cuda.is_available():
        print('profile_sgm_torch: CUDA is not available', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from s2p_tpu_torch.ops.sgm import SgmParams, match_pair

    spec = {'pair': cs.SGM_PAIR, 'tile': cs.SGM_TILE}[cell]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    im1, im2 = cs.sgm_pair(spec)
    params = SgmParams(mgm=False, lr_mode=lr_mode)

    def run():
        return match_pair(im1, im2, spec['dmin'], spec['dmax'], params)

    run()                                             # build, warm up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = defaultdict(float)
    for e in prof.key_averages():
        # device-side events only: a CPU op's device time repeats its kernels
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] += e.self_device_time_total / 1e3
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(f"{cell} ({spec['h']} x {spec['w']}, lr_mode {lr_mode}): wall "
          f'{wall:.4f} s, device busy {busy_ms:.3f} ms, idle share '
          f'{1 - busy_ms / 1e3 / wall:.4f}')
    for name, ms in top:
        print(f'  device {ms:9.3f} ms  {name[:90]}')
    print(json.dumps({
        'cell': cell, 'lr_mode': lr_mode, 'card': card, 'wall_s': wall,
        'device_busy_ms': busy_ms, 'idle_share': 1 - busy_ms / 1e3 / wall,
        'device_ms_top': dict(top)}))
    return 0


if __name__ == '__main__':
    sys.exit(main(*sys.argv[1:]))
