#!/usr/bin/env python3
"""A/B timing of two versions of the port's scan kernel (K2, cost mode).

Usage, from the repo root on a machine with one CUDA card and nvcc:

    git show <commit>:s2p_tpu_torch/csrc/scan.cu > out/scan_old.cu
    python3 tools/ab_scan_torch.py out/scan_old.cu [new.cu]

Both sources (the second defaults to s2p_tpu_torch/csrc/scan.cu) are built
with the port's nvcc flags into out/ab_scan_build/ and their ``s2p_scan``
entries run on the same random uint8 cost volumes, at the flow's bucket
shapes (bucket A: 8 x 448 x 512 and 8 x 512 x 448, 80 candidates;
bucket B: 2 x 832 x 896 and 2 x 896 x 832, 96 candidates) with one and
three directions, and at one 64 x 896 tile with 528 candidates (new
version only when the old one refuses D > 512).  Each case runs in the
order new, old, old, new (median of 5 CUDA-event runs each) and the two
versions' S and votes are compared bitwise.  It prints the card's name
and power limit first.
"""

import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from s2p_tpu_torch.ops import _build, sgm_kernels as sk  # noqa: E402

CASES = ((8, 448, 80, 512), (8, 512, 80, 448), (2, 832, 96, 896),
         (2, 896, 96, 832), (1, 64, 528, 896))


def build(srcs, out):
    os.makedirs(out, exist_ok=True)
    procs = {k: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-o',
         os.path.join(out, f'lib{k}.so'), v], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, v in srcs.items()}
    libs = {}
    for k, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed for {k}:\n{log}')
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {k}: {line.strip()}')
        lib = ctypes.CDLL(os.path.join(out, f'lib{k}.so'))
        lib.s2p_scan.argtypes = sk._ARGTYPES['s2p_scan']
        lib.s2p_scan.restype = ctypes.c_int
        libs[k] = lib
    return libs


def main():
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    new = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        ROOT, 's2p_tpu_torch', 'csrc', 'scan.cu')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build({'old': sys.argv[1], 'new': new},
                 os.path.join(ROOT, 'out', 'ab_scan_build'))
    g = torch.Generator(device='cuda').manual_seed(0)
    for B, N, D, L in CASES:
        cost = torch.randint(0, 25, (B, N, D, L), dtype=torch.uint8,
                             device='cuda', generator=g)
        cost[torch.rand((B, N, D, L), device='cuda', generator=g) < 0.1] = 255
        p2 = torch.full((B, N, L), 32.0, device='cuda')
        for lats in ((0,), (0, 1, -1)):
            out = {}
            for name in ('new', 'old', 'old', 'new'):
                S = torch.empty((B, N, D, L), device='cuda')
                V = torch.empty((B, len(lats), N, L), dtype=torch.int32,
                                device='cuda')
                lat3 = lats + (0,) * (3 - len(lats))

                def run():
                    return libs[name].s2p_scan(
                        cost.data_ptr(), *cost.stride(), p2.data_ptr(), None,
                        S.data_ptr(), V.data_ptr(), B, N, D, L, len(lats),
                        *lat3, 8.0, 1e9, 0.0, 0,
                        torch.cuda.current_stream().cuda_stream)

                if run() != 0:
                    print(f'  B{B} N{N} D{D} L{L} lats {lats} {name}: '
                          'refused', flush=True)
                    continue
                torch.cuda.synchronize()
                ts = []
                for _ in range(5):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    run()
                    b.record()
                    torch.cuda.synchronize()
                    ts.append(a.elapsed_time(b))
                out.setdefault(name, (S, V))
                print(f'  B{B} N{N} D{D} L{L} lats {lats} {name}: '
                      f'{statistics.median(ts):.3f} ms', flush=True)
            if len(out) == 2:
                print('  bitwise S', torch.equal(out['old'][0], out['new'][0]),
                      'votes', torch.equal(out['old'][1], out['new'][1]),
                      flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
