#!/usr/bin/env python3
"""Where K2 (the flow's scan, csrc/scan.cu s2p_scan) spends a step: the
kernel as it is against copies of it with its device-memory traffic taken
out, on one GPU.

Usage, from the repo root on a machine with one CUDA card and nvcc:

    python3 tools/ablate_scan_torch.py

Variants, each built with the port's nvcc flags into out/ablate_scan/ by
text substitution in s2p_tpu_torch/csrc/scan.cu (the script stops if the
source no longer holds the text it replaces):

  * kernel: the source as it is;
  * no stores: S is written only where a value equals -1.2345 (never);
  * no loads: the cost row, p2, S and accum come from registers;
  * neither: both.

Each runs one vertical pass (8 x 448 x 512, 80 candidates, laterals 0, +1,
-1) and one horizontal pass (8 x 512 x 448, lateral 0) on random costs,
median of 5 CUDA-event runs after a warm run, and prints the time and the
time per scan step.  Only the kernel's outputs are meaningful; the others
measure what is left of a step without the traffic.  It prints the card's
name and power limit first.
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

LOADS = (('sl.p2v = __ldg(pb + n * lanes + x);', 'sl.p2v = 32.f;'),
         ('r.v[j] = kFull || j < cnt ? __ldg(p + j * sk) : 0;',
          'r.v[j] = (uint8_t)((k0 + j + n) & 15);'),
         ('sl.sp[j] = in ? Sb[o + j * lanes] : 0.f;', 'sl.sp[j] = 0.f;'),
         ('sl.ac[j] = in ? __ldg(ab + o + j * lanes) : 0.f;',
          'sl.ac[j] = 0.f;'))
STORES = (('if (kFull || j < cnt) Sp[j * lanes] = ssum;',
           'if ((kFull || j < cnt) && ssum == -1.2345f) '
           'Sp[j * lanes] = ssum;'),)
CASES = (('vertical', (8, 448, 80, 512), (0, 1, -1)),
         ('horizontal', (8, 512, 80, 448), (0,)))


def variant(src, subs):
    for old, new in subs:
        if old not in src:
            raise SystemExit(f'scan.cu no longer holds: {old}')
        src = src.replace(old, new)
    return src


def build(out):
    with open(os.path.join(ROOT, 's2p_tpu_torch', 'csrc', 'scan.cu')) as f:
        src = f.read()
    srcs = {'kernel': src, 'no stores': variant(src, STORES),
            'no loads': variant(src, LOADS),
            'neither': variant(src, LOADS + STORES)}
    os.makedirs(out, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        path = os.path.join(out, f'v{i}.cu')
        with open(path, 'w') as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o',
             os.path.join(out, f'libv{i}.so'), path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), i)
    libs = {}
    for name, (p, i) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        lib = ctypes.CDLL(os.path.join(out, f'libv{i}.so'))
        lib.s2p_scan.argtypes = sk._ARGTYPES['s2p_scan']
        lib.s2p_scan.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(os.path.join(ROOT, 'out', 'ablate_scan'))
    g = torch.Generator(device='cuda').manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for case, (B, N, D, L), lats in CASES:
        cost = torch.randint(0, 25, (B, N, D, L), dtype=torch.uint8,
                             device='cuda', generator=g)
        cost[torch.rand(cost.shape, device='cuda', generator=g) < 0.1] = 255
        p2 = torch.full((B, N, L), 32.0, device='cuda')
        S = torch.empty((B, N, D, L), device='cuda')
        V = torch.empty((B, len(lats), N, L), dtype=torch.int32,
                        device='cuda')
        lat3 = lats + (0,) * (3 - len(lats))
        for name, lib in libs.items():
            def run():
                return lib.s2p_scan(cost.data_ptr(), *cost.stride(),
                                    p2.data_ptr(), None, S.data_ptr(),
                                    V.data_ptr(), B, N, D, L, len(lats),
                                    *lat3, 8.0, 1e9, 0.0, 0, stream)

            if run() != 0:
                raise RuntimeError(f'{name}: launch refused')
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
            ms = statistics.median(ts)
            print(f'  {case} pass ({B} x {N} x {D} x {L}, {len(lats)} '
                  f'directions), {name}: {ms:.3f} ms, '
                  f'{ms * 1e3 / (N * len(lats)):.3f} us a step', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
