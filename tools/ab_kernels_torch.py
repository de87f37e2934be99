#!/usr/bin/env python3
"""A/B timing of versions of the port's cost pre-pass (K1), averaged-MGM
scan (K4b) and WTA with the right-reference map (K5) in one process, on
the same inputs.

Usage, from the repo root on a machine with one CUDA card and nvcc:

    git show <commit>:s2p_tpu_torch/csrc/cost_prepass.cu > out/k1_old.cu
    git show <commit>:s2p_tpu_torch/csrc/scan_mgm.cu > out/k4b_old.cu
    git show <commit>:s2p_tpu_torch/csrc/wta.cu > out/k5_old.cu
    python3 tools/ab_kernels_torch.py --k1 out/k1_old.cu --k4b out/k4b_old.cu
    python3 tools/ab_kernels_torch.py --k5 out/k5_old.cu

``--k1``, ``--k4b`` and ``--k5`` each take zero or more sources, and only
the kernels named run; the package's own ``csrc/cost_prepass.cu``,
``csrc/scan_mgm.cu`` and ``csrc/wta.cu`` are appended as the last version.
Every source is built with the port's nvcc flags into
out/ab_kernels_build/ and its C entry (``s2p_cost_prepass``,
``s2p_scan_mgm``, ``s2p_wta_dr``; the signatures stay fixed for this) runs
on the same random inputs:

  * K1 at the flow's shapes, per side: bucket A (8 x 512 positions x 448
    lanes, 80 candidates, base 0), bucket B (2 x 896 x 832, 96), one tile
    at 528 candidates (1 x 896 x 64) and the single tile's signed base
    (1 x 800 x 800, 96 candidates from -40, the secondary padded);
  * K4b at the classic matcher's passes: the 512 x 512 pair (64
    candidates from -8) and the 832 x 832 tile (96 from -30), a vertical
    pass with 3 directions of 3 laterals and a horizontal pass with one
    direction of 2.  A version that exports ``s2p_scan_mgm_part_volumes``
    (this package's) runs its shared-memory instantiation and takes its
    directions' scratch; an earlier one takes a carry scratch;
  * K5 at the classic matcher's summed partials: S_v contiguous and S_h
    read in its (W, D, H) layout, at the 512 x 512 pair (64 candidates
    from -8), the 832 x 832 tile (96 from -30) and a 256 x 1600 strip (64
    from -20, past the widest band: the windowed instantiation).

Each case runs its versions forward then backward (v0 .. vn, vn .. v0;
median of 5 CUDA-event runs each, behind a device-side spin), and every
version's outputs are compared bitwise with the first's.  Then K4b's step
floor: the package's ``s2p_cluster_sync_loop`` (one cluster barrier per
step, nothing else) over each pass's step count.  It prints the card's
name and power limit first.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from s2p_tpu_torch.ops import _build, sgm_kernels as sk  # noqa: E402

# (name, B, N, lanes, D, disp_min)
K1_CASES = (('bucket A', 8, 512, 448, 80, 0), ('bucket B', 2, 896, 832, 96, 0),
            ('D 528', 1, 896, 64, 528, 0),
            ('signed base', 1, 800, 800, 96, -40))
# (name, N, lanes, D, disp_min, horizontal, laterals of each direction)
# (name, H, W, D, disp_min)
K5_CASES = (('pair', 512, 512, 64, -8), ('tile', 832, 832, 96, -30),
            ('strip 1600', 256, 1600, 64, -20))
K4B_CASES = (
    ('pair vf', 512, 512, 64, -8, False, ((0, 1, -1), (1, 0, -1), (-1, 0, 1))),
    ('pair hf', 512, 512, 64, -8, True, ((0, 1),)),
    ('tile vf', 832, 832, 96, -30, False,
     ((0, 1, -1), (1, 0, -1), (-1, 0, 1))),
    ('tile hf', 832, 832, 96, -30, True, ((0, 1),)))


def build(srcs, out):
    """{label: ctypes library}, one nvcc per source, in parallel."""
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
        for fn in ('s2p_cost_prepass', 's2p_cluster_sync_loop',
                   's2p_wta_dr'):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sk._ARGTYPES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[k] = lib
    return libs


def median_ms(run):
    """Median of 5 CUDA-event runs, each behind a device-side spin so the
    events time the card's work and not the host's enqueue."""
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def sigs(shape, g):
    v = torch.randint(0, 1 << 24, shape, device='cuda', generator=g)
    v |= (torch.rand(shape, device='cuda', generator=g) < 0.9).long() << 24
    return v.to(torch.int32)


def ab(name, labels, make_run, outs):
    """Time each version forward then backward and compare its outputs
    with the first version's."""
    times = {k: [] for k in labels}
    first = {}
    for k in labels + labels[::-1]:
        run = make_run(k)
        rc = run()
        if rc != 0:
            raise RuntimeError(f'{name} {k}: CUDA error {rc}')
        torch.cuda.synchronize()
        first.setdefault(k, [t.clone() for t in outs])
        times[k].append(median_ms(run))
    ref = first[labels[0]]
    for k in labels:
        same = all(torch.equal(a, b) for a, b in zip(first[k], ref))
        ms = ', '.join(f'{t:.4f}' for t in times[k])
        print(f'  {name} {k}: {ms} ms, bitwise equal to {labels[0]}: {same}',
              flush=True)
        if not same:
            raise AssertionError(f'{name}: {k} differs from {labels[0]}')


def run_k1(libs, g):
    labels = list(libs)
    stream = torch.cuda.current_stream().cuda_stream
    for name, B, N, L, D, dmin in K1_CASES:
        s1 = sigs((B, N, L), g)
        if dmin == 0:
            s2, pad, sec = sigs((B, N + D, L), g), 0, N + D
        else:
            s2, pad, sec = sk.prepass_secondary(
                sigs((B, L, N), g), N, dmin, D)
        al = (torch.arange(D, device='cuda') < D - 3).to(torch.int32)[None] \
            .expand(B, D).contiguous()
        out = torch.empty((B, N, D, L), dtype=torch.uint8, device='cuda')

        def make_run(k):
            return lambda: libs[k].s2p_cost_prepass(
                s1.data_ptr(), s2.data_ptr(), al.data_ptr(), out.data_ptr(),
                B, N, s2.shape[1], L, D, dmin, pad, sec, (1 << 24) - 1,
                stream)

        ab(f'K1 {name}', labels, make_run, [out])


def run_k4b(libs, g):
    labels = list(libs)
    stream = torch.cuda.current_stream().cuda_stream
    for name, N, W, D, dmin, hor, dirs in K4B_CASES:
        s1 = sigs((1, N, W), g)
        if hor:
            pad = max(0, -dmin, dmin + D)
            pad += (-(dmin + pad)) % 8
            s2 = torch.nn.functional.pad(sigs((1, N, W), g),
                                         (0, 0, pad, pad))
            len2 = s2.shape[1]
        else:
            pad, s2 = 0, sigs((1, N, W), g)
            len2 = W
        p2 = torch.full((1, N, W), 32.0, device='cuda')
        S = torch.empty((1, N, D, W), device='cuda')
        V = torch.empty((1, len(dirs), N, W), dtype=torch.int32,
                        device='cuda')
        carry = torch.empty((1, 2, len(dirs), D + 2, W), device='cuda')
        mins = torch.empty((1, 2, len(dirs), W), device='cuda')
        part = torch.empty((len(dirs), 1, N, D, W), device='cuda')
        n_lats = (ctypes.c_int * 3)(*[len(l) for l in dirs])
        lats = (ctypes.c_int * 9)(*[v for l in dirs
                                    for v in l + (0,) * (3 - len(l))])

        def make_run(k):
            # this package's version (a cluster per direction) runs its
            # shared instantiation and takes the directions' scratch; the
            # one before it (a cluster per tile and direction, one launch
            # per direction) takes a carry scratch
            new = hasattr(libs[k], 's2p_scan_mgm_part_volumes')
            fn = libs[k].s2p_scan_mgm
            fn.argtypes = sk._ARGTYPES['s2p_scan_mgm'][:9 + new] + \
                sk._ARGTYPES['s2p_scan_mgm'][10:]
            scratch = ((None, None, part.data_ptr()) if new
                       else (carry.data_ptr(), mins.data_ptr()))
            return lambda: fn(
                s1.data_ptr(), s2.data_ptr(), None, p2.data_ptr(), None,
                S.data_ptr(), V.data_ptr(), *scratch, 1, N, D, W, len2,
                int(hor), dmin, pad, N if hor else W, (1 << 24) - 1,
                len(dirs), n_lats,
                lats, 8.0, 24.0, 0.0, 0, stream)

        ab(f'K4b {name}', labels, make_run, [S, V])
        floor = libs[labels[-1]]
        t = median_ms(lambda: floor.s2p_cluster_sync_loop(1, N, stream))
        print(f'  K4b {name} step floor ({N} cluster barriers): {t:.4f} ms',
              flush=True)


def run_k5(libs, g):
    labels = list(libs)
    stream = torch.cuda.current_stream().cuda_stream
    for name, H, W, D, dmin in K5_CASES:
        sv = torch.rand((1, H, D, W), device='cuda', generator=g) * 1000
        sh = (torch.rand((1, W, D, H), device='cuda', generator=g) * 1000) \
            .permute(0, 3, 2, 1)
        disp = torch.empty((1, H, W), device='cuda')
        d = torch.empty((1, H, W), dtype=torch.int32, device='cuda')
        dR = torch.empty((1, H, W), device='cuda')

        def make_run(k):
            return lambda: libs[k].s2p_wta_dr(
                sv.data_ptr(), *sv.stride(), sh.data_ptr(), *sh.stride(), 2,
                disp.data_ptr(), d.data_ptr(), dR.data_ptr(), 1, H, D, W,
                dmin, 1, stream)

        ab(f'K5 {name}', labels, make_run, [disp, d, dR])
        print(f'  K5 {name} bound: '
              f'{(8 * sv.numel() + 12 * H * W) / 3.35e12 * 1e3:.4f} ms '
              '(bytes at 3.35 TB/s)', flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--k1', nargs='*')
    ap.add_argument('--k4b', nargs='*')
    ap.add_argument('--k5', nargs='*')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('ab_kernels_torch: CUDA is not available', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    csrc = os.path.join(ROOT, 's2p_tpu_torch', 'csrc')
    out = os.path.join(ROOT, 'out', 'ab_kernels_build')
    runs = (('k1', args.k1, 'cost_prepass.cu', run_k1),
            ('k4b', args.k4b, 'scan_mgm.cu', run_k4b),
            ('k5', args.k5, 'wta.cu', run_k5))
    srcs = {}
    for key, old, own, _ in runs:
        if old is not None:
            srcs.update({f'{key}_v{i}': p for i, p in enumerate(old)})
            srcs[f'{key}_new'] = os.path.join(csrc, own)
    libs = build(srcs, out)
    for k, p in srcs.items():
        print(f'  {k}: {os.path.relpath(p, ROOT)}', flush=True)
    g = torch.Generator(device='cuda').manual_seed(0)
    for key, old, _, fn in runs:
        if old is not None:
            fn({k: v for k, v in libs.items() if k.startswith(key + '_')}, g)
    return 0


if __name__ == '__main__':
    sys.exit(main())
