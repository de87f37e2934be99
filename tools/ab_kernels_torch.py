#!/usr/bin/env python3
"""A/B timing of versions of the port's cost pre-pass (K1), averaged-MGM
scan (K4b), WTA with the right-reference map (K5) and homography warp
(W1) in one process, on the same inputs.

Usage, from the repo root on a machine with one CUDA card and nvcc:

    git show <commit>:s2p_tpu_torch/csrc/cost_prepass.cu > out/k1_old.cu
    git show <commit>:s2p_tpu_torch/csrc/scan_mgm.cu > out/k4b_old.cu
    git show <commit>:s2p_tpu_torch/csrc/wta.cu > out/k5_old.cu
    python3 tools/ab_kernels_torch.py --k1 out/k1_old.cu --k4b out/k4b_old.cu
    python3 tools/ab_kernels_torch.py --k5 out/k5_old.cu
    git show <commit>:s2p_tpu_torch/csrc/warp.cu > out/w1_old.cu
    python3 tools/ab_kernels_torch.py --w1 out/w1_old.cu
    git show <commit>:s2p_tpu_torch/csrc/box.cu > out/b1_old.cu
    python3 tools/ab_kernels_torch.py --b1 out/b1_old.cu

``--k1``, ``--k4b``, ``--k5``, ``--w1`` and ``--b1`` each take zero or
more sources, and only the kernels named run; the package's own
``csrc/cost_prepass.cu``, ``csrc/scan_mgm.cu``, ``csrc/wta.cu``,
``csrc/warp.cu`` and ``csrc/box.cu`` are appended as the last version.
Every source is built with the port's nvcc flags into
out/ab_kernels_build/ and its C entry (``s2p_cost_prepass``,
``s2p_scan_mgm``, ``s2p_wta_dr``, ``s2p_warp``; the signatures stay fixed
for this; B1's, ``s2p_box`` or ``s2p_window_costs``, below) runs on the
same random inputs:

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
    from -20, past the widest band: the windowed instantiation);
  * W1 at the scene's shapes: a 2000 x 2800 smoothed-noise source,
    outputs of 832 x 1024 under 6 homographies like stage 3's (tiles of
    800 px, small rotations), orders 1, 3 and 5, a group of 6 and one
    warp, and order 5 again with a NaN band across the source.  A version
    that exports ``s2p_warp_dilate`` (this package's) takes the mask
    dilated once by it (timed apart); an earlier one takes the float mask.
    Copies of the package's ``warp.cu``, made by text substitution and
    built only here, follow it as versions of their own: each undoes one
    mechanism of the design (all 42 weight terms, the IEEE division in
    place of ``div120``, every order-3 and order-5 pixel through the
    clamped taps, ``fmaxf`` dropped from the terms) and must give the
    same bits.  Then two ablation copies are timed at order 5 without
    outputs compared: the weights replaced by constants, and every tap
    replaced by a constant.  Last, ``cuobjdump -sass`` counts the
    instructions of each version's ``warp_kernel<5>``;
  * B1 at msmw's batteries of window costs on a scene tile (820 x 900):
    the finest level's match over 16 candidates (gathered as msmw's
    ``_direction`` gathers them, the candidates' planes interleaved
    with the rows) and a one-plane battery of fDistTrans.  A version
    that exports ``s2p_box`` (the one-axis box sums of the first port)
    runs as the first port's ``_window_costs`` drove it: 30 launches of
    its kernel inside ``msmw._window_costs_plain``'s shears and
    elementwise steps; this package's ``s2p_window_costs`` is one
    launch.  Beside each version's time: its kernels a call and their
    device time under ``torch.profiler``, and the bound of
    ``msmw.window_costs_work``; then ``cuobjdump -sass`` counts the
    instructions of this package's ``window_costs_kernel``.

Each case runs its versions forward then backward (v0 .. vn, vn .. v0;
median of 5 CUDA-event runs each, behind a device-side spin), and every
version's outputs are compared with the first's bit for bit (+0 and -0
differ; any NaN equals any NaN).  Then K4b's step
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

# msmw's finest level on a scene tile (rows, columns)
B1_SHAPE = (820, 900)
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
            if ('registers' in line or 'spill' in line
                    or 'entry function' in line):
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


_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64,
           torch.float16: torch.int16, torch.bfloat16: torch.int16}


def bitwise(a, b):
    """Equal bit for bit (so +0 differs from -0), any NaN equal to any NaN
    whatever its payload."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        it = _INT_OF[a.dtype]
        return bool(((a.view(it) == b.view(it))
                     | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


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
        same = all(bitwise(a, b) for a, b in zip(first[k], ref))
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


# W1: the source, the outputs, the source rows made NaN for the masked
# cases; the variants of warp.cu, each undoing one mechanism of the
# design, which must give the same bits; and the ablation copies, whose
# outputs differ (label, ((text, replacement), ...))
W1_SRC = (2000, 2800)
W1_OUT = (832, 1024)
W1_NAN_ROWS = (1000, 1004)
W1_VARIANTS = (
    ('42 terms', (
        ('const float c[6] = {1.f, -6.f, 15.f, -20.f, 15.f, -6.f};',
         'const float c[7] = {1.f, -6.f, 15.f, -20.f, 15.f, -6.f, 1.f};'),
        ('for (int k = 0; k <= 3 - o; ++k)', 'for (int k = 0; k <= 6; ++k)'))),
    ('IEEE division', (
        ('w[o + 2] = div120(acc);', 'w[o + 2] = acc / 120.0f;'),)),
    ('clamped taps only', (
        ('const bool interior = (x0', 'const bool interior = false && (x0'),)),
    ('no fmaxf', (
        ('const float u = fmaxf(v - (float)k, 0.0f);',
         'const float u = v - (float)k;'),)))
W1_ABLATIONS = (
    ('weights constant', ((
        '      weights5(tx, wx);\n      weights5(ty, wy);\n',
        '      for (int i = 0; i < N; ++i) {\n'
        '        wx[i] = 0.125f * (float)(i + 1);\n'
        '        wy[i] = 0.0625f * (float)(i + 1);\n'
        '      }\n'),)),
    ('taps constant', ((
        'float ld(const float* p) { return __ldg(p); }',
        'float ld(const float* p) { return 1.0f; }'),)))


# B1's ablation copies, timed at the finest battery without their
# outputs compared: each takes one part of the work away
B1_ABLATIONS = (
    ('divisions as products', ((
        '    q = div_rcp(m1, mc, r);\n    c = div_rcp(m2, mc, r);',
        '    q = m1 * r;\n    c = m2 * r;'),)),
    ('no diagonals', ((
        '  if (!var) {\n    __syncthreads();',
        '  if (false) {\n    __syncthreads();'),)),
    ('staging and the vertical sums only', ((
        '  // 3. the box windows',
        '  if (w > 0) return;\n  // 3. the box windows'),)),
    ('staging only', ((
        '  // 2. the vertical sums',
        '  if (w > 0) return;\n  // 2. the vertical sums'),)))


def edited_copies(src, out, edits, stem):
    """{label: path} of the copies of ``src`` that ``edits`` make (as
    W1_VARIANTS), written to ``out``."""
    with open(src) as f:
        text = f.read()
    paths = {}
    os.makedirs(out, exist_ok=True)
    for k, (label, subs) in enumerate(edits):
        new = text
        for old, rep in subs:
            if new.count(old) != 1:
                raise RuntimeError(f'copy {label!r}: {old!r} is not in '
                                   f'{src} once')
            new = new.replace(old, rep)
        paths[label] = os.path.join(out, f'{stem}_{k}.cu')
        with open(paths[label], 'w') as f:
            f.write(new)
    return paths


def sass_counts(lib_path, kernel='warp_kernelILi5E'):
    """(instructions other than NOP, {opcode: count}) of the function whose
    mangled name holds ``kernel``, from ``cuobjdump -sass``."""
    import re
    tool = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    text = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                          text=True, check=True).stdout
    ops, inside = {}, False
    for line in text.splitlines():
        if 'Function :' in line:
            inside = kernel in line
            continue
        m = re.match(r'\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)',
                     line)
        if inside and m:
            op = m.group(2).split('.')[0]
            ops[op] = ops.get(op, 0) + 1
    return sum(v for k, v in ops.items() if k != 'NOP'), ops


def run_w1(libs, ablations, g):
    import numpy as np
    from scipy import ndimage
    from s2p_tpu_torch.ops import homography as hom
    from s2p_tpu_torch.ops import interp

    labels = list(libs)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    img = ndimage.uniform_filter(rng.rand(*W1_SRC).astype(np.float32) * 200,
                                 3)
    img_nan = img.copy()
    img_nan[W1_NAN_ROWS[0]:W1_NAN_ROWS[1]] = np.nan
    coeffs = hom._spline5_inputs(img)[0]
    coeffs_nan, mask = hom._spline5_inputs(img_nan)
    hv = []
    for k in range(6):      # output -> source: tile k of 800 px, rotated
        a = 0.004 * (k - 2.5)
        hv.append([[np.cos(a), -np.sin(a), 150.0 + 800 * (k % 3)],
                   [np.sin(a), np.cos(a), 150.0 + 800 * (k // 3)],
                   [1e-7 * k, -1e-7 * k, 1.0]])
    dev = 'cuda'
    hv6 = torch.tensor(np.array(hv, np.float32), device=dev)
    src = {5: torch.from_numpy(coeffs).to(dev), 3: torch.from_numpy(img)
           .to(dev), 1: torch.from_numpy(img).to(dev)}
    src_nan = torch.from_numpy(coeffs_nan).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    oh, ow = W1_OUT
    H, W = W1_SRC
    bad6 = {}
    for k in labels:
        if hasattr(libs[k], 's2p_warp_dilate'):
            fn = libs[k].s2p_warp_dilate
            fn.argtypes = interp._DILATE_ARGS
            fn.restype = ctypes.c_int
            bad6[k] = torch.empty((H, W), dtype=torch.uint8, device=dev)
            if fn(mask.data_ptr(), bad6[k].data_ptr(), H, W, stream):
                raise RuntimeError(f'{k}: s2p_warp_dilate failed')
            t = median_ms(lambda: fn(mask.data_ptr(), bad6[k].data_ptr(),
                                     H, W, stream))
            print(f'  W1 {k}: mask dilation {H} x {W} {t:.4f} ms (once per '
                  'source)', flush=True)
    for lib in list(libs.values()) + list(ablations.values()):
        lib.s2p_warp.argtypes = interp._WARP_ARGS
        lib.s2p_warp.restype = ctypes.c_int

    def launcher(lib, k, s, masked, hvs, order, out):
        m = (bad6[k] if k in bad6 else mask) if masked else None
        return lambda: lib.s2p_warp(
            s.data_ptr(), None if m is None else m.data_ptr(),
            hvs.data_ptr(), out.data_ptr(), len(hvs), H, W, oh, ow, order,
            stream)

    cases = [(f'order {o}{" masked" if m else ""}, {n}', o, m, hvs)
             for o, m in ((5, False), (5, True), (3, False), (1, False))
             for n, hvs in (('group of 6', hv6), ('one warp', hv6[:1]))]
    for name, order, masked, hvs in cases:
        s = src_nan if masked else src[order]
        out = torch.empty((len(hvs), oh, ow), device=dev)
        ab(f'W1 {name}', labels,
           lambda k: launcher(libs[k], k, s, masked, hvs, order, out), [out])
        if order == 5:
            n_in = int(torch.isfinite(out).sum()) // len(hvs)
            ops = interp.warp_ops(5, masked, n_in, oh * ow)
            print(f'  W1 {name} bound: {ops / 33.5e12 * 1e3:.4f} ms a warp '
                  f'({ops:.4g} operations at 33.5e12/s, {n_in} of '
                  f'{oh * ow} pixels sampled)', flush=True)
        if order == 5 and not masked:
            for label, lib in ablations.items():
                t = median_ms(launcher(lib, 'ablation', s, False, hvs, 5,
                                       out))
                print(f'  W1 {name}, ablation "{label}": {t:.4f} ms',
                      flush=True)
    for k, lib in list(libs.items()) + list(ablations.items()):
        n, ops = sass_counts(lib._name)
        top = ', '.join(f'{op} {c}' for op, c in
                        sorted(ops.items(), key=lambda kv: -kv[1])[:12])
        print(f'  W1 {k}: warp_kernel<5> SASS, {n} instructions other than '
              f'NOP ({top})', flush=True)


def b1_inputs(D, g):
    """(a, b_sh, fin_pair) of one battery on a tile of B1_SHAPE: smooth
    noise and its copy shifted by 2.5 px with a NaN corner, gathered at
    D candidates from -8 (or, with D 1, the copy alone) as msmw's
    ``_direction`` gathers them."""
    import torch.nn.functional as F
    h, w = B1_SHAPE
    noise = torch.rand((1, 1, h, w + 8), device='cuda', generator=g) * 200
    img = F.avg_pool2d(noise, 5, stride=1, padding=2)[0, 0]
    src, dst = img[:, 4:w + 4].contiguous(), img[:, 1:w + 1].contiguous()
    dst[:40, :60] = float('nan')
    fin_s, fin_d = torch.isfinite(src), torch.isfinite(dst)
    src, dst = torch.nan_to_num(src), torch.nan_to_num(dst)
    if D == 1:
        return src, dst[None], fin_s[None] & fin_d[None]
    ks = torch.arange(D, device='cuda')
    xs = torch.arange(w, device='cuda')[None, :] - 8 + ks[:, None]
    inb = (xs >= 0) & (xs < w)
    xs_c = xs.clamp(0, w - 1)
    b_sh = dst[:, xs_c].permute(1, 0, 2)
    fin = fin_s[None] & fin_d[:, xs_c].permute(1, 0, 2) & inb[:, None]
    return src, b_sh, fin


def b1_route(lib):
    """``msmw._window_costs``'s counterpart on one version of B1."""
    from s2p_tpu_torch.ops import msmw
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, 's2p_window_costs'):
        fn = lib.s2p_window_costs
        fn.argtypes, fn.restype = msmw._WINDOW_COSTS_ARGS, ctypes.c_int

        def run(a, b_sh, fin):
            D, h, w = b_sh.shape
            b_sh, fin = (t if t.stride(-1) == 1 else t.contiguous()
                         for t in (b_sh, fin))
            best = torch.empty((D, h, w), device='cuda')
            rc = fn(a.data_ptr(), b_sh.data_ptr(), fin.data_ptr(),
                    best.data_ptr(), None, D, h, w, a.stride(0),
                    b_sh.stride(0), b_sh.stride(1), fin.stride(0),
                    fin.stride(1), msmw._recip_area(4, 4),
                    msmw._recip_area(1, 4), stream)
            if rc:
                raise RuntimeError(f's2p_window_costs: CUDA error {rc}')
            return best
        return run
    fn = lib.s2p_box
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def box_sum(x, r, vertical, scale=0.0):
        # the first port's box_sum on a CUDA tensor
        x = x.contiguous()
        out = torch.empty_like(x)
        rc = fn(x.data_ptr(), out.data_ptr(), *x.shape, int(r),
                int(bool(vertical)), scale, stream)
        if rc:
            raise RuntimeError(f's2p_box: CUDA error {rc}')
        return out

    def run(a, b_sh, fin):
        plain = msmw.box_sum_plain
        msmw.box_sum_plain = box_sum
        try:
            return msmw._window_costs_plain(a, b_sh, fin)[0]
        finally:
            msmw.box_sum_plain = plain
    return run


def device_kernels(run):
    """(kernels launched, their device time in ms) of one call of ``run``
    under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    n, ms = 0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            ms += (e.time_range.end - e.time_range.start) / 1e3
    return n, ms


def run_b1(libs, ablations, g):
    from s2p_tpu_torch.ops import msmw
    labels = list(libs)
    routes = {k: b1_route(lib) for k, lib in libs.items()}
    cut = {label: b1_route(lib) for label, lib in ablations.items()}
    for name, D in (('finest battery', 16), ('one plane', 1)):
        a, b_sh, fin = b1_inputs(D, g)
        outs, times = {}, {k: [] for k in labels}
        for k in labels + labels[::-1]:
            outs.setdefault(k, routes[k](a, b_sh, fin))
            torch.cuda.synchronize()
            times[k].append(median_ms(lambda: routes[k](a, b_sh, fin)))
        nbytes, ops = msmw.window_costs_work(*b_sh.shape)
        print(f'  B1 {name} {tuple(b_sh.shape)}: bound '
              f'{max(nbytes / 3.35e12, ops / 33.5e12) * 1e3:.4f} ms '
              f'({ops} operations at 33.5e12/s, {nbytes} bytes at '
              f'3.35e12/s)', flush=True)
        for k in labels:
            n, dev_ms = device_kernels(lambda: routes[k](a, b_sh, fin))
            same = bitwise(outs[k], outs[labels[-1]])
            ms = ', '.join(f'{t:.4f}' for t in times[k])
            print(f'  B1 {name} {k}: {ms} ms a call; {n} kernels a call, '
                  f'{dev_ms:.4f} ms of device time under the profiler; '
                  f'bitwise equal to {labels[-1]}: {same}', flush=True)
            if not same:
                raise AssertionError(f'B1 {name}: {k} differs from '
                                     f'{labels[-1]}')
        for label, run in cut.items():
            t = median_ms(lambda: run(a, b_sh, fin))
            print(f'  B1 {name}, ablation "{label}": {t:.4f} ms',
                  flush=True)
    for k, lib in libs.items():
        if hasattr(lib, 's2p_window_costs'):
            n, ops = sass_counts(lib._name, 'window_costs_kernel')
            top = ', '.join(f'{op} {c}' for op, c in
                            sorted(ops.items(), key=lambda kv: -kv[1])[:16])
            print(f'  B1 {k}: window_costs_kernel SASS, {n} instructions '
                  f'other than NOP ({top})', flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--k1', nargs='*')
    ap.add_argument('--k4b', nargs='*')
    ap.add_argument('--k5', nargs='*')
    ap.add_argument('--w1', nargs='*')
    ap.add_argument('--b1', nargs='*')
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
            ('k5', args.k5, 'wta.cu', run_k5),
            ('w1', args.w1, 'warp.cu', run_w1),
            ('b1', args.b1, 'box.cu', run_b1))
    srcs = {}
    for key, old, own, _ in runs:
        if old is not None:
            srcs.update({f'{key}_v{i}': p for i, p in enumerate(old)})
            srcs[f'{key}_new'] = os.path.join(csrc, own)
    ablations = {}
    if args.w1 is not None:
        own = os.path.join(csrc, 'warp.cu')
        variants = edited_copies(own, out, W1_VARIANTS, 'w1_variant')
        srcs.update({f'w1_{label.replace(" ", "_")}': p
                     for label, p in variants.items()})
        ablations = edited_copies(own, out, W1_ABLATIONS, 'w1_ablation')
        srcs.update({f'w1ablation_{k}': p
                     for k, p in enumerate(ablations.values())})
    b1_cut = {}
    if args.b1 is not None:
        b1_cut = edited_copies(os.path.join(csrc, 'box.cu'), out,
                               B1_ABLATIONS, 'b1_ablation')
        srcs.update({f'b1ablation_{k}': p
                     for k, p in enumerate(b1_cut.values())})
    libs = build(srcs, out)
    for k, p in srcs.items():
        print(f'  {k}: {os.path.relpath(p, ROOT)}', flush=True)
    g = torch.Generator(device='cuda').manual_seed(0)
    for key, old, _, fn in runs:
        if old is None:
            continue
        mine = {k: v for k, v in libs.items() if k.startswith(key + '_')}
        if key == 'w1':
            fn(mine, {label: libs[f'w1ablation_{k}'] for k, label in
                      enumerate(ablations)}, g)
        elif key == 'b1':
            fn(mine, {label: libs[f'b1ablation_{k}'] for k, label in
                      enumerate(b1_cut)}, g)
        else:
            fn(mine, g)
    return 0


if __name__ == '__main__':
    sys.exit(main())
