#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``s2p_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda) and the
packages torch, numpy and scipy; it imports nothing of JAX and nothing of
the JAX package.  Phases, each timed on a line of its own:

  1. device: the card's name and power limit (nvidia-smi), torch's version;
  2. build: the CUDA kernels, one nvcc per source in parallel, into
     s2p_tpu_torch/_build/;
  3. kernels of the mgm flow (stage 4) against their plain PyTorch
     versions on the card, on the inputs the main path gives them at
     bucket A's shapes (the cost pre-pass, the four scan passes of each
     side, the WTA), and the scan once more at 528 candidates (one 64 x
     896 tile), compared bitwise and NaN-aware, each timed with CUDA
     events;
  4. kernels of the classic SGM matcher against their plain versions, on
     the 512 x 512 pair with 64 candidates from -8 (bench.py): the four
     signature-mode scan passes (K4a), one vertical pass with 3 MGM
     laterals and one horizontal pass with 2 (K4b), the WTA with the
     right-reference map (K5);
  5. stage 4: synthetic rectified tiles in two buckets (A: 8 tiles padded
     to 448 x 512 with 80 candidates; B: 2 tiles at the default tile size,
     padded to 832 x 896 with 96 candidates) through
     ``pipeline.stereo_matching_all`` on the card; the files it writes are
     checked for shape and for the known shift of each tile, and two
     tiles of each bucket are held bitwise against the same entry run
     with device="cpu" (the plain versions);
  6. the classic matcher on the card: ``ops.sgm.match_pair`` on the
     512 x 512 pair and on an 800 x 800 tile (padded to 832 x 832, 96
     candidates), both with a known shift and NaN borders, once more with
     lr_mode='full', and ``sgm_kernels.aggregate`` with MGM laterals (the
     route of K4b); the known shift is checked on the finite inner pixels;
  7. the classic matcher on a 128 x 128 crop, card against device="cpu",
     byte for byte;
  8. stage 4 at 528 candidates: one 60 x 890 tile through
     ``stereo_matching_all``, its known shift, and its files byte for
     byte against the CPU run;
  9. (run right after phase 4) the single-tile and lane-fold modes of
     the kernels against their plain versions: the pre-pass at a signed base (-40, padded
     secondary) on an 800 x 800 tile with 96 candidates, the WTA's
     edge_subpix and plateau_zero modes on bucket A's summed partials
     (phase 3), and the four signature-mode scans of bucket A folded by 2
     (4 groups of 2 tiles, 448 x 1184 lanes vertical, 592 x 896
     horizontal, segment width 592), timed against the same scans over
     the 8 tiles unfolded and held bitwise against them;
 10. the single-tile entry on the card: ``ops.mgm_flow.mgm_binary_match``
     on a 797 x 803 tile (range -40..55, the padded route) and an
     800 x 800 tile (the aligned route), each bitwise against
     ``mgm_binary_match_batch`` on the same tile in a 1-tile bucket, with
     its known shift; ``core.matching.compute_disparity_map`` on the
     797 x 803 tile; a 128 x 160 crop with edge_subpix against
     device="cpu" byte for byte; the 800 x 800 call's wall time;
 11. the lane-folded batch: bucket A's 8 tiles with S2P_TPU_LANE_FOLD=3
     (two groups of 3 and a 2-tile tail) bitwise per tile against the
     unfolded batch on the card;
 12. a JSON line with, per kernel and mode, its launches during the
     phase that drives its path (5 for the flow's kernels, 6 for the
     classic matcher's, 8 for the scan at 528 candidates, 10 for the
     pre-pass at a signed base and the WTA's edge modes, 11 for the
     folded scan), its error against the plain version, its time, the
     plain version's time and the least time the card could take (bytes
     over 3.35 TB/s or f32 operations over 67 TFLOP/s, H100 SXM data
     sheet);
 13. the last line: {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the last line.
Without CUDA, or without the package beside it, it fails before any result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores

BUCKET_A = dict(n=8, h=448, w=512, D=80)
BUCKET_B = dict(n=2, h=832, w=896, D=96)
# stage 4 at more than 512 candidates: one tile, 64 x 896 padded, D 528
WIDE = dict(index=100, h=60, w1=890, w2=888, dmin=-20, dmax=500, shift=3.0,
            seed=100)
BUCKET_WIDE = dict(n=1, h=64, w=896, D=528)
# the classic matcher: bench.py's pair (512 x 512, 64 candidates from -8)
# and one tile at the default tile size (800 x 800, 96 candidates)
SGM_PAIR = dict(h=512, w=512, dmin=-8, dmax=55, shift=5, seed=0)
SGM_TILE = dict(h=800, w=800, dmin=-30, dmax=65, shift=5, seed=1)
# the single-tile entry: a tile below the alignment of 8 (the padded
# route) and one at the default tile size (the aligned route), 96
# candidates from -40
SINGLE = dict(index=300, h=797, w1=803, w2=803, dmin=-40, dmax=55,
              shift=4.5, seed=300)
SINGLE_800 = dict(index=301, h=800, w1=800, w2=800, dmin=-40, dmax=55,
                  shift=3.0, seed=301)
# lane folds: the kernel check's, and the batch entry's (8 tiles: two
# groups and a 2-tile tail)
KERNEL_FOLD = 2
BATCH_FOLD = 3


@contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f'== {name}', flush=True)
    yield
    print(f'== {name}: {time.perf_counter() - t0:.3f} s', flush=True)


def tile_specs(bucket, first_index):
    """True extents, ranges and shifts of a bucket's tiles: a little below
    the padded shape, with different disparity bases."""
    specs = []
    for k in range(bucket['n']):
        h = bucket['h'] - 6 * k - 2
        w = bucket['w'] - 7 * k - 3
        d_true = bucket['D'] - k - 1
        dmin = -(d_true // 3) - 2 * k
        specs.append(dict(index=first_index + k, h=h, w1=w, w2=w - 2 * (k % 2),
                          dmin=dmin, dmax=dmin + d_true - 1,
                          shift=2.0 + 0.5 * k, seed=first_index + k))
    return specs


def make_pair(spec):
    """Smooth random texture; the reference is the secondary shifted by
    the tile's known disparity, NaN over a few border rows and columns."""
    import numpy as np
    rng = np.random.RandomState(spec['seed'])
    h, w = spec['h'], max(spec['w1'], spec['w2'])
    tex = rng.rand(h, w).astype(np.float32) * 200
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3
    xs = np.arange(w, dtype=np.float32)
    ref = np.stack([np.interp(xs + spec['shift'], xs, row) for row in tex])
    ref = ref.astype(np.float32)[:, :spec['w1']]
    sec = tex[:, :spec['w2']].copy()
    ref[:5] = np.nan
    sec[:, -7:] = np.nan
    return ref, sec


def write_tile(root, spec, ref, sec):
    import numpy as np
    from s2p_tpu_torch.geo import geotiff
    pair_dir = os.path.join(root, f"tile_{spec['index']}", 'pair_1')
    os.makedirs(pair_dir, exist_ok=True)
    geotiff.write(os.path.join(pair_dir, 'rectified_ref.tif'), ref,
                  nodata=float('nan'))
    geotiff.write(os.path.join(pair_dir, 'rectified_sec.tif'), sec,
                  nodata=float('nan'))
    np.savetxt(os.path.join(pair_dir, 'disp_min_max.txt'),
               [spec['dmin'], spec['dmax']])
    return {'dir': os.path.dirname(pair_dir)}


def equal(a, b):
    """(bitwise equal NaN-aware, max abs error over finite pairs)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float('inf')
    if a.dtype.is_floating_point:
        both_nan = torch.isnan(a) & torch.isnan(b)
        same = (a == b) | both_nan
        fin = torch.isfinite(a) & torch.isfinite(b)
        err = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
        if (torch.isnan(a) != torch.isnan(b)).any():
            err = float('inf')
        return bool(same.all()), err
    same = a == b
    err = (a.long() - b.long()).abs().max().item() if a.numel() else 0
    return bool(same.all()), float(err)


def timed(fn, reps):
    """Median ms of ``reps`` runs between CUDA events, after one warm run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound(nbytes, ops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return (t_b, 'bytes') if t_b >= t_o else (t_o, 'operations')


def bucket_arrays(specs, bucket, pairs):
    """The padded batch stereo_matching_all builds for one bucket."""
    import numpy as np
    n, H, W = len(specs), bucket['h'], bucket['w']
    b1 = np.full((n, H, W), np.nan, np.float32)
    b2 = np.full((n, H, W), np.nan, np.float32)
    for k, s in enumerate(specs):
        ref, sec = pairs[s['index']]
        b1[k, :ref.shape[0], :ref.shape[1]] = ref
        b2[k, :sec.shape[0], :sec.shape[1]] = sec
    return b1, b2


def record(stats, name, side, ok, err, ms, plain_ms, nbytes, ops, tag=''):
    """Print one kernel comparison and add it to the stats of the kernel
    (the first word of ``name``, plus ``tag``); the JSON line reports the
    L side of the flow's kernels."""
    t_bound, by = bound(nbytes, ops)
    print(f'  {name:16s} {side}: bitwise={ok} max_abs_err={err} '
          f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
          f'bound {t_bound:.4f} ms ({by})', flush=True)
    if not ok:
        raise AssertionError(f'{name} ({side}) differs from its plain '
                             f'version: max abs error {err}')
    if side in ('L', ''):
        st = stats.setdefault(name.split()[0] + tag, dict(
            err=0.0, ms=0.0, plain_ms=0.0, nbytes=0, ops=0))
        st['err'] = max(st['err'], err)
        st['ms'] += ms
        st['plain_ms'] += plain_ms
        st['nbytes'] += nbytes
        st['ops'] += ops


def check_kernels(specs, pairs, stats, bucket=BUCKET_A, tag=''):
    """Phase 3: every kernel of the flow against its plain version, on the
    inputs the main path gives it at the bucket's shapes; ``tag`` is
    appended to the kernels' names in ``stats``."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    v = mf.MgmVariant()
    D = bucket['D']
    b1, b2 = bucket_arrays(specs, bucket, pairs)
    dev = torch.device('cuda')

    def ints(key):
        return torch.tensor([s[key] for s in specs], dtype=torch.int32,
                            device=dev)

    dm = ints('dmin')
    dt = ints('dmax') - dm + 1
    h, w1, w2 = ints('h'), ints('w1'), ints('w2')
    s1 = mf.census_bits_raw(torch.as_tensor(b1, device=dev), v.census_win)
    s2 = mf.census_bits_raw(torch.as_tensor(b2, device=dev), v.census_win)
    allowed = (torch.arange(D, device=dev)[None, :] < dt[:, None]) \
        .to(torch.int32)
    nbits = v.census_win ** 2 - 1
    sides = {'L': (s1, s2, dm, h, w1, w2, True),
             'R': (s2, s1, -(dm + dt - 1), h, w2, w1, False)}

    def rec(name, *a):
        record(stats, name, *a, tag=tag)

    for side, (sref, ssec, base, hr, wr, ws, votes) in sides.items():
        sr, ss, _ = mf._side_sigs(sref, ssec, base, hr, wr, ws, D)
        s1t = sr.transpose(1, 2).contiguous()
        s2t = ss.transpose(1, 2).contiguous()
        args = (s1t, s2t, D, 0, nbits, 0, s2t.shape[1], allowed)
        cost_h = sk.cost_prepass(*args)
        ok, err = equal(cost_h, sk.cost_prepass_plain(*args))
        rec('cost_prepass', side, ok, err,
               timed(lambda: sk.cost_prepass(*args), 5),
               timed(lambda: sk.cost_prepass_plain(*args), 2),
               4 * s1t.numel() + 4 * s2t.numel() + 4 * allowed.numel()
               + cost_h.numel(), 0)

        S = {'v': None, 'h': None}
        passes = sk.scan_passes(v)
        sub = float(sum(len(i) for _, i, _ in passes) - 1)
        for key, _, lats in passes:
            o = key[0]
            cost = (cost_h.permute(0, 3, 2, 1).contiguous() if o == 'v'
                    else cost_h)
            B, N, _, lanes = cost.shape
            p2 = torch.full((B, N, lanes), v.p2, dtype=torch.float32,
                            device=dev)
            kw = dict(reverse=key[1] == 'b', sub_cost_mult=sub, accum=S[o],
                      emit_votes=votes)
            Sk, vk = sk.scan(cost, p2, lats, v.p1, mf.BIG, **kw)
            Sp, vp = sk.scan_plain(cost, p2, lats, v.p1, mf.BIG, **kw)
            ok, err = equal(Sk, Sp)
            if votes:
                ok_v, err_v = equal(vk, vp)
                ok, err = ok and ok_v, max(err, err_v)
            vol = Sk.numel()
            nbytes = (cost.numel() + 4 * p2.numel() + 4 * vol
                      + (4 * vol if S[o] is not None else 0)
                      + (4 * vk.numel() if votes else 0))
            ops = vol * (8 * len(lats) + 3)
            rec(f'scan {key}', side, ok, err,
                   timed(lambda: sk.scan(cost, p2, lats, v.p1, mf.BIG, **kw),
                         5),
                   timed(lambda: sk.scan_plain(cost, p2, lats, v.p1, mf.BIG,
                                               **kw), 1),
                   nbytes, ops)
            S[o] = Sk
            sub = 0.0
            del Sp, vp

        parts = [S['v'], S['h'].permute(0, 3, 2, 1)]
        off, d_int = sk.wta(parts, v.subpix, mf.BIG / 2)
        off_p, d_p = sk.wta_plain(parts, v.subpix, mf.BIG / 2)
        ok, err = equal(off, off_p)
        ok_d, err_d = equal(d_int, d_p)
        vol = parts[0].numel()
        rec('wta', side, ok and ok_d, max(err, err_d),
               timed(lambda: sk.wta(parts, v.subpix, mf.BIG / 2), 5),
               timed(lambda: sk.wta_plain(parts, v.subpix, mf.BIG / 2), 2),
               8 * vol + 4 * off.numel() + 4 * d_int.numel(), 2 * vol)
        if not tag:
            # the single-tile flow's modes on the same partials: each
            # alone, then both (timed)
            for one in ({'edge_subpix': True}, {'plateau_zero': True}):
                got = sk.wta(parts, v.subpix, mf.BIG / 2, **one)
                ref = sk.wta_plain(parts, v.subpix, mf.BIG / 2, **one)
                if not all(equal(a, b)[0] for a, b in zip(got, ref)):
                    raise AssertionError(f'wta {one} ({side}) differs from '
                                         'its plain version')
            edge = dict(edge_subpix=True, plateau_zero=True)
            off_e, d_e = sk.wta(parts, v.subpix, mf.BIG / 2, **edge)
            off_ep, d_ep = sk.wta_plain(parts, v.subpix, mf.BIG / 2, **edge)
            ok, err = equal(off_e, off_ep)
            ok_d, err_d = equal(d_e, d_ep)
            moved = int((~((off_e == off) | (torch.isnan(off_e)
                                             & torch.isnan(off)))).sum())
            print(f'  wta_edge {side}: {moved} offsets differ from the '
                  'default mode', flush=True)
            rec('wta_edge', side, ok and ok_d, max(err, err_d),
                timed(lambda: sk.wta(parts, v.subpix, mf.BIG / 2, **edge),
                      5),
                timed(lambda: sk.wta_plain(parts, v.subpix, mf.BIG / 2,
                                           **edge), 2),
                8 * vol + 4 * off.numel() + 4 * d_int.numel(), 2 * vol)
        del S, parts, cost_h
        torch.cuda.empty_cache()


def check_outputs(root, specs, cpu_root, cpu_indices):
    """Phase 4 checks: the written files, the known shifts, and bitwise
    equality with the CPU run on the tiles it covered."""
    import numpy as np
    from s2p_tpu_torch.geo import geotiff
    names = ('rectified_disp.tif', 'rectified_mask.png',
             'rectified_disp_confidence.tif')
    for s in specs:
        d = os.path.join(root, f"tile_{s['index']}", 'pair_1')
        disp = geotiff.read(os.path.join(d, names[0]))
        mask = geotiff.read_png(os.path.join(d, names[1]))
        conf = geotiff.read(os.path.join(d, names[2]))
        shape = (s['h'], s['w1'])
        if disp.shape != shape or mask.shape != shape or conf.shape != shape:
            raise AssertionError(f"tile {s['index']}: shapes {disp.shape} "
                                 f"{mask.shape} {conf.shape} != {shape}")
        if disp.dtype != np.float32 or conf.dtype != np.float32:
            raise AssertionError(f"tile {s['index']}: dtypes {disp.dtype} "
                                 f'{conf.dtype}')
        if not np.array_equal(mask > 0, np.isfinite(disp)):
            raise AssertionError(f"tile {s['index']}: mask != finite disp")
        if not (np.isin(conf * 8, np.arange(9))).all():
            raise AssertionError(f"tile {s['index']}: confidence not k/8")
        inner = disp[8:-8, 8:-8]
        fin = np.isfinite(inner)
        good = (np.abs(inner[fin] - s['shift']) < 1.0).mean()
        print(f"  tile {s['index']}: {shape}, finite inner "
              f"{fin.mean():.4f}, within 1 px of {s['shift']}: {good:.4f}",
              flush=True)
        if fin.mean() < 0.8 or good <= 0.95:
            raise AssertionError(f"tile {s['index']}: the known shift is "
                                 'not recovered')
        if s['index'] in cpu_indices:
            c = os.path.join(cpu_root, f"tile_{s['index']}", 'pair_1')
            for name in names:
                with open(os.path.join(d, name), 'rb') as f1, \
                        open(os.path.join(c, name), 'rb') as f2:
                    if f1.read() != f2.read():
                        raise AssertionError(f"tile {s['index']}: {name} "
                                             'differs from the CPU run')
            print(f"  tile {s['index']}: the three files equal the CPU "
                  'run byte for byte', flush=True)


def sgm_pair(spec):
    """bench.py's pair: uniform noise, the secondary the reference moved
    right by ``shift`` px plus noise (disparity +shift); NaN borders."""
    import numpy as np
    rng = np.random.RandomState(spec['seed'])
    h, w = spec['h'], spec['w']
    im1 = rng.rand(h, w).astype(np.float32) * 1000
    im2 = np.roll(im1, spec['shift'], axis=1) + rng.rand(h, w).astype(
        np.float32)
    im1[:4] = np.nan
    im2[:, -6:] = np.nan
    return im1, im2


def check_sgm_kernels(stats):
    """Phase 4: the classic matcher's kernels against their plain versions
    on the inputs ``aggregate_partials`` gives them for bench.py's pair."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk
    from s2p_tpu_torch.ops.census import census_transform
    from s2p_tpu_torch.ops.sgm import SgmParams

    dev = torch.device('cuda')
    im1, im2 = sgm_pair(SGM_PAIR)
    dmin = SGM_PAIR['dmin']
    D = SGM_PAIR['dmax'] - dmin + 1
    H, W = im1.shape
    sig = [sk._pack(*census_transform(torch.as_tensor(im, device=dev), 5))
           [None] for im in (im1, im2)]
    p2 = torch.full((1, H, W), 32.0, dtype=torch.float32, device=dev)
    ins = {'v': (sig[0], sig[1], p2),
           'h': tuple(t.transpose(1, 2).contiguous()
                      for t in (sig[0], sig[1], p2))}

    def run_pass(name, key, dirs):
        o = key[0]
        args = (*ins[o], dirs, 8.0, 24.0, 24, D, dmin, W, key[1] == 'b',
                o == 'h')
        Sk, vk = sk.scan_sig(*args)
        Sp, vp = sk.scan_sig_plain(*args)
        ok, err = equal(Sk, Sp)
        ok_v, err_v = equal(vk, vp)
        vol = Sk.numel()
        nbytes = (sum(4 * t.numel() for t in ins[o]) + 4 * vol
                  + 4 * vk.numel())
        # per element: the census cost (xor, and, popcount, 3 tests),
        # 8 f32 operations per lateral, the sums and the vote
        ops = vol * (6 + sum(8 * len(l) + 3 for l in dirs))
        record(stats, f'{name} {key}', '', ok and ok_v, max(err, err_v),
               timed(lambda: sk.scan_sig(*args), 3),
               timed(lambda: sk.scan_sig_plain(*args), 1), nbytes, ops)
        return Sk

    S = {}
    for key, _, dirs in sk.sgm_scan_passes(SgmParams(mgm=False)):
        Sk = run_pass('scan_sig', key, dirs)
        S[key[0]] = Sk if key[0] not in S else S[key[0]] + Sk
    for nb, want in ((3, 'vf'), (2, 'hf')):
        for key, _, dirs in sk.sgm_scan_passes(
                SgmParams(mgm=True, mgm_neighbors=nb)):
            if key == want:
                run_pass('scan_mgm', key, dirs)

    parts = [S['v'], S['h'].permute(0, 3, 2, 1)]
    got = sk.wta_dr(parts, dmin, 'vfit')
    ref = sk.wta_dr_plain(parts, dmin, 'vfit')
    oks, errs = zip(*(equal(a, b) for a, b in zip(got, ref)))
    vol = parts[0].numel()
    record(stats, 'wta_dr', '', all(oks), max(errs),
           timed(lambda: sk.wta_dr(parts, dmin, 'vfit'), 5),
           timed(lambda: sk.wta_dr_plain(parts, dmin, 'vfit'), 2),
           8 * vol + 12 * H * W, 4 * vol)
    del S, parts
    torch.cuda.empty_cache()


def check_shift(name, disp, valid, conf, spec, nv=8):
    """The classic matcher's outputs: shapes, types, the NaN pattern, the
    confidence steps, and the known shift on the finite inner pixels."""
    import numpy as np
    shape = (spec['h'], spec['w'])
    if disp.shape != shape or valid.shape != shape or conf.shape != shape:
        raise AssertionError(f'{name}: shapes {disp.shape} {valid.shape} '
                             f'{conf.shape} != {shape}')
    if disp.dtype != np.float32 or conf.dtype != np.float32:
        raise AssertionError(f'{name}: dtypes {disp.dtype} {conf.dtype}')
    if not np.array_equal(valid, np.isfinite(disp)):
        raise AssertionError(f'{name}: valid != finite disp')
    if not np.isin(conf * nv, np.arange(nv + 1)).all():
        raise AssertionError(f'{name}: confidence not k/{nv}')
    inner = disp[8:-8, 8:-16]
    fin = np.isfinite(inner)
    good = (np.abs(inner[fin] - spec['shift']) < 1.0).mean()
    print(f'  {name}: {shape}, finite inner {fin.mean():.4f}, within 1 px '
          f"of {spec['shift']}: {good:.4f}", flush=True)
    if fin.mean() < 0.8 or good <= 0.95:
        raise AssertionError(f'{name}: the known shift is not recovered')


def run_sgm_path():
    """Phase 6: the classic matcher's entry points on the card."""
    import numpy as np
    import torch
    from s2p_tpu_torch.ops import sgm as tsgm
    from s2p_tpu_torch.ops import sgm_kernels as sk

    p = tsgm.SgmParams(mgm=False)
    pair = sgm_pair(SGM_PAIR)
    for name, spec, params in (
            ('match_pair 512', SGM_PAIR, p),
            ('match_pair 800', SGM_TILE, p),
            ("match_pair 512 lr_mode='full'", SGM_PAIR,
             tsgm.SgmParams(mgm=False, lr_mode='full'))):
        im1, im2 = pair if spec is SGM_PAIR else sgm_pair(spec)
        t0 = time.perf_counter()
        out = tsgm.match_pair(im1, im2, spec['dmin'], spec['dmax'], params)
        print(f'  {name}: {time.perf_counter() - t0:.3f} s', flush=True)
        check_shift(name, *out, spec)
    # K4b's route: a direct aggregate call with MGM laterals
    dev = torch.device('cuda')
    a, b = (torch.as_tensor(im, device=dev) for im in pair)
    t0 = time.perf_counter()
    S, valid1, votes = sk.aggregate(
        a, b, SGM_PAIR['dmin'], SGM_PAIR['dmax'],
        tsgm.SgmParams(mgm=True, mgm_neighbors=3))
    torch.cuda.synchronize()
    print(f'  aggregate (MGM, 3 laterals): {time.perf_counter() - t0:.3f} s',
          flush=True)
    d = (S.argmin(dim=2) + SGM_PAIR['dmin']).cpu().numpy()
    v = valid1.cpu().numpy()
    if not torch.isfinite(S).all() or len(votes) != 8:
        raise AssertionError('aggregate: non-finite costs or missing votes')
    good = (np.abs(d - SGM_PAIR['shift'])[8:-8, 8:-16][v[8:-8, 8:-16]]
            <= 1).mean()
    print(f'  aggregate: WTA within 1 px of the shift on {good:.4f} of the '
          'valid inner pixels', flush=True)
    if good <= 0.95:
        raise AssertionError('aggregate: the known shift is not recovered')


def check_sgm_crop():
    """Phase 7: the classic matcher on a 128 x 128 crop, card against the
    plain versions on the CPU, byte for byte."""
    from s2p_tpu_torch.ops import sgm as tsgm
    im1, im2 = (im[:128, :128].copy() for im in sgm_pair(SGM_PAIR))
    for params in (tsgm.SgmParams(mgm=False),
                   tsgm.SgmParams(mgm=False, lr_mode='full')):
        gpu = tsgm.match_pair(im1, im2, SGM_PAIR['dmin'], SGM_PAIR['dmax'],
                              params)
        cpu = tsgm.match_pair(im1, im2, SGM_PAIR['dmin'], SGM_PAIR['dmax'],
                              params, device='cpu')
        for name, x, y in zip(('disp', 'valid', 'confidence'), gpu, cpu):
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                raise AssertionError(f'crop ({params.lr_mode}): {name} '
                                     'differs from the CPU run')
        print(f'  crop 128 x 128 ({params.lr_mode}): disp, valid and '
              'confidence equal the CPU run byte for byte', flush=True)


def check_signed_prepass(pairs, stats):
    """Phase 9: the pre-pass at a signed base with the padded secondary,
    as the single-tile route gives it, on the 800 x 800 tile."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = torch.device('cuda')
    a, b = (torch.as_tensor(im, device=dev)[None]
            for im in pairs[SINGLE_800['index']])
    dmin = SINGLE_800['dmin']
    D = SINGLE_800['dmax'] - dmin + 1
    s1, s2 = sk.flow_sigs(a, b, 5)
    W = s1.shape[2]
    s1t = s1.transpose(1, 2).contiguous()
    s2tp, pad, sec_len = sk.prepass_secondary(s2, W, dmin, D)
    args = (s1t, s2tp, D, dmin, 24, pad, sec_len)
    got = sk.cost_prepass(*args)
    ok, err = equal(got, sk.cost_prepass_plain(*args))
    print(f'  cost_prepass at base {dmin}: pad {pad}, secondary rows '
          f'{s2tp.shape[1]}, {int((got == 255).sum())} of {got.numel()} '
          'candidates out of range', flush=True)
    record(stats, 'cost_prepass_signed', '', ok, err,
           timed(lambda: sk.cost_prepass(*args), 5),
           timed(lambda: sk.cost_prepass_plain(*args), 2),
           4 * s1t.numel() + 4 * s2tp.numel() + got.numel(), 0)


def check_fold_kernels(specs, pairs, stats):
    """Phase 9: the four signature-mode scans of bucket A's L side folded
    by KERNEL_FOLD against their plain versions, and against the same
    scans over the tiles unfolded (bitwise per tile, timed)."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = torch.device('cuda')
    v = mf.MgmVariant()
    D = BUCKET_A['D']
    b1, b2 = bucket_arrays(specs, BUCKET_A, pairs)
    n, H, W = b1.shape
    _, seg_w = mf.lane_fold_plan(W, D, n)
    G, B = n // KERNEL_FOLD, KERNEL_FOLD

    def ints(key):
        return torch.tensor([s[key] for s in specs], dtype=torch.int32,
                            device=dev)

    dm = ints('dmin')
    dt = ints('dmax') - dm + 1
    s1 = mf.census_bits_raw(torch.as_tensor(b1, device=dev), v.census_win)
    s2 = mf.census_bits_raw(torch.as_tensor(b2, device=dev), v.census_win)
    sr, ss, _ = mf._side_sigs(s1, s2, dm, ints('h'), ints('w1'),
                              ints('w2'), extra=seg_w - W, ref_pad=seg_w - W)
    allowed = (torch.arange(D, device=dev)[None, :] < dt[:, None]) \
        .to(torch.int32)
    folded = sk.fold_inputs(sr.reshape(G, B, H, seg_w),
                            ss.reshape(G, B, H, seg_w), D, v.p2)
    # the same tiles one by one: horizontal inputs transposed, the
    # secondary padded by D rows as in the folded layout
    one = {'v': (sr, ss, torch.full((n, H, seg_w), v.p2,
                                    dtype=torch.float32, device=dev), seg_w),
           'h': (sr.transpose(1, 2).contiguous(),
                 torch.nn.functional.pad(ss.transpose(1, 2), (0, 0, 0, D)),
                 torch.full((n, seg_w, H), v.p2, dtype=torch.float32,
                            device=dev), seg_w + D)}
    passes = sk.scan_passes(v)
    sub = float(sum(len(i) for _, i, _ in passes) - 1)
    t_fold = t_one = 0.0
    for key, _, lats in passes:
        o = key[0]
        dirs = tuple((lat,) for lat in lats)
        a, b, p2, sec_len, seg = folded[o]
        args = (a, b, p2, dirs, v.p1, mf.BIG, 24, D, 0, sec_len,
                key[1] == 'b', o == 'h')
        kw = dict(sub_cost_mult=sub, allowed=allowed.reshape(G, B, D),
                  seg_w=seg)
        Sk, vk = sk.scan_sig(*args, **kw)
        Sp, vp = sk.scan_sig_plain(*args, **kw)
        ok, err = equal(Sk, Sp)
        ok_v, err_v = equal(vk, vp)
        vol = Sk.numel()
        nbytes = (sum(4 * t.numel() for t in (a, b, p2)) + 4 * vol
                  + 4 * vk.numel() + 4 * allowed.numel())
        ops = vol * (6 + 11 * len(lats))
        ms = timed(lambda: sk.scan_sig(*args, **kw), 3)
        record(stats, f'scan_sig_seg {key}', '', ok and ok_v,
               max(err, err_v), ms,
               timed(lambda: sk.scan_sig_plain(*args, **kw), 1), nbytes,
               ops)
        del Sp, vp
        # unfolded: the 8 tiles on the batch axis, one segment each
        args1 = (*one[o][:3], dirs, v.p1, mf.BIG, 24, D, 0, one[o][3],
                 key[1] == 'b', o == 'h')
        kw1 = dict(sub_cost_mult=sub, allowed=allowed)
        S1, v1 = sk.scan_sig(*args1, **kw1)
        if o == 'v':      # (G, H, D, B * seg_w) -> (n, H, D, seg_w)
            Sf = Sk.reshape(G, H, D, B, seg_w).permute(0, 3, 1, 2, 4)
            vf = vk.reshape(G, -1, H, B, seg_w).permute(0, 3, 1, 2, 4)
        else:             # (G, seg_w, D, B * H) -> (n, seg_w, D, H)
            Sf = Sk.reshape(G, seg_w, D, B, H).permute(0, 3, 1, 2, 4)
            vf = vk.reshape(G, -1, seg_w, B, H).permute(0, 3, 1, 2, 4)
        same = (equal(Sf.reshape(S1.shape), S1)[0]
                and equal(vf.reshape(v1.shape), v1)[0])
        ms1 = timed(lambda: sk.scan_sig(*args1, **kw1), 3)
        print(f'    {key}: folded {ms:.3f} ms, unfolded {ms1:.3f} ms, '
              f'folded / unfolded {ms / ms1:.4f}, equal per tile: {same}',
              flush=True)
        if not same:
            raise AssertionError(f'scan_sig_seg {key}: the folded scan '
                                 'differs from the unfolded one')
        t_fold += ms
        t_one += ms1
        sub = 0.0
        del Sk, vk, S1, v1
    print(f'  four passes: folded {t_fold:.3f} ms, unfolded {t_one:.3f} ms, '
          f'folded / unfolded {t_fold / t_one:.4f}', flush=True)
    torch.cuda.empty_cache()


def check_known_shift(name, disp, spec):
    """A single-tile map: its shape, and the known shift on the finite
    inner pixels."""
    import numpy as np
    shape = (spec['h'], spec['w1'])
    if disp.shape != shape or disp.dtype != np.float32:
        raise AssertionError(f'{name}: {disp.shape} {disp.dtype}, want '
                             f'{shape} float32')
    inner = disp[8:-8, 8:-8]
    fin = np.isfinite(inner)
    good = (np.abs(inner[fin] - spec['shift']) < 1.0).mean()
    print(f'  {name}: {shape}, finite inner {fin.mean():.4f}, within 1 px '
          f"of {spec['shift']}: {good:.4f}", flush=True)
    if fin.mean() < 0.8 or good <= 0.95:
        raise AssertionError(f'{name}: the known shift is not recovered')


def run_single_path(pairs):
    """Phase 10, the path itself: ``mgm_binary_match`` on the card on
    both tiles.  Returns their (disp, conf) tensors."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    out = {}
    for spec in (SINGLE, SINGLE_800):
        im1, im2 = pairs[spec['index']]
        t0 = time.perf_counter()
        out[spec['index']] = mf.mgm_binary_match(im1, im2, spec['dmin'],
                                                 spec['dmax'])
        torch.cuda.synchronize()
        print(f"  mgm_binary_match {spec['h']} x {spec['w1']}: "
              f'{time.perf_counter() - t0:.3f} s', flush=True)
    return out


def check_single_path(pairs, out):
    """Phase 10 checks: each tile against the batch entry on the card,
    its known shift; compute_disparity_map; the wall time at 800 x 800."""
    import numpy as np
    import torch
    from s2p_tpu_torch.config import Config
    from s2p_tpu_torch.core import matching
    from s2p_tpu_torch.ops import mgm_flow as mf

    for spec in (SINGLE, SINGLE_800):
        im1, im2 = pairs[spec['index']]
        disp, conf = out[spec['index']]
        h, w = spec['h'], spec['w1']
        D = spec['dmax'] - spec['dmin'] + 1
        Hp, Wp = -(-h // 8) * 8, -(-w // 8) * 8
        b1 = np.full((1, Hp, Wp), np.nan, np.float32)
        b2 = np.full((1, Hp, Wp), np.nan, np.float32)
        b1[0, :h, :w] = im1
        b2[0, :h, :spec['w2']] = im2
        ref = mf.mgm_binary_match_batch(b1, b2, [spec['dmin']], D, [h],
                                        [w], [spec['w2']], [D])
        for name, x, y in (('disp', disp, ref['disp'][0, :h, :w]),
                           ('confidence', conf, ref['confidence'][0, :h, :w])):
            ok, err = equal(x, y)
            if not ok:
                raise AssertionError(f'single tile {h} x {w}: {name} '
                                     'differs from the batch entry '
                                     f'(max abs error {err})')
        print(f'  single tile {h} x {w}: disp and confidence equal the '
              'batch entry bitwise', flush=True)
        check_known_shift(f'mgm_binary_match {h} x {w}', disp.cpu().numpy(),
                          spec)
    im1, im2 = pairs[SINGLE['index']]
    t0 = time.perf_counter()
    disp, mask, conf = matching.compute_disparity_map(
        Config(), im1, im2, SINGLE['dmin'], SINGLE['dmax'])
    print(f'  compute_disparity_map: {time.perf_counter() - t0:.3f} s',
          flush=True)
    if mask.dtype != np.uint8 or not np.array_equal(mask > 0,
                                                    np.isfinite(disp)):
        raise AssertionError('compute_disparity_map: mask != finite disp')
    if conf.shape != disp.shape or not np.isin(conf * 8,
                                               np.arange(9)).all():
        raise AssertionError('compute_disparity_map: confidence not k/8')
    check_known_shift('compute_disparity_map', disp, SINGLE)
    im1, im2 = pairs[SINGLE_800['index']]
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        mf.mgm_binary_match(im1, im2, SINGLE_800['dmin'], SINGLE_800['dmax'])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"  mgm_binary_match {SINGLE_800['h']} x {SINGLE_800['w1']} wall, "
          f'warm: median {statistics.median(walls[1:]) * 1e3:.3f} ms of '
          f'{[round(t * 1e3, 3) for t in walls[1:]]}', flush=True)


def check_single_crop(pairs):
    """Phase 10: a 128 x 160 crop with edge_subpix, card against the CPU
    byte for byte."""
    from s2p_tpu_torch.ops import mgm_flow as mf
    im1, im2 = (im[:128, :160].copy() for im in pairs[SINGLE['index']])
    v = mf.MgmVariant(edge_subpix=True, subpix_plateau='zero')
    gpu = mf.mgm_binary_match(im1, im2, SINGLE['dmin'], SINGLE['dmax'], v)
    cpu = mf.mgm_binary_match(im1, im2, SINGLE['dmin'], SINGLE['dmax'], v,
                              device='cpu')
    for name, x, y in zip(('disp', 'confidence'), gpu, cpu):
        x, y = x.cpu().numpy(), y.numpy()
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            raise AssertionError(f'single-tile crop: {name} differs from '
                                 'the CPU run')
    print('  crop 128 x 160 (edge_subpix, plateau zero): disp and '
          'confidence equal the CPU run byte for byte', flush=True)


def check_folded_batch(specs, pairs, folded):
    """Phase 11: the folded batch's outputs against the unfolded batch."""
    from s2p_tpu_torch.ops import mgm_flow as mf
    b1, b2 = bucket_arrays(specs, BUCKET_A, pairs)
    plain = mf.mgm_binary_match_batch(*fold_args(specs, b1, b2))
    for key in ('disp', 'confidence', 'confidence_u8'):
        for k in range(len(specs)):
            ok, err = equal(folded[key][k], plain[key][k])
            if not ok:
                raise AssertionError(f'folded batch: tile {k} {key} differs '
                                     f'from the unfolded batch ({err})')
    print(f'  folded batch: {len(specs)} tiles equal the unfolded batch '
          'bitwise (disp, confidence, confidence_u8)', flush=True)


def fold_args(specs, b1, b2):
    """mgm_binary_match_batch's arguments for bucket A."""
    from s2p_tpu_torch.ops import mgm_flow as mf
    return (b1, b2, [s['dmin'] for s in specs], BUCKET_A['D'],
            [s['h'] for s in specs], [s['w1'] for s in specs],
            [s['w2'] for s in specs],
            [s['dmax'] - s['dmin'] + 1 for s in specs], mf.MgmVariant())


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.config import Config
    from s2p_tpu_torch.ops import _build
    from s2p_tpu_torch.ops import sgm_kernels as sk

    with phase('device'):
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card)
        print(f'torch {torch.__version__} cuda {torch.version.cuda} '
              f'device {torch.cuda.get_device_name(0)} '
              f'count {torch.cuda.device_count()}', flush=True)

    with phase('build'):
        libs, secs = _build.build()
        print(f'  nvcc: {secs:.3f} s for {sorted(libs)}')
        for name in _build.SOURCES:
            for line in _build.build_log(name).splitlines():
                if ('registers' in line or 'spill' in line
                        or 'Function properties' in line):
                    print(f'  {name}: {line.strip()}')

    specs_a = tile_specs(BUCKET_A, 0)
    specs_b = tile_specs(BUCKET_B, len(specs_a))
    specs = specs_a + specs_b
    pairs = {s['index']: make_pair(s)
             for s in specs + [WIDE, SINGLE, SINGLE_800]}

    stats = {}
    with phase('flow kernels against their plain versions (bucket A)'):
        check_kernels(specs_a, pairs, stats)
    with phase('flow kernels against their plain versions (D 528)'):
        check_kernels([WIDE], pairs, stats, BUCKET_WIDE, tag='_d528')
    with phase('classic matcher kernels against their plain versions'):
        check_sgm_kernels(stats)
    with phase('single-tile and lane-fold kernel modes against their '
               'plain versions'):
        check_signed_prepass(pairs, stats)
        check_fold_kernels(specs_a, pairs, stats)

    launches = {}
    tmp = tempfile.mkdtemp(prefix='s2p_chip_smoke_')
    try:
        gpu_root = os.path.join(tmp, 'gpu')
        cpu_root = os.path.join(tmp, 'cpu')
        cfg = Config(out_dir=gpu_root)
        tiles = [(write_tile(gpu_root, s, *pairs[s['index']]), 1)
                 for s in specs]
        cpu_specs = specs_a[:2] + specs_b[:2]
        cpu_tiles = [(write_tile(cpu_root, s, *pairs[s['index']]), 1)
                     for s in cpu_specs]
        with phase('stage 4 on the card (buckets A and B)'):
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            pipeline.stereo_matching_all(cfg, tiles)
            torch.cuda.synchronize()
            print(f'  stereo_matching_all: {len(tiles)} tiles in '
                  f'{time.perf_counter() - t0:.3f} s', flush=True)
            launches['flow'] = sk.launch_counts()
            print(f"  launches: {launches['flow']}", flush=True)
        with phase('stage 4 on the CPU (2 tiles of each bucket)'):
            pipeline.stereo_matching_all(cfg, cpu_tiles, device='cpu')
        with phase('stage 4 checks'):
            check_outputs(gpu_root, specs, cpu_root,
                          {s['index'] for s in cpu_specs})

        with phase('classic matcher on the card'):
            sk.reset_launch_counts()
            run_sgm_path()
            torch.cuda.synchronize()
            launches['sgm'] = sk.launch_counts()
            print(f"  launches: {launches['sgm']}", flush=True)
        with phase('classic matcher: card against the CPU (128 x 128)'):
            check_sgm_crop()

        with phase('stage 4 at 528 candidates, card and CPU'):
            wide_tile = (write_tile(gpu_root, WIDE, *pairs[WIDE['index']]),
                         1)
            wide_cpu = (write_tile(cpu_root, WIDE, *pairs[WIDE['index']]), 1)
            sk.reset_launch_counts()
            pipeline.stereo_matching_all(cfg, [wide_tile])
            torch.cuda.synchronize()
            launches['wide'] = sk.launch_counts()
            print(f"  launches: {launches['wide']}", flush=True)
            pipeline.stereo_matching_all(cfg, [wide_cpu], device='cpu')
            check_outputs(gpu_root, [WIDE], cpu_root, {WIDE['index']})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    with phase('the single-tile entry on the card'):
        sk.reset_launch_counts()
        single = run_single_path(pairs)
        launches['single'] = sk.launch_counts()
        print(f"  launches: {launches['single']}", flush=True)
        check_single_path(pairs, single)
        del single
        sk.reset_launch_counts()
        check_single_crop(pairs)
        launches['single_edge'] = sk.launch_counts()
        print(f"  launches (crop): {launches['single_edge']}", flush=True)
    with phase('the lane-folded batch on the card'):
        from s2p_tpu_torch.ops import mgm_flow as mf
        b1, b2 = bucket_arrays(specs_a, BUCKET_A, pairs)
        os.environ['S2P_TPU_LANE_FOLD'] = str(BATCH_FOLD)
        try:
            sk.reset_launch_counts()
            folded = mf.mgm_binary_match_batch(*fold_args(specs_a, b1, b2))
            torch.cuda.synchronize()
            launches['fold'] = sk.launch_counts()
        finally:
            del os.environ['S2P_TPU_LANE_FOLD']
        print(f"  launches: {launches['fold']}", flush=True)
        check_folded_batch(specs_a, pairs, folded)
        del folded
    for run, keys in (('single', ('cost_prepass', 'scan', 'wta')),
                      ('fold', ('scan_sig_seg', 'cost_prepass', 'scan',
                                'wta'))):
        idle = [k for k in keys if launches[run][k] == 0]
        if idle:
            raise AssertionError(f'the {run} path launched no {idle}')

    pallas = 's2p_tpu/ops/sgm_pallas.py'
    csrc = 's2p_tpu_torch/csrc'
    # kernel -> (source, TPU kernel, the path run that counts it, its key)
    table = {
        'cost_prepass': (f'{csrc}/cost_prepass.cu', f'{pallas}:474', 'flow',
                         'cost_prepass'),
        'scan': (f'{csrc}/scan.cu', f'{pallas}:81', 'flow', 'scan'),
        'wta': (f'{csrc}/wta.cu', f'{pallas}:358', 'flow', 'wta'),
        'scan_d528': (f'{csrc}/scan.cu', f'{pallas}:81', 'wide', 'scan'),
        'scan_sig': (f'{csrc}/scan.cu', f'{pallas}:81', 'sgm', 'scan_sig'),
        'scan_mgm': (f'{csrc}/scan_mgm.cu', f'{pallas}:81', 'sgm',
                     'scan_mgm'),
        'wta_dr': (f'{csrc}/wta.cu', f'{pallas}:358', 'sgm', 'wta_dr'),
        'cost_prepass_signed': (f'{csrc}/cost_prepass.cu', f'{pallas}:474',
                                'single', 'cost_prepass'),
        'wta_edge': (f'{csrc}/wta.cu', f'{pallas}:358', 'single_edge',
                     'wta_edge'),
        'scan_sig_seg': (f'{csrc}/scan.cu', f'{pallas}:81', 'fold',
                         'scan_sig_seg'),
    }
    missing = [name for name, (_, _, run, key) in table.items()
               if launches[run][key] == 0]
    if missing:
        raise AssertionError(f'kernels never launched on their path: '
                             f'{missing}')
    kernels = []
    for name, (src, replaces, run, key) in table.items():
        st = stats[name]
        t_bound, by = bound(st['nbytes'], st['ops'])
        kernels.append({'name': name, 'route': 'cuda', 'source': src,
                        'replaces': replaces, 'launches': launches[run][key],
                        'max_abs_err': st['err'], 'ms': st['ms'],
                        'plain_ms': st['plain_ms'], 'bound_ms': t_bound,
                        'bound_by': by, 'library_ms': None})
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
