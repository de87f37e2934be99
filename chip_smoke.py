#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``s2p_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda) and the
packages torch, numpy and scipy; it imports nothing of JAX and nothing of
the JAX package.  Phases, each timed on a line of its own:

  1. device: the card's name and power limit (nvidia-smi), torch's version;
  2. build: the CUDA kernels, one nvcc per source in parallel, into
     s2p_tpu_torch/_build/; ptxas's register, shared-memory and stack
     lines, and a check that every instantiation of the scan kernel up to
     4096 candidates (K2 and K4a), of the pre-pass (K1), of the
     averaged-MGM scan (K4b, both instantiations) and of the WTA with the
     right-reference map (K5, its three instantiations) has a 0-byte
     stack frame and no spill;
  3. kernels of the mgm flow (stage 4) against their plain PyTorch
     versions on the card, on the inputs the main path gives them at
     bucket A's shapes (the cost pre-pass, the four scan passes of each
     side, the WTA), and once more at bucket B's and at 528 candidates
     (one 64 x 896 tile), compared bitwise and NaN-aware, each timed with
     CUDA events; then the scan per bucket as the flow launches it, both
     sides' four chains of passes at once on side streams, bitwise
     against the passes one by one and timed beside the same passes on
     one stream; then every kernel against its plain version at
     adversarial shapes and values, one line per case: the scan (K2 and
     K4a: tied candidates, columns of 255, D 1 to 4097, ragged lane
     counts, N 1 and 2, laterals -1/0/+1 with sub and accum; signatures
     with padding, allowed candidates and lane-fold segments), K1 (61 and
     100 lanes, D 1, 17 and 4097, N 1 and 2, signed bases, all-pad and
     all-invalid rows, `allowed` zeros, windows that reach the
     secondary's last row, bucket A's and the single tile's shapes), K4b
     on both instantiations (lanes the 16-block cluster does not divide,
     1 to 3 directions of 2 and 3 laterals, D 1, N 1, sub and accum,
     832 and 512 lanes) and a shape that only the global instantiation
     takes, K3 and K5 on NaN, inf and all-BIG partials, K5 also on each
     of its instantiations (bands of 4 and 2 rows, the windowed one past
     1024 columns) with D 1 to 528 and disp_min from -(W + D) to W - 5;
  4. kernels of the classic SGM matcher against their plain versions, on
     the 512 x 512 pair with 64 candidates from -8 (bench.py): the four
     signature-mode scan passes (K4a), one vertical pass with 3 MGM
     laterals and one horizontal pass with 2 (K4b) and K4b's step floor
     (one cluster barrier per step, no work), the WTA with the
     right-reference map (K5); and K4b's two passes at the classic
     tile's shape (832 x 832, 96 candidates);
  5. stage 4: synthetic rectified tiles in two buckets (A: 8 tiles padded
     to 448 x 512 with 80 candidates; B: 2 tiles at the default tile size,
     padded to 832 x 896 with 96 candidates) through
     ``pipeline.stereo_matching_all`` on the card; the files it writes are
     checked for shape and for the known shift of each tile, and two
     tiles of each bucket are held bitwise against the same entry run
     with device="cpu" (the plain versions);
  5b. stage 5 on bucket A's 8 tiles after stage 4 wrote them
     (``pipeline.disparity_to_ply_all`` with the 3D filter on, two
     synthetic RPC cameras 0.35 px/m apart in altitude): its wall time
     per bucket, a plausible cloud per tile, the triangulation's CUDA
     kernels (``torch.profiler``) and time and the neighbour count's time;
     crops of two tiles (96 x 128) card against device="cpu" (cloud.ply
     byte for byte, or within 1e-3 m in x, y and 2e-3 m in altitude); a
     constant disparity against the float64 cameras' altitudes (0.01 m);
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
     sheet); the scan's entries also carry ``bucket_ms``, both sides of
     the bucket as the flow launches them, and K4b's ``step_floor_ms``;
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
SPIN_CYCLES = 2_000_000         # a device-side spin ahead of a timed run
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
# stage 5 on bucket A: two synthetic cameras 0.35 px/m apart in altitude
# (a base-to-height ratio near 0.3 at 1 m a pixel), the secondary's
# homography shifted so that 3 px of disparity is about 300 m; the CPU
# comparison runs on crops of two tiles (the triangulation launches about
# 1e5 elementwise ops, too slow on the CPU at full size); tolerances of
# the card against the CPU (the same torch ops, expected bitwise) and of
# the known answer against the float64 model
S5_SHIFT = -67.0
S5_CROP = (96, 128)
S5_XY_TOL_M, S5_ALT_TOL_M = 1e-3, 2e-3
S5_KNOWN_DISP, S5_KNOWN_TOL_M = 3.0, 0.01
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
    """Median ms of ``reps`` runs between CUDA events, after one warm run.
    A device-side spin of about a millisecond goes ahead of each first
    event, so the host enqueues the run while the card is busy and the
    events time the card's work, not the wrappers' host time (which is
    longer than a kernel of 0.1 ms)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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


def check_no_spill(log, kernel):
    """Every instantiation of ``kernel`` in a ptxas -v log has a 0-byte
    stack frame and no spill."""
    fn, seen = None, 0
    for line in log.splitlines():
        if 'Function properties for' in line:
            fn = line.split('Function properties for')[1].strip()
        elif fn and 'stack frame' in line:
            if kernel in fn:
                seen += 1
                nums = [int(w) for w in line.replace(',', ' ').split()
                        if w.isdigit()]
                if any(nums):
                    raise AssertionError(f'{fn}: {line.strip()}')
            fn = None
    print(f'  {kernel}: {seen} instantiations, each with a 0-byte stack '
          'frame and no spill', flush=True)
    if not seen:
        raise AssertionError(f'no {kernel} in the ptxas log')


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

    vols, seq = {}, {}
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
        vols[side] = {o: (cost_h if o == 'h' else
                          cost_h.permute(0, 3, 2, 1).contiguous(), None)
                      for o in ('h', 'v')}
        seq[side] = [None] * sum(len(i) for _, i, _ in passes)
        floor = 0
        for key, dir_idx, lats in passes:
            o = key[0]
            cost = vols[side][o][0]
            B, N, _, lanes = cost.shape
            p2 = torch.full((B, N, lanes), v.p2, dtype=torch.float32,
                            device=dev)
            vols[side][o] = (cost, p2)
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
            # one launch per direction: each later direction reads back
            # and rewrites S
            floor += nbytes + 8 * vol * (len(lats) - 1)
            rec(f'scan {key}', side, ok, err,
                   timed(lambda: sk.scan(cost, p2, lats, v.p1, mf.BIG, **kw),
                         5),
                   timed(lambda: sk.scan_plain(cost, p2, lats, v.p1, mf.BIG,
                                               **kw), 1),
                   nbytes, ops)
            S[o] = Sk
            sub = 0.0
            if votes:
                for j, i in enumerate(dir_idx):
                    seq[side][i] = vk[:, j] if o == 'v' else \
                        vk[:, j].transpose(1, 2)
            del Sp, vp
        print(f'  scan {side}: byte floor of one launch per direction '
              f'{bound(floor, 0)[0]:.4f} ms, fused bound '
              f"{bound(stats['scan' + tag]['nbytes'], 0)[0]:.4f} ms",
              flush=True)

        parts = [S['v'], S['h'].permute(0, 3, 2, 1)]
        seq[side] = (parts, seq[side])
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
    check_bucket_scans(vols, seq, stats['scan' + tag])


def check_bucket_scans(vols, seq, st):
    """K2 per bucket as the flow launches it: both sides' four chains of
    passes at once (sgm_kernels.flow_scans), bitwise against the passes
    run one by one, and timed twice beside the same passes one after
    another on one stream; the JSON line reports the better of the two."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    v = mf.MgmVariant()
    ins = [(vols['L'], True), (vols['R'], False)]
    got = sk.flow_scans(ins, v)
    for (parts, votes), side in zip(got, ('L', 'R')):
        ref_parts, ref_votes = seq[side]
        same = all(equal(a, b)[0] for a, b in zip(parts, ref_parts))
        same = same and all(a is None and b is None or equal(a, b)[0]
                            for a, b in zip(votes, ref_votes))
        print(f'  scan bucket {side}: the concurrent chains equal the '
              f'passes one by one: {same}', flush=True)
        if not same:
            raise AssertionError(f'flow_scans ({side}) differs from the '
                                 'passes run one by one')
    del got

    def serial():
        for vol, votes in ins:
            S = {}
            for o, chain in sk.flow_chains(v).items():
                for key, _, lats, sub in chain:
                    S[o], _ = sk.scan(*vol[o], lats, v.p1, mf.BIG,
                                      reverse=key[1] == 'b',
                                      sub_cost_mult=sub, accum=S.get(o),
                                      emit_votes=votes)

    ts = [timed(lambda: sk.flow_scans(ins, v), 5) for _ in range(2)]
    one_stream = timed(serial, 3)
    print(f'  scan bucket (both sides, four chains at once): {ts[0]:.3f}, '
          f'{ts[1]:.3f} ms', flush=True)
    print(f'  scan bucket, the same passes on one stream: {one_stream:.3f} ms',
          flush=True)
    st['bucket_ms'] = min(ts)
    torch.cuda.empty_cache()


def check_adversarial():
    """Every kernel against its plain version at shapes and values that
    stress its design, each case on a line of its own.  The scan (K2 and
    K4a): tied candidates, columns of 255, D from 1 to 4097 (one group, a
    ragged group, past 256, the wide tile's and past 4096,
    scan_wide_kernel), lanes that no chain count divides, N 1 and 2,
    laterals -1/0/+1 in one pass with sub and accum; signatures with
    reference padding, invalid pixels, allowed candidates and lane-fold
    segments, vertical and horizontal.  K1, K4b (both instantiations) and
    K5 at their own edges (check_adversarial_prepass, _mgm, _wta_dr).  K3
    on NaN, inf and all-BIG partials, D 1 and 2, either part
    transposed."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(7)
    failed = []

    def verdict(name, pairs):
        ok = all(equal(a, b)[0] for a, b in pairs)
        print(f'  {name}: bitwise={ok}', flush=True)
        if not ok:
            failed.append(name)

    cases = []
    for D in (1, 17, 257, 528):
        for N, lanes in ((1, 61), (2, 61), (7, 64)):
            cases.append((D, N, lanes, 'random'))
    cases += [(80, 9, 61, 'tied'), (80, 9, 61, '255 columns'),
              (528, 5, 33, 'tied'), (17, 12, 61, '255 columns'),
              (4097, 3, 61, 'random'), (4104, 2, 7, 'tied')]
    for D, N, lanes, kind in cases:
        B = 2
        cost = torch.randint(0, 25, (B, N, D, lanes), dtype=torch.uint8,
                             device=dev, generator=g)
        cost[torch.rand(cost.shape, device=dev, generator=g) < 0.1] = 255
        if kind == 'tied':
            cost.fill_(7)
        elif kind == '255 columns':
            cost[..., ::5] = 255
        p2 = torch.rand((B, N, lanes), device=dev, generator=g) * 40
        accum = torch.rand(cost.shape, device=dev, generator=g) * 100
        for lats, rev, sub, acc in (((-1, 0, 1), False, 2.0, accum),
                                    ((1,), True, 0.0, None),
                                    ((0, -1), True, 1.0, accum)):
            ref = sk.scan_plain(cost, p2, lats, 8.0, mf.BIG, rev, sub, acc)
            got = sk.scan(cost, p2, lats, 8.0, mf.BIG, rev, sub, acc)
            verdict(f'scan D {D} N {N} lanes {lanes} {kind} lats {lats} '
                    f'reverse {rev} sub {sub} accum {acc is not None}',
                    zip(got, ref))
    # a strided view of the cost, as any caller may give
    cost = torch.randint(0, 25, (2, 7, 40, 30), dtype=torch.uint8,
                         device=dev, generator=g)[:, :, ::2]
    p2 = torch.full((2, 7, 30), 32.0, device=dev)
    verdict('scan strided cost', zip(
        sk.scan(cost, p2, (0, 1, -1), 8.0, mf.BIG, False),
        sk.scan_plain(cost, p2, (0, 1, -1), 8.0, mf.BIG, False)))
    check_adversarial_sig(g, verdict)
    check_adversarial_prepass(g, verdict)
    check_adversarial_mgm(g, verdict)
    check_adversarial_wta_dr(g, verdict)

    for D in (1, 2, 17, 80):
        B, H, W = 2, 37, 45
        sv = torch.randint(0, 30, (B, H, D, W), device=dev,
                           generator=g).float()
        sh = torch.randint(0, 30, (B, W, D, H), device=dev,
                           generator=g).float()
        for kind in ('random', 'nan', 'inf', 'all BIG'):
            a, c = sv.clone(), sh.clone()
            if kind == 'nan':
                a[torch.rand(a.shape, device=dev, generator=g) < 0.03] = \
                    float('nan')
            elif kind == 'inf':
                a[torch.rand(a.shape, device=dev, generator=g) < 0.1] = \
                    float('inf')
                c[torch.rand(c.shape, device=dev, generator=g) < 0.05] = \
                    float('-inf')
            elif kind == 'all BIG':
                a[:, :3] = mf.BIG
                c[:] = mf.BIG
            ct = c.permute(0, 3, 2, 1)
            for parts in ([a, ct], [ct, a], [ct, ct], [a], [ct]):
                for subpix, mode in (('vfit', {}), ('parabola', {}),
                                     ('vfit', dict(edge_subpix=True,
                                                   plateau_zero=True))):
                    got = sk.wta(parts, subpix, mf.BIG / 2, **mode)
                    ref = sk.wta_plain(parts, subpix, mf.BIG / 2, **mode)
                    order = ' + '.join('S_v' if t is a else 'S_h'
                                       for t in parts)
                    verdict(f'wta D {D} {kind} {order} {subpix} '
                            f'{sorted(mode)}', zip(got, ref))
    if failed:
        raise AssertionError(f'{len(failed)} adversarial cases differ from '
                             f'the plain versions: {failed[:5]}')
    torch.cuda.empty_cache()


def adversarial_sigs(g, shape, p_pad=0.0):
    """Random census signatures: 90% valid, ``p_pad`` reference padding."""
    import torch
    dev = g.device
    v = torch.randint(0, 1 << 24, shape, device=dev, generator=g)
    v |= (torch.rand(shape, device=dev, generator=g) >= 0.1).long() << 24
    v |= (torch.rand(shape, device=dev, generator=g) < p_pad).long() << 25
    return v.to(torch.int32)


def check_adversarial_prepass(g, verdict):
    """K1 against its plain version: lane counts that no 4-byte word
    divides (the scalar instantiation) and that a 16-lane vector does not,
    D 1, 17 and 4097, N 1 and 2, signed bases with a padded secondary,
    reference padding, all-pad and all-invalid rows, `allowed` with
    zeros, and windows that reach the secondary's last row."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = g.device
    # (B, N, lanes, D, base: 'wide' (0, N + D secondary rows: the last
    # window ends at the last row) or a signed disp_min, kind)
    cases = [(2, 48, 61, 17, 'wide', ''), (2, 1, 64, 1, 'wide', ''),
             (1, 2, 61, 4097, -2000, 'allowed'),
             (2, 2, 40, 17, -5, 'pad'),
             (2, 33, 808, 96, -40, 'allowed zeros pad'),
             (2, 24, 100, 17, 3, ''), (1, 16, 36, 4097, 'wide', ''),
             (2, 40, 61, 80, 'wide', 'all-pad rows'),
             (2, 40, 64, 80, 'wide', 'all-invalid rows'),
             (1, 1, 61, 1, -3, 'allowed'), (8, 512, 448, 80, 'wide', 'pad'),
             (1, 800, 800, 96, -40, 'allowed pad')]
    for B, N, L, D, base, kind in cases:
        s1 = adversarial_sigs(g, (B, N, L), 0.2 if 'pad' in kind else 0.0)
        if kind == 'all-pad rows':
            s1[:, :7] |= 1 << 25
        elif kind == 'all-invalid rows':
            s1[:, :7] &= ~(1 << 24)
        if base == 'wide':
            dmin, pad, sec = 0, 0, N + D
            s2 = adversarial_sigs(g, (B, N + D, L))
        else:
            dmin = base
            s2, pad, sec = sk.prepass_secondary(
                adversarial_sigs(g, (B, L, N)), N, dmin, D)
        allowed = None
        if 'allowed' in kind:
            allowed = (torch.rand((B, D), device=dev, generator=g)
                       < 0.7).to(torch.int32)
            if 'zeros' in kind:
                allowed[0] = 0
        args = (s1, s2, D, dmin, 24, pad, sec, allowed)
        verdict(f'cost_prepass B {B} N {N} lanes {L} D {D} base {base} '
                f'{kind}', [(sk.cost_prepass(*args),
                             sk.cost_prepass_plain(*args))])


def check_adversarial_mgm(g, verdict):
    """K4b against its plain version on both instantiations (the
    shared one, forced global): lanes that the cluster's 16 blocks do not
    divide, 1 to 3 directions of 2 and 3 laterals, D 1, N 1, sub and accum
    together, `allowed`, vertical and horizontal, bucket B's widths (832
    lanes, 96 candidates) and the classic pair's (512, 64); then a shape
    whose carry fits only the global instantiation, chosen by shape."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = g.device
    v3 = ((0, 1, -1), (1, 0, -1), (-1, 0, 1))
    # (B, N, lanes, D, dirs, horizontal, disp_min, sub, accum, allowed)
    cases = [(2, 9, 61, 17, ((0, 1), (1, 0), (-1, 0)), False, -5, 2.0, True,
              True),
             (1, 5, 30, 1, ((0, -1, 1),), False, 0, 0.0, False, False),
             (2, 7, 61, 17, ((0, 1),), True, 3, 1.0, True, False),
             (1, 8, 100, 64, ((0, -1), (-1, 0)), False, -8, 0.0, False,
              False),
             (1, 5, 20, 17, ((0, 1, -1), (1, 0, -1)), False, 2, 3.0, True,
              True),
             (1, 1, 61, 17, v3, False, -4, 2.0, True, False),
             (1, 6, 832, 96, v3, False, -30, 0.0, False, False),
             (1, 6, 832, 96, ((0, 1),), True, -30, 0.0, False, False),
             (1, 4, 512, 64, v3, False, -8, 0.0, False, False),
             (1, 4, 512, 64, ((0, 1, -1),), True, -8, 0.0, False, False)]
    for B, N, lanes, D, dirs, hor, dmin, sub, acc, al in cases:
        s1 = adversarial_sigs(g, (B, N, lanes), 0.05)
        pad = 0
        if hor:
            pad = max(0, -dmin, dmin + D)
            pad += (-(dmin + pad)) % 8
            s2, sec = adversarial_sigs(g, (B, N + 2 * pad, lanes)), N
        else:
            s2, sec = adversarial_sigs(g, (B, N, lanes + 5)), lanes + 5
        p2 = torch.rand((B, N, lanes), device=dev, generator=g) * 40
        kw = dict(pad=pad, sub_cost_mult=sub,
                  allowed=(torch.rand((B, D), device=dev, generator=g)
                           < 0.8).to(torch.int32) if al else None,
                  accum=torch.rand((B, N, D, lanes), device=dev,
                                   generator=g) * 100 if acc else None)
        args = (s1, s2, p2, dirs, 8.0, 24.0, 24, D, dmin, sec, False, hor)
        ref = sk.scan_sig_plain(*args, **kw)
        for variant in ('shared', 'global'):
            verdict(f'scan_mgm {variant} B {B} N {N} lanes {lanes} D {D} '
                    f'dirs {dirs} horizontal {hor} disp_min {dmin} sub {sub} '
                    f'accum {acc} allowed {al}',
                    zip(sk.scan_sig(*args, mgm_variant=variant, **kw), ref))
    # n_dirs x D x lanes too large for a block's shared memory
    s1 = adversarial_sigs(g, (1, 3, 832))
    s2 = adversarial_sigs(g, (1, 3, 832))
    p2 = torch.full((1, 3, 832), 32.0, device=dev)
    args = (s1, s2, p2, v3, 8.0, 24.0, 24, 600, -30, 832, True, False)
    variant = sk.scan_mgm_variant(600, 832, False)
    verdict(f'scan_mgm by shape ({variant}) N 3 lanes 832 D 600 dirs {v3}',
            zip(sk.scan_sig(*args), sk.scan_sig_plain(*args)))
    if variant != 'global':
        raise AssertionError('a 3 x 600 x 832 carry chose the shared '
                             'instantiation')


def check_adversarial_wta_dr(g, verdict):
    """K5 against its plain version on NaN, inf and all-BIG partials
    (the reference's NaN rule): D 1, 2, 17 and 64, one part or two, the
    horizontal part read strided in its (W, D, H) layout.  Then each
    instantiation at its edges: a band of 4 rows (W 45 and 130, H not a
    multiple of 4), of 2 rows (W 600) and the windowed one (W 1100), D 1
    to 528, disp_min from -(W + D) to W - 5 (every column of S_R off the
    image at either end), one line per shape, values and parts with every
    refinement and disp_min."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = g.device

    def volumes(B, H, D, W, kind):
        a = torch.randint(0, 30, (B, H, D, W), device=dev,
                          generator=g).float()
        c = torch.randint(0, 30, (B, W, D, H), device=dev,
                          generator=g).float()
        if kind == 'nan':
            a[torch.rand(a.shape, device=dev, generator=g) < 0.03] = \
                float('nan')
            c[:, 4] = float('nan')
        elif kind == 'inf':
            a[torch.rand(a.shape, device=dev, generator=g) < 0.1] = \
                float('inf')
            c[torch.rand(c.shape, device=dev, generator=g) < 0.05] = \
                float('-inf')
        elif kind == 'all BIG':
            a[:, :3] = mf.BIG
            c[:] = mf.BIG
        return a, c.permute(0, 3, 2, 1)

    def order(parts, a):
        return ' + '.join('S_v' if t is a else 'S_h' for t in parts)

    for D in (1, 2, 17, 64):
        for kind in ('nan', 'inf', 'all BIG'):
            a, ct = volumes(2, 19, D, 45, kind)
            for parts in ([a, ct], [ct, a], [a], [ct]):
                for subpix in ('vfit', 'parabola', 'none'):
                    for dmin in (-3, 5):
                        verdict(f'wta_dr D {D} {kind} {order(parts, a)} '
                                f'{subpix} disp_min {dmin}',
                                zip(sk.wta_dr(parts, dmin, subpix),
                                    sk.wta_dr_plain(parts, dmin, subpix)))
    for B, H, W, D in ((2, 18, 130, 17), (1, 9, 600, 64), (1, 5, 600, 1),
                       (1, 6, 1100, 528), (2, 7, 1100, 2)):
        for kind in ('random', 'nan', 'inf', 'all BIG'):
            a, ct = volumes(B, H, D, W, kind)
            for parts in ([a, ct], [ct, a], [a], [ct]):
                pairs = []
                for subpix in ('vfit', 'parabola', 'none'):
                    for dmin in (-(W + D), -(W // 2), 3, W - 5):
                        pairs += zip(sk.wta_dr(parts, dmin, subpix),
                                     sk.wta_dr_plain(parts, dmin, subpix))
                verdict(f'wta_dr {B} x {H} x {W} D {D} {kind} '
                        f'{order(parts, a)}, 3 refinements x 4 disp_min',
                        pairs)
            del a, ct
    torch.cuda.empty_cache()


def check_adversarial_sig(g, verdict):
    """The scan in signature mode (K4a) against its plain version:
    reference padding, invalid pixels, allowed candidates, lane-fold
    segments, vertical and horizontal passes, D 1 to 4097."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = g.device
    # (D, N, lanes, horizontal, disp_min, segment width, kind)
    cases = [(1, 2, 61, False, 0, None, 'pad'),
             (17, 1, 61, False, -5, None, 'allowed'),
             (17, 7, 61, True, 3, None, 'allowed'),
             (80, 9, 64, False, 0, 16, 'allowed'),
             (80, 9, 60, True, 0, 12, 'pad'),
             (257, 3, 61, False, -100, None, ''),
             (528, 2, 33, True, -20, None, 'allowed'),
             (4097, 2, 7, False, -2000, None, 'allowed')]
    for D, N, lanes, hor, dmin, seg_w, kind in cases:
        B = 2
        s1 = adversarial_sigs(g, (B, N, lanes), 0.1 if kind == 'pad' else 0.0)
        pad = 0
        if hor:
            pad = max(0, -dmin, dmin + D)
            pad += (-(dmin + pad)) % 8
            s2, sec_len = adversarial_sigs(g, (B, N + 2 * pad, lanes)), N
        else:
            s2, sec_len = adversarial_sigs(g, (B, N, lanes + 5)), lanes + 5
        p2 = torch.rand((B, N, lanes), device=dev, generator=g) * 40
        allowed = None
        if kind == 'allowed':
            shape = (B, D) if seg_w is None else (B, lanes // seg_w, D)
            allowed = (torch.rand(shape, device=dev, generator=g)
                       < 0.7).to(torch.int32)
        accum = torch.rand((B, N, D, lanes), device=dev, generator=g) * 100
        for dirs, rev, sub, acc in ((((0,), (1,), (-1,)), False, 2.0, accum),
                                    (((1,),), True, 0.0, None),
                                    (((0,),), True, 1.0, accum)):
            if hor and any(lat for (lat,) in dirs):
                continue
            args = (s1, s2, p2, dirs, 8.0, 24.0, 24, D, dmin, sec_len, rev,
                    hor)
            kw = dict(pad=pad, sub_cost_mult=sub, allowed=allowed,
                      accum=acc, seg_w=seg_w)
            verdict(f'scan_sig D {D} N {N} lanes {lanes} horizontal {hor} '
                    f'disp_min {dmin} seg_w {seg_w} {kind} dirs {dirs} '
                    f'reverse {rev} sub {sub} accum {acc is not None}',
                    zip(sk.scan_sig(*args, **kw),
                        sk.scan_sig_plain(*args, **kw)))


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


def stage5_camera(seed, h_term):
    """A synthetic RPC camera near (55.4 E, 21.0 S), about 1 m a pixel,
    columns moving ``10 * h_term`` px per metre of altitude, small cross
    terms in every polynomial; every camera shares its rows' polynomials,
    so two of them see a ground point on the same row."""
    import numpy as np
    from s2p_tpu_torch.geo.rpc import RPCModel
    rng = np.random.RandomState(seed)
    rows = np.random.RandomState(1000)
    col_num = rng.uniform(-1e-3, 1e-3, 20)
    col_num[:4] = (0.01, 1.0, 0.02, h_term)
    col_den = rng.uniform(-1e-4, 1e-4, 20)
    col_den[0] = 1.0
    row_num = rows.uniform(-1e-3, 1e-3, 20)
    row_num[:4] = (-0.02, 0.015, -1.0, 0.001)
    row_den = rows.uniform(-1e-4, 1e-4, 20)
    row_den[0] = 1.0
    return RPCModel(col_num=col_num, col_den=col_den, row_num=row_num,
                    row_den=row_den, lon_offset=55.4, lon_scale=0.05,
                    lat_offset=-21.0, lat_scale=0.05, alt_offset=500.0,
                    alt_scale=500.0, col_offset=5000.0, col_scale=5000.0,
                    row_offset=5000.0, row_scale=5000.0)


def stage5_config(root):
    from s2p_tpu_torch.config import Config, ImageSpec
    return Config(out_dir=root, out_crs='epsg:32740', gsd=1.0,
                  filtering_3d_r=2.5, filtering_3d_n=8, images=(
                      ImageSpec(img='ref.tif', rpcm=stage5_camera(1, 0.02)),
                      ImageSpec(img='sec.tif',
                                rpcm=stage5_camera(2, -0.015))))


def write_stage5_inputs(root, specs):
    """Stage 5's inputs beside each tile's stage-4 files: the two
    homographies (translations to the tile's place in the image, the
    secondary's by S5_SHIFT more), the tile's original mask (with a hole)
    and the scene's pointing correction (identity).  Returns the tile
    dicts."""
    import numpy as np
    from s2p_tpu_torch.geo import geotiff
    np.savetxt(os.path.join(root, 'global_pointing_pair_1.txt'), np.eye(3))
    tiles = []
    for k, s in enumerate(specs):
        tdir = os.path.join(root, f"tile_{s['index']}")
        x0, y0 = 3000.0 + 700 * k, 4000.0 + 300 * k
        for name, dx in (('H_ref.txt', 0.0), ('H_sec.txt', S5_SHIFT)):
            np.savetxt(os.path.join(tdir, 'pair_1', name),
                       [[1, 0, -x0 + dx], [0, 1, -y0], [0, 0, 1]])
        h, w = s['h'] - 2, s['w1'] - 3
        mask = np.full((h, w), 255, np.uint8)
        mask[40:60, 100:140] = 0
        geotiff.write_png(os.path.join(tdir, 'mask.png'), mask)
        tiles.append({'dir': tdir, 'coordinates': (x0, y0, w, h)})
    return tiles


def crop_tile(tile, root, size):
    """A copy of one tile's stage-5 inputs under ``root``, its rectified
    maps cropped at the origin to ``size`` (the homographies still hold)."""
    import numpy as np
    from s2p_tpu_torch.geo import geotiff
    h, w = size
    tdir = os.path.join(root, os.path.basename(tile['dir']))
    shutil.copytree(tile['dir'], tdir)
    pdir = os.path.join(tdir, 'pair_1')
    for name in ('rectified_disp.tif', 'rectified_ref.tif',
                 'rectified_disp_confidence.tif'):
        path = os.path.join(pdir, name)
        geotiff.write(path, np.ascontiguousarray(geotiff.read(path)[:h, :w]),
                      nodata=float('nan') if 'conf' not in name else None)
    path = os.path.join(pdir, 'rectified_mask.png')
    geotiff.write_png(path, np.ascontiguousarray(
        geotiff.read_png(path)[:h, :w]))
    return dict(tile, dir=tdir)


def model_altitudes(cfg, job, rows, cols):
    """The float64 model's answer at the given rectified pixels: the
    two-ray solve (12 secant steps) on the host cameras."""
    import numpy as np
    r1, r2 = cfg.images[0].rpcm, cfg.images[1].rpcm

    def apply(H, x, y):
        m = np.linalg.inv(H)
        z = m[2, 0] * x + m[2, 1] * y + m[2, 2]
        return ((m[0, 0] * x + m[0, 1] * y + m[0, 2]) / z,
                (m[1, 0] * x + m[1, 1] * y + m[1, 2]) / z)

    px, py = apply(job['H1'], cols, rows)
    qx, qy = apply(job['H2'] @ np.linalg.inv(job['A']),
                   cols + job['disp'][rows, cols].astype(np.float64), rows)
    h = np.zeros_like(px)
    for _ in range(12):
        a = r2.projection(*r1.localization(px, py, h), h)
        b = r2.projection(*r1.localization(px, py, h + 1.0), h + 1.0)
        ax, ay = b[0] - a[0], b[1] - a[1]
        lam = (ax * (qx - a[0]) + ay * (qy - a[1])) / (ax * ax + ay * ay)
        h = h + lam
    return h


def count_launches(fn):
    """(CUDA kernels the profiler saw, their summed device time in ms)
    while ``fn`` runs; (None, None) where it sees no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(e.count for e in events)
    if not kernels:
        return None, None
    return kernels, sum(e.self_device_time_total for e in events) / 1e3


def run_stage5(gpu_root, cpu_root, specs):
    """Stage 5 on bucket A's 8 tiles at full size on the card, after
    stage 4 wrote their files: synthetic cameras and homographies, the 3D
    filter on; its wall time per bucket (twice), the triangulation's
    launches and time and the neighbour count's time; then two tiles'
    crops card against CPU and a constant-disparity tile against the
    float64 model."""
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.core import triangulation
    from s2p_tpu_torch.geo import crs, geotiff, ply
    from s2p_tpu_torch.ops.filtering import count_3d_neighbors_batch

    cfg = stage5_config(gpu_root)
    tiles = write_stage5_inputs(gpu_root, specs)
    for run in (1, 2):
        t0 = time.perf_counter()
        pipeline.disparity_to_ply_all(cfg, tiles)
        torch.cuda.synchronize()
        print(f'  disparity_to_ply_all (bucket A, {len(tiles)} tiles, run '
              f'{run}): {time.perf_counter() - t0:.3f} s', flush=True)
    for t in tiles:
        pts, _ = ply.read_ply(os.path.join(t['dir'], 'cloud.ply'))
        disp = geotiff.read(os.path.join(t['dir'], 'pair_1',
                                         'rectified_disp.tif'))
        frac = len(pts) / np.isfinite(disp).sum()
        alt = pts[:, 2]
        print(f"  {os.path.basename(t['dir'])}: {len(pts)} points "
              f'({frac:.4f} of the finite disparities), altitude '
              f'{np.percentile(alt, 1):.2f} .. {np.percentile(alt, 99):.2f} m',
              flush=True)
        if (pts.shape[1] != 7 or not np.isfinite(pts).all() or frac < 0.5
                or not 200 < np.median(alt) < 400):
            raise AssertionError(f"stage 5: {t['dir']}: an implausible "
                                 'cloud')

    jobs = [pipeline._ply_tile_job(cfg, t) for t in tiles]
    out_crs = crs.CRS(cfg.out_crs)

    def tri():
        return triangulation.disp_to_xyz_batch(jobs, out_crs=out_crs)

    tri()
    t0 = time.perf_counter()
    res = tri()
    torch.cuda.synchronize()
    t_tri = time.perf_counter() - t0
    kernels, busy_ms = count_launches(tri)
    p = int(np.ceil(cfg.filtering_3d_r / cfg.gsd))
    xyzs = [r[0] for r in res]
    count_3d_neighbors_batch(xyzs, cfg.filtering_3d_r, p)
    t0 = time.perf_counter()
    count_3d_neighbors_batch(xyzs, cfg.filtering_3d_r, p)
    torch.cuda.synchronize()
    t_cnt = time.perf_counter() - t0
    busy = ('not measured' if busy_ms is None else
            f'{busy_ms:.1f} ms (idle share {1 - busy_ms / 1e3 / t_tri:.3f})')
    print(f'  disp_to_xyz_batch (bucket A, one batch of {len(jobs)}): '
          f'{t_tri:.3f} s, CUDA kernels '
          f"{kernels if kernels is not None else 'not measured'}, device "
          f'busy {busy}', flush=True)
    print(f'  count_3d_neighbors_batch (bucket A, p {p}): {t_cnt:.4f} s',
          flush=True)

    # card against CPU on crops of two tiles
    runs = {}
    for dev in ('cuda', 'cpu'):
        root = os.path.join(cpu_root, f's5_{dev}')
        os.makedirs(root)
        shutil.copy(os.path.join(gpu_root, 'global_pointing_pair_1.txt'),
                    root)
        crops = [crop_tile(t, root, S5_CROP) for t in tiles[:2]]
        pipeline.disparity_to_ply_all(stage5_config(root), crops,
                                      device=dev)
        runs[dev] = crops
    for a, b in zip(runs['cuda'], runs['cpu']):
        fa, fb = (os.path.join(t['dir'], 'cloud.ply') for t in (a, b))
        with open(fa, 'rb') as x, open(fb, 'rb') as y:
            same = x.read() == y.read()
        pa, pb = ply.read_ply(fa)[0], ply.read_ply(fb)[0]
        if pa.shape != pb.shape or not np.array_equal(pa[:, 3:], pb[:, 3:]):
            raise AssertionError(f"stage 5 crop {a['dir']}: points, colours "
                                 'or confidence differ from the CPU run')
        d_xy = float(np.abs(pa[:, :2] - pb[:, :2]).max()) if len(pa) else 0.
        d_z = float(np.abs(pa[:, 2] - pb[:, 2]).max()) if len(pa) else 0.
        print(f"  crop {S5_CROP} of {os.path.basename(a['dir'])}: "
              f'{len(pa)} points, cloud.ply equals the CPU run byte for '
              f'byte: {same}; max difference xy {d_xy} m, altitude {d_z} m',
              flush=True)
        if d_xy > S5_XY_TOL_M or d_z > S5_ALT_TOL_M:
            raise AssertionError('stage 5 crop: the card differs from the '
                                 'CPU beyond the tolerance')

    # a constant disparity against the float64 model's altitudes
    job = dict(jobs[0])
    job['disp'] = np.where(np.isfinite(job['disp']), S5_KNOWN_DISP,
                           np.nan).astype(np.float32)
    (xyz, err), = triangulation.disp_to_xyz_batch([job], out_crs=None)
    rows, cols = np.mgrid[4:job['disp'].shape[0]:8, 4:job['disp'].shape[1]:8]
    rows, cols = rows.ravel(), cols.ravel()
    alt = xyz[rows, cols, 2]
    fin = np.isfinite(alt)
    ref = model_altitudes(cfg, job, rows[fin], cols[fin])
    d = float(np.abs(alt[fin] - ref).max())
    print(f'  constant disparity {S5_KNOWN_DISP}: {fin.sum()} sampled '
          f'points, altitude {alt[fin].min():.3f} .. {alt[fin].max():.3f} m,'
          f' max difference from the float64 model {d:.5f} m (tolerance '
          f'{S5_KNOWN_TOL_M} m)', flush=True)
    if fin.mean() < 0.5 or d > S5_KNOWN_TOL_M:
        raise AssertionError('stage 5: the constant-disparity tile misses '
                             "the model's altitude")


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
    # K4b's step floor: one cluster barrier per step of the two passes
    floor = sum(timed(lambda: sk.cluster_sync_loop(1, n), 5)
                for n in (H, W))
    stats['scan_mgm']['step_floor_ms'] = floor
    print(f'  scan_mgm step floor ({H} + {W} cluster barriers, no work): '
          f'{floor:.4f} ms', flush=True)

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


def check_mgm_tile():
    """K4b at the classic tile's shape (832 x 832, 96 candidates from
    -30): the 3-lateral vertical pass and the 2-lateral horizontal pass of
    ``aggregate(mgm=True)`` against the plain version, bitwise, timed."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk
    from s2p_tpu_torch.ops.census import census_transform
    from s2p_tpu_torch.ops.sgm import SgmParams

    dev = torch.device('cuda')
    spec = dict(SGM_TILE, h=832, w=832)
    im1, im2 = sgm_pair(spec)
    dmin = spec['dmin']
    D = spec['dmax'] - dmin + 1
    H, W = im1.shape
    sig = [sk._pack(*census_transform(torch.as_tensor(im, device=dev), 5))
           [None] for im in (im1, im2)]
    p2 = torch.full((1, H, W), 32.0, dtype=torch.float32, device=dev)
    ins = {'v': (sig[0], sig[1], p2),
           'h': tuple(t.transpose(1, 2).contiguous()
                      for t in (sig[0], sig[1], p2))}
    for nb, want in ((3, 'vf'), (2, 'hf')):
        for key, _, dirs in sk.sgm_scan_passes(
                SgmParams(mgm=True, mgm_neighbors=nb)):
            if key != want:
                continue
            o = key[0]
            args = (*ins[o], dirs, 8.0, 24.0, 24, D, dmin, W, False, o == 'h')
            got = sk.scan_sig(*args)
            ref = sk.scan_sig_plain(*args)
            ok = all(equal(a, b)[0] for a, b in zip(got, ref))
            print(f'  scan_mgm tile {H} x {W} D {D} {key} '
                  f'({sk.scan_mgm_variant(D, W, o == "h")}): '
                  f'bitwise={ok}, kernel '
                  f'{timed(lambda: sk.scan_sig(*args), 3):.3f} ms',
                  flush=True)
            if not ok:
                raise AssertionError(f'scan_mgm tile {key} differs from its '
                                     'plain version')
            del got, ref
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
        check_no_spill(_build.build_log('scan'), 'scan_kernel')
        check_no_spill(_build.build_log('cost_prepass'),
                       'cost_prepass_kernel')
        check_no_spill(_build.build_log('scan_mgm'), 'scan_mgm_kernel')
        check_no_spill(_build.build_log('wta'), 'wta_dr_kernel')

    specs_a = tile_specs(BUCKET_A, 0)
    specs_b = tile_specs(BUCKET_B, len(specs_a))
    specs = specs_a + specs_b
    pairs = {s['index']: make_pair(s)
             for s in specs + [WIDE, SINGLE, SINGLE_800]}

    stats = {}
    with phase('flow kernels against their plain versions (bucket A)'):
        check_kernels(specs_a, pairs, stats)
    with phase('flow kernels against their plain versions (bucket B)'):
        check_kernels(specs_b, pairs, stats, BUCKET_B, tag='_b')
    with phase('flow kernels against their plain versions (D 528)'):
        check_kernels([WIDE], pairs, stats, BUCKET_WIDE, tag='_d528')
    with phase('K1 to K5 against their plain versions: adversarial '
               'shapes and values'):
        check_adversarial()
    with phase('classic matcher kernels against their plain versions'):
        check_sgm_kernels(stats)
        check_mgm_tile()
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
        with phase('stage 5 on bucket A (8 tiles, the 3D filter on)'):
            sk.reset_launch_counts()
            run_stage5(gpu_root, cpu_root, specs_a)
            launches['stage5'] = sk.launch_counts()
            print(f"  launches of the port's kernels: {launches['stage5']}",
                  flush=True)

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
                        'bound_by': by, 'library_ms': None,
                        **{k: st[k] for k in ('bucket_ms', 'step_floor_ms')
                           if k in st}})
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
