"""Pipeline stages of the port.  Ported so far: stage 4 with ``mgm``.

Counterpart of ``stereo_matching_all`` in ``s2p_tpu/pipeline.py``.  The
per-tile file contract is the JAX package's, so either package can run
stage 4 on the other's stage-3 files: each ``<tile>/pair_<i>/`` holds
``rectified_ref.tif``, ``rectified_sec.tif`` and ``disp_min_max.txt``,
and stage 4 writes ``rectified_disp.tif``, ``rectified_mask.png`` and
``rectified_disp_confidence.tif`` beside them.
"""

from __future__ import annotations

import os

import numpy as np

from .config import Config
from .core import masking, matching
from .device import resolve
from .geo import geotiff
from .ops.mgm_flow import mgm_binary_match_batch


def _remove(*paths):
    for p in paths:
        if os.path.exists(p):
            os.remove(p)


def _clean_after_matching(cfg: Config, out_dir):
    """The rectified secondary and the range file are dead after matching;
    the rectified reference stays in pair mode (stage 5 reads it for the
    cloud colours)."""
    if len(cfg.images) > 2:
        _remove(os.path.join(out_dir, 'rectified_ref.tif'))
    _remove(os.path.join(out_dir, 'rectified_sec.tif'),
            os.path.join(out_dir, 'disp_min_max.txt'))


def stereo_matching_all(cfg: Config, tiles_pairs, device=None):
    """Stage 4 for every (tile, pair index) in ``tiles_pairs``.

    Tiles are bucketed by padded shape: H and W up to multiples of 64, the
    candidate count up to a multiple of 16.  Each bucket runs as one
    batch through :func:`mgm_binary_match_batch` with per-tile disparity
    bases and true extents, so each tile's output equals its unpadded
    run.  ``device`` None runs on CUDA and raises without it; "cpu" runs
    the kernels' plain versions."""
    algo = cfg.matching_algorithm
    if algo != 'mgm':
        raise NotImplementedError(
            f'matcher {algo!r} is not ported yet (ROADMAP M12); the port '
            'runs stage 4 with mgm')
    dev = resolve(device)
    variant = matching.mgm_variant_from_cfg(cfg)
    jobs = []
    for tile, i in tiles_pairs:
        out_dir = os.path.join(tile['dir'], f'pair_{i}')
        rect1 = geotiff.read(os.path.join(out_dir, 'rectified_ref.tif')) \
            .astype(np.float32)
        rect2 = geotiff.read(os.path.join(out_dir, 'rectified_sec.tif')) \
            .astype(np.float32)
        dmin, dmax = np.loadtxt(os.path.join(out_dir, 'disp_min_max.txt'))
        dmin, dmax = matching.clamp_disparity_range(cfg, rect1.shape[1],
                                                    dmin, dmax)
        h, w = rect1.shape
        Hp = -(-h // 64) * 64
        Wp = -(-max(w, rect2.shape[1]) // 64) * 64
        Dp = -(-(dmax - dmin + 1) // 16) * 16
        jobs.append(dict(out_dir=out_dir, rect1=rect1, rect2=rect2,
                         dmin=int(dmin), dmax=int(dmax), key=(Hp, Wp, Dp)))

    buckets = {}
    for j in jobs:
        buckets.setdefault(j['key'], []).append(j)

    nv = max(2, min(variant.nb_dir, 8))
    for (Hp, Wp, Dp), group in buckets.items():
        n = len(group)
        b1 = np.full((n, Hp, Wp), np.nan, np.float32)
        b2 = np.full((n, Hp, Wp), np.nan, np.float32)
        for k, j in enumerate(group):
            b1[k, :j['rect1'].shape[0], :j['rect1'].shape[1]] = j['rect1']
            b2[k, :j['rect2'].shape[0], :j['rect2'].shape[1]] = j['rect2']
        out = mgm_binary_match_batch(
            b1, b2, [j['dmin'] for j in group], Dp,
            [j['rect1'].shape[0] for j in group],
            [j['rect1'].shape[1] for j in group],
            [j['rect2'].shape[1] for j in group],
            [j['dmax'] - j['dmin'] + 1 for j in group], variant, device=dev)
        disp_b = out['disp'].cpu().numpy()
        # uint8 consensus counts -> the device's exact f32 division
        conf_b = (out['confidence_u8'].cpu().numpy().astype(np.float32)
                  / np.float32(nv))
        for k, j in enumerate(group):
            h, w = j['rect1'].shape
            disp = disp_b[k, :h, :w]
            conf = conf_b[k, :h, :w]
            disp, mask = matching.finalize_disparity(
                disp, np.isfinite(disp), j['rect1'], j['rect2'])
            if cfg.msk_erosion >= 2:
                mask = masking.erosion(mask.astype(bool), cfg.msk_erosion) \
                    .astype(np.uint8)
                disp = np.where(mask, disp, np.nan).astype(np.float32)
            geotiff.write(os.path.join(j['out_dir'], 'rectified_disp.tif'),
                          disp, nodata=float('nan'))
            geotiff.write_png(os.path.join(j['out_dir'],
                                           'rectified_mask.png'),
                              (mask * 255).astype(np.uint8))
            geotiff.write(os.path.join(j['out_dir'],
                                       'rectified_disp_confidence.tif'),
                          conf.astype(np.float32))
            if cfg.clean_intermediate:
                _clean_after_matching(cfg, j['out_dir'])
