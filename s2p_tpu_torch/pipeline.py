"""Pipeline stages of the port.  Ported so far: stage 4 with ``mgm``
and stage 5 in pair mode.

Counterparts of ``stereo_matching_all`` and ``disparity_to_ply_all`` in
``s2p_tpu/pipeline.py``.  The per-tile file contract is the JAX
package's, so either package can run a stage on the other's files: each
``<tile>/pair_<i>/`` holds ``rectified_ref.tif``, ``rectified_sec.tif``
and ``disp_min_max.txt``, stage 4 writes ``rectified_disp.tif``,
``rectified_mask.png`` and ``rectified_disp_confidence.tif`` beside them,
and stage 5 reads those with ``H_ref.txt``, ``H_sec.txt``, the tile's
``mask.png`` and the scene's ``global_pointing_pair_1.txt`` and writes
the tile's ``cloud.ply``.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

from .config import Config
from .core import masking, matching, triangulation
from .device import resolve
from .geo import crs as crsmod
from .geo import geotiff
from .geo import ply as plymod
from .ops.filtering import count_3d_neighbors_batch, filter_xyz
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


# --------------------------------------------------------------------- #
# Stage 5: triangulation (pair mode)
# --------------------------------------------------------------------- #

def linear_stretching_and_quantization_8bit(img, p=1):
    """Percentile-stretched uint8 quantization (reference common.py)."""
    a, b = np.nanpercentile(img, (p, 100 - p))
    return np.round(255 * (np.clip(img, a, b) - a) / max(b - a, 1e-9)) \
        .astype(np.uint8)


def _tile_colors(cfg: Config, tile):
    """Colours for the point cloud: the 8-bit stretched rectified
    reference.  A ``clr`` image needs stage 3's homography warp, which is
    not ported yet."""
    if cfg.images[0].clr:
        raise NotImplementedError(
            'clr images need the homography warp of stage 3 (ROADMAP M7); '
            'the port colours the cloud from the rectified reference')
    img = geotiff.read(os.path.join(tile['dir'], 'pair_1',
                                    'rectified_ref.tif'))
    return linear_stretching_and_quantization_8bit(img)[None]


def _ply_tile_job(cfg: Config, tile):
    """Host prep of one tile's triangulation inputs (stage 5, pair mode)."""
    out_dir = tile['dir']
    x, y, w, h = tile['coordinates']
    pdir = os.path.join(out_dir, 'pair_1')
    pointing_file = os.path.join(cfg.out_dir, 'global_pointing_pair_1.txt')
    extra = os.path.join(pdir, 'rectified_disp_confidence.tif')
    return dict(
        rpc1=cfg.images[0].rpcm, rpc2=cfg.images[1].rpcm,
        H1=np.loadtxt(os.path.join(pdir, 'H_ref.txt')),
        H2=np.loadtxt(os.path.join(pdir, 'H_sec.txt')),
        disp=geotiff.read(os.path.join(pdir, 'rectified_disp.tif')),
        mask_rect=geotiff.read_png(os.path.join(pdir, 'rectified_mask.png')),
        mask_orig=geotiff.read_png(os.path.join(out_dir, 'mask.png')),
        img_bbx=(x, x + w, y, y + h),
        A=np.loadtxt(pointing_file),
        confidence=geotiff.read(extra) if os.path.exists(extra) else None,
    )


def _ply_tile_finish(cfg: Config, tile, job, xyz, err, count=None):
    """Host post of one tile: 3D filter, colours, PLY write."""
    if cfg.filtering_3d_r and cfg.filtering_3d_n:
        filter_xyz(xyz, cfg.filtering_3d_r, cfg.filtering_3d_n, cfg.gsd,
                   count=count)
    colors = _tile_colors(cfg, tile)
    proj_com = 'CRS {}'.format(cfg.out_crs)
    _write_tile_cloud(os.path.join(tile['dir'], 'cloud.ply'), xyz, colors,
                      proj_com, job['confidence'])
    if cfg.clean_intermediate:
        pdir = os.path.join(tile['dir'], 'pair_1')
        # after the colours are computed, as the reference does
        _remove(os.path.join(pdir, 'H_ref.txt'),
                os.path.join(pdir, 'H_sec.txt'),
                os.path.join(pdir, 'rectified_disp.tif'),
                os.path.join(pdir, 'rectified_mask.png'),
                os.path.join(pdir, 'rectified_ref.tif'),
                os.path.join(tile['dir'], 'mask.png'))


def disparity_to_ply_all(cfg: Config, tiles, timeout=600, nb_workers=None,
                         device=None):
    """Stage 5, pair mode, for every tile: each shape bucket triangulates
    as one batch on the device
    (:func:`s2p_tpu_torch.core.triangulation.disp_to_xyz_batch`), the 3D
    filter's neighbour counts of all tiles run as one batch too, and the
    host finish (filter, colours, PLY) fans out on a thread pool of
    ``nb_workers`` threads (default min(8, tiles)), ``timeout`` seconds
    for each.  A tile whose stage-4 files are missing is skipped.
    ``device`` None runs on CUDA and raises without it; "cpu" runs
    there."""
    dev = resolve(device)
    jobs = []
    for tile in tiles:
        try:
            jobs.append(_ply_tile_job(cfg, tile))
        except (OSError, ValueError):
            jobs.append(None)    # missing tile outputs tolerated
    live = [(t, j) for t, j in zip(tiles, jobs) if j is not None]
    if not live:
        return
    results = triangulation.disp_to_xyz_batch(
        [j for _, j in live], out_crs=crsmod.CRS(cfg.out_crs), device=dev)
    counts = [None] * len(results)
    if cfg.filtering_3d_r and cfg.filtering_3d_n:
        p = int(np.ceil(cfg.filtering_3d_r / cfg.gsd))
        counts = count_3d_neighbors_batch([r[0] for r in results],
                                          cfg.filtering_3d_r, p, dev)
    with concurrent.futures.ThreadPoolExecutor(
            nb_workers or min(8, len(live))) as pool:
        futures = [pool.submit(_ply_tile_finish, cfg, t, j, xyz, err, cnt)
                   for (t, j), (xyz, err), cnt in zip(live, results, counts)]
        for f in futures:
            f.result(timeout=timeout)


def _write_tile_cloud(path, xyz, colors, proj_com, confidence=None):
    """Flatten an xyz grid into a PLY cloud, dropping NaN points
    (reference triangulation.py)."""
    pts = xyz.reshape(-1, 3)
    valid = np.all(np.isfinite(pts), axis=1)
    col_list = None
    if colors is not None:
        col_list = colors.transpose(1, 2, 0).reshape(-1, colors.shape[0])[valid]
    extra = extra_names = None
    if confidence is not None:
        extra = confidence.reshape(-1)[valid].astype(np.float32)
        extra_names = ['confidence']
    plymod.write_ply(path, pts[valid], colors=col_list, extra=extra,
                     extra_names=extra_names,
                     comments=['created by S2P-TPU',
                               'projection: {}'.format(proj_com)])
