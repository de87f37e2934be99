"""The pipeline of the port: stages 1 to 7 of a scene of two images (a
pair) or more (a triplet, or any n), and the entry that runs them from a
config, :func:`main`.

Counterparts of ``main``, ``build_cfg``, ``pointing_correction_all``,
``global_pointing_correction``, ``rectification_all``,
``stereo_matching_all``, ``disparity_to_ply_all``,
``disparity_to_height_all``, ``mean_heights``, ``global_mean_heights``,
``heights_fusion``, ``heights_to_ply_all``, ``plys_to_dsm`` and
``global_dsm`` in ``s2p_tpu/pipeline.py``.  The per-tile file contract is
the JAX package's, so either package can run a stage on the other's
files: :func:`main` writes the scene's ``config.json`` and ``tiles.txt``
and, through :mod:`s2p_tpu_torch.tiling`, each tile's directory,
``config.json`` and ``mask.png``; stage 1 writes ``pointing.txt``,
``center_keypts_sec.txt`` and ``sift_matches.txt`` in each
``<tile>/pair_<i>/`` (one per secondary image i); stage 2 writes the
scene's ``global_pointing_pair_<i>.txt``; stage 3 writes ``H_ref.txt``,
``H_sec.txt``, ``disp_min_max.txt``, ``rectified_ref.tif`` and
``rectified_sec.tif``; stage 4 writes ``rectified_disp.tif``,
``rectified_mask.png`` and ``rectified_disp_confidence.tif`` beside them.
With two images, stage 5 reads those with the homographies, the tile's
``mask.png`` and the scene's ``global_pointing_pair_1.txt`` and writes the
tile's ``cloud.ply``.  With more, stage 5 runs in four steps: 5a
triangulates each pair into ``pair_<i>/height_map.tif`` on the reference
image's grid, 5b writes each tile's ``local_mean_heights.txt``, 5c the
scene's ``global_mean_height_pair_<i>.txt``, and 5d despeckles the pairs'
maps, fuses them into the tile's ``height_map.tif`` and localizes that
into the tile's ``cloud.ply``.  Stage 6 rasterizes each tile's cloud with
its neighbours' into the tile's ``dsm.tif`` and ``confidence.tif``, and
stage 7 mosaics those into the scene's.

Stages 1, 3, 4 and 5 (5a's triangulation, 5d's despeckling windows and
neighbour counts) run on the device that :func:`main` resolves once (CUDA
unless the caller names the CPU); stages 2, 6 and 7, 5b, 5c and the rest
of 5d are host numpy and scipy, as in the JAX package.  :func:`main` may
run in several processes over one ``out_dir`` (``parallel/distributed``),
each on its own block of tiles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from . import runner, tiling
from .config import Config, ImageSpec, read_config_file  # noqa: F401 (API)
from .core import (fusion, masking, matching, pointing, rectification,
                   rpc_geom, triangulation)
from .device import resolve
from .geo import crs as crsmod
from .geo import geotiff
from .geo import ply as plymod
from .geo import rpc_io
from .ops import rasterize
from .ops.filtering import count_3d_neighbors_batch, filter_xyz
from .ops.homography import warp_jobs_batched
from .ops.mgm_flow import mgm_binary_match_batch, mgm_multi_match_batch
from .ops.morphology import (despeckle_height_map,
                             remove_small_disparity_speckles)
from .ops import sift as sift_ops


@functools.lru_cache(maxsize=8)
def _image(path):
    """A full input image as float32, decoded once per path."""
    return geotiff.read(path).astype(np.float32)


def clear_image_cache():
    _image.cache_clear()


def _remove(*paths):
    for p in paths:
        if os.path.exists(p):
            os.remove(p)


def _alt_kwargs(cfg: Config):
    return dict(exogenous_dem=cfg.exogenous_dem,
                exogenous_dem_geoid_mode=cfg.exogenous_dem_geoid_mode,
                use_srtm=cfg.use_srtm,
                rpc_alt_range_scale_factor=cfg.rpc_alt_range_scale_factor)


# --------------------------------------------------------------------- #
# Stage 1: pointing correction
# --------------------------------------------------------------------- #

def _sift_method(cfg: Config):
    return 'relative' if cfg.relative_sift_match_thresh else 'absolute'


def pointing_correction(cfg: Config, tile, i, device=None):
    """Stage 1 for one tile pair: SIFT matches between the tile of the
    reference image and its counterpart in image ``i``, the median
    translation across the epipolar lines, and the tile's files.  SIFT
    takes the route :func:`sift_ops.set_device_mode` selects."""
    x, y, w, h = tile['coordinates']
    img1, img2 = cfg.images[0], cfg.images[i]
    A, m = pointing.compute_correction(
        _image(img1.img), _image(img2.img), img1.rpcm, img2.rpcm, x, y, w, h,
        _sift_method(cfg), cfg.sift_match_thresh, cfg.max_pointing_error,
        cfg.n_gcp_per_axis, device=device, **_alt_kwargs(cfg))
    _write_pointing_outputs(cfg, tile, i, A, m)


def _write_pointing_outputs(cfg: Config, tile, i, A, m):
    """A tile pair's stage-1 files: ``pointing.txt`` (the correction),
    ``sift_matches.txt`` and ``center_keypts_sec.txt`` (the mean
    secondary keypoint), each only where there is something to write;
    under ``cfg.debug`` also ``sift_matches_pointing.png``, the matches
    drawn over the two crops (:func:`visualisation.plot_matches`)."""
    out_dir = os.path.join(tile['dir'], f'pair_{i}')
    if A is not None:
        np.savetxt(os.path.join(out_dir, 'pointing.txt'), A, fmt='%6.3f')
    if m is not None:
        np.savetxt(os.path.join(out_dir, 'sift_matches.txt'), m, fmt='%9.3f')
        np.savetxt(os.path.join(out_dir, 'center_keypts_sec.txt'),
                   np.mean(m[:, 2:], 0), fmt='%9.3f')
        if cfg.debug:
            from .core import visualisation
            img1, img2 = cfg.images[0], cfg.images[i]
            x, y, w, h = tile['coordinates']
            visualisation.plot_matches(
                _image(img1.img), _image(img2.img), img1.rpcm, img2.rpcm, m,
                os.path.join(out_dir, 'sift_matches_pointing.png'),
                x, y, w, h)


def _pointing_jobs(cfg: Config, tiles_pairs):
    """The jobs of :func:`s2p_tpu_torch.ops.sift.matches_on_rpc_roi_batch`
    for stage 1's tile pairs."""
    jobs = []
    for tile, i in tiles_pairs:
        x, y, w, h = tile['coordinates']
        img1, img2 = cfg.images[0], cfg.images[i]
        jobs.append(dict(im1=_image(img1.img), im2=_image(img2.img),
                         rpc1=img1.rpcm, rpc2=img2.rpcm,
                         x=x, y=y, w=w, h=h, method=_sift_method(cfg),
                         sift_thresh=cfg.sift_match_thresh,
                         epipolar_threshold=cfg.max_pointing_error,
                         alt_kwargs=_alt_kwargs(cfg)))
    return jobs


def pointing_correction_all(cfg: Config, tiles_pairs, timeout=600,
                            nb_workers=None, device=None):
    """Stage 1 for every (tile, pair index) in ``tiles_pairs``.

    On SIFT's device route ('auto' or 'device', :func:`sift_ops
    .set_device_mode`) all tile pairs' SIFT detections run as one wave on
    the device and all matches as another
    (:func:`s2p_tpu_torch.ops.sift.matches_on_rpc_roi_batch`); the
    per-tile median-translation fit and file writes then fan out on
    :func:`runner.launch_calls` with ``nb_workers`` threads, ``timeout``
    seconds for each from its own start.  On the host route ('host')
    every tile pair runs :func:`pointing_correction` on those threads.
    Per-tile outputs equal :func:`pointing_correction`'s.  ``device`` None
    runs on CUDA and raises without it; "cpu" runs there."""
    dev = resolve(device)
    if not sift_ops._use_device_sift():
        runner.launch_calls(
            lambda t, i: pointing_correction(cfg, t, i, device=dev),
            tiles_pairs, nb_workers, timeout=timeout, debug=cfg.debug)
        return
    jobs = _pointing_jobs(cfg, tiles_pairs)
    matches = sift_ops.matches_on_rpc_roi_batch(jobs, device=dev)

    def finish(item, m):
        tile, i = item
        x, y, w, h = tile['coordinates']
        A = None
        if m is not None:
            A = pointing.local_translation(
                cfg.images[0].rpcm, cfg.images[i].rpcm, x, y, w, h, m,
                cfg.n_gcp_per_axis, **_alt_kwargs(cfg))
        _write_pointing_outputs(cfg, tile, i, A, m)

    runner.launch_calls(finish, list(zip(tiles_pairs, matches)),
                        nb_workers, tilewise=False, timeout=timeout)


# --------------------------------------------------------------------- #
# Stage 2: global pointing correction
# --------------------------------------------------------------------- #

def global_pointing_correction(cfg: Config, tiles):
    """Stage 2: fit one pointing correction per secondary image to the
    tiles' local corrections and write ``global_pointing_pair_<i>.txt``.
    Host numpy only (a tiny SVD solve)."""
    for i in range(1, len(cfg.images)):
        corrections = []
        for t in tiles:
            d = os.path.join(t['dir'], f'pair_{i}')
            pf = os.path.join(d, 'pointing.txt')
            cf_ = os.path.join(d, 'center_keypts_sec.txt')
            if os.path.isfile(pf) and os.path.isfile(cf_):
                corrections.append((np.loadtxt(pf), np.loadtxt(cf_)))
        out = os.path.join(cfg.out_dir, f'global_pointing_pair_{i}.txt')
        np.savetxt(out, pointing.global_from_local(corrections), fmt='%12.6f')
        if cfg.clean_intermediate:
            for t in tiles:
                _remove(os.path.join(t['dir'], f'pair_{i}',
                                     'center_keypts_sec.txt'))


# --------------------------------------------------------------------- #
# Stage 3: rectification
# --------------------------------------------------------------------- #

def _rectification_inputs(cfg: Config, tile, i):
    """A tile's pointing correction (its own, else the scene's) and its
    SIFT matches with those of its neighbours that fall inside an ellipse
    of semi-axes (3w/4, 3h/4) about the tile's centre."""
    out_dir = os.path.join(tile['dir'], f'pair_{i}')
    x, y, w, h = tile['coordinates']
    pointing_file = os.path.join(cfg.out_dir, f'global_pointing_pair_{i}.txt')
    try:
        A = np.loadtxt(os.path.join(out_dir, 'pointing.txt'))
    except OSError:
        A = np.loadtxt(pointing_file)
    try:
        m = np.loadtxt(os.path.join(out_dir, 'sift_matches.txt'))
        if m.ndim == 1:
            m = m.reshape(-1, 4)
    except OSError:
        m = None

    cur_dir = os.path.realpath(out_dir)
    for n in tile['neighborhood_dirs']:
        nei_dir = os.path.join(tile['dir'], n, f'pair_{i}')
        if not os.path.exists(nei_dir) or os.path.realpath(nei_dir) == cur_dir:
            continue
        try:
            m_n = np.loadtxt(os.path.join(nei_dir, 'sift_matches.txt'))
        except OSError:
            continue
        if m_n.ndim == 1:
            m_n = m_n.reshape(-1, 4)
        keep = np.linalg.norm(
            [(m_n[:, 0] - (x + w / 2)) / w,
             (m_n[:, 1] - (y + h / 2)) / h], axis=0) < 3 / 4
        m_n = m_n[keep]
        m = m_n if m is None else np.concatenate([m, m_n])
    return A, m


def _rectification_geometry(cfg: Config, tile, i):
    """One tile's homographies, disparity range and output size, written
    to ``H_ref.txt``, ``H_sec.txt`` and ``disp_min_max.txt``."""
    out_dir = os.path.join(tile['dir'], f'pair_{i}')
    x, y, w, h = tile['coordinates']
    img1, img2 = cfg.images[0], cfg.images[i]
    A, m = _rectification_inputs(cfg, tile, i)
    H1, H2, disp_min, disp_max, out_w, out_h = \
        rectification.rectify_pair_geometry(
            cfg, img1.rpcm, img2.rpcm, x, y, w, h, A=A,
            sift_matches=m, method=cfg.rectification_method,
            hmargin=cfg.horizontal_margin, vmargin=cfg.vertical_margin)
    np.savetxt(os.path.join(out_dir, 'H_ref.txt'), H1, fmt='%12.6f')
    np.savetxt(os.path.join(out_dir, 'H_sec.txt'), H2, fmt='%12.6f')
    np.savetxt(os.path.join(out_dir, 'disp_min_max.txt'),
               [disp_min, disp_max], fmt='%3.1f')
    return dict(out_dir=out_dir, img1=img1.img, img2=img2.img,
                H1=H1, H2=H2, w=out_w, h=out_h)


def _write_rectified(g, rect1, rect2):
    geotiff.write(os.path.join(g['out_dir'], 'rectified_ref.tif'), rect1)
    geotiff.write(os.path.join(g['out_dir'], 'rectified_sec.tif'), rect2)


def rectification_pair(cfg: Config, tile, i, device=None):
    """Stage 3 for one tile pair: :func:`rectification_all` of one item."""
    rectification_all(cfg, [(tile, i)], device=device)


def rectification_all(cfg: Config, tiles_pairs, timeout=600,
                      nb_workers=None, device=None):
    """Stage 3 for every (tile, pair index) in ``tiles_pairs``.

    The per-tile geometry (homographies, disparity ranges; host numpy in
    float64) fans out on :func:`runner.launch_calls` with ``nb_workers``
    threads, each tile's output in its ``stdout.log``, then the dense
    warps of all tiles run through
    :func:`s2p_tpu_torch.ops.homography.warp_jobs_batched`: one prefilter
    and one upload per input image, one W1 launch per group of up to 64
    tiles sharing an image and an output bucket.  The TIFF writes fan out
    again.  Each tile's step has ``timeout`` seconds from its own start;
    past it the stage raises :class:`runner.TimeoutError_`.  ``device``
    None runs the warps on CUDA and raises without it; "cpu" runs their
    plain version."""
    dev = resolve(device)
    geoms = runner.launch_calls(
        functools.partial(_rectification_geometry, cfg), list(tiles_pairs),
        nb_workers, timeout=timeout, debug=cfg.debug)
    jobs = []
    for g in geoms:
        jobs.append((_image(g['img1']), g['H1'], g['w'], g['h']))
        jobs.append((_image(g['img2']), g['H2'], g['w'], g['h']))
    rects = warp_jobs_batched(jobs, device=dev)
    runner.launch_calls(
        _write_rectified,
        [(g, rects[2 * k], rects[2 * k + 1]) for k, g in enumerate(geoms)],
        nb_workers, tilewise=False, timeout=timeout)


# --------------------------------------------------------------------- #
# Stage 4: stereo matching
# --------------------------------------------------------------------- #

def stereo_matching(cfg: Config, tile, i, device=None):
    """Stage 4 of one tile pair through :func:`matching.compute_disparity_map`:
    reads the pair's rectified images and range, writes its disparity,
    mask and (where the matcher has one) confidence.  ``device`` None
    runs on CUDA and raises without it."""
    dev = resolve(device)
    out_dir = os.path.join(tile['dir'], f'pair_{i}')
    rect1 = geotiff.read(os.path.join(out_dir, 'rectified_ref.tif'))
    rect2 = geotiff.read(os.path.join(out_dir, 'rectified_sec.tif'))
    disp_min, disp_max = np.loadtxt(os.path.join(out_dir,
                                                 'disp_min_max.txt'))
    disp, mask, conf = matching.compute_disparity_map(
        cfg, rect1, rect2, disp_min, disp_max, device=dev)
    _write_matching(cfg, out_dir, disp, mask, conf)


def _write_matching(cfg: Config, out_dir, disp, mask, conf):
    """A tile pair's stage-4 files, after the optional mask erosion; no
    confidence file where ``conf`` is None."""
    if cfg.msk_erosion >= 2:
        mask = masking.erosion(mask.astype(bool), cfg.msk_erosion) \
            .astype(np.uint8)
        disp = np.where(mask, disp, np.nan).astype(np.float32)
    geotiff.write(os.path.join(out_dir, 'rectified_disp.tif'), disp,
                  nodata=float('nan'))
    geotiff.write_png(os.path.join(out_dir, 'rectified_mask.png'),
                      (mask * 255).astype(np.uint8))
    if conf is not None:
        # the SGBM matchers have no confidence: no file, as in the JAX
        # package (stage 5 and 6 then carry none)
        geotiff.write(os.path.join(out_dir, 'rectified_disp_confidence.tif'),
                      conf.astype(np.float32))
    if cfg.clean_intermediate:
        _clean_after_matching(cfg, out_dir)


def _clean_after_matching(cfg: Config, out_dir):
    """The rectified secondary and the range file are dead after matching;
    the rectified reference stays in pair mode (stage 5 reads it for the
    cloud colours)."""
    if len(cfg.images) > 2:
        _remove(os.path.join(out_dir, 'rectified_ref.tif'))
    _remove(os.path.join(out_dir, 'rectified_sec.tif'),
            os.path.join(out_dir, 'disp_min_max.txt'))



def matching_buckets(cfg: Config, tiles_pairs):
    """Stage 4's jobs, read from each tile's stage-3 files, grouped by
    padded shape (Hp, Wp, Dp): H and W up to multiples of 64, the
    candidate count up to a multiple of 16.  A job holds its pair
    directory, its two rectified images and its clamped disparity range."""
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
    return buckets


def stereo_matching_all(cfg: Config, tiles_pairs, timeout=600, device=None):
    """Stage 4 for every (tile, pair index) in ``tiles_pairs``.

    ``mgm`` and ``mgm_multi`` bucket the tiles by padded shape
    (:func:`matching_buckets`) and run each bucket as one batch
    (:func:`mgm_binary_match_batch`, :func:`mgm_multi_match_batch`) with
    per-tile disparity bases and true extents, so each tile's output
    equals its unpadded run; the batches, like the JAX package's, run
    without a deadline.  Every other matcher runs tile by tile
    (:func:`stereo_matching`) on ``runner.launch_calls`` with
    ``cfg.max_processes_stereo_matching`` workers (default 1) and a
    deadline of ``timeout`` seconds a call.  ``device`` None runs on CUDA
    and raises without it; "cpu" runs the kernels' plain versions."""
    matching.check_matcher(cfg.matching_algorithm)
    dev = resolve(device)
    algo = cfg.matching_algorithm
    if algo not in ('mgm', 'mgm_multi'):
        runner.launch_calls(
            lambda t, i: stereo_matching(cfg, t, i, device=dev), tiles_pairs,
            cfg.max_processes_stereo_matching or 1, timeout=timeout,
            debug=cfg.debug)
        return
    variant = matching.mgm_variant_from_cfg(cfg)
    if algo == 'mgm_multi':
        # the -S 6 cascade's contract: no median, the speckle filter on
        # the result
        variant = dataclasses.replace(variant, median_order='none')
    nv = max(2, min(variant.nb_dir, 8))
    for (Hp, Wp, Dp), group in matching_buckets(cfg, tiles_pairs).items():
        n = len(group)
        b1 = np.full((n, Hp, Wp), np.nan, np.float32)
        b2 = np.full((n, Hp, Wp), np.nan, np.float32)
        for k, j in enumerate(group):
            b1[k, :j['rect1'].shape[0], :j['rect1'].shape[1]] = j['rect1']
            b2[k, :j['rect2'].shape[0], :j['rect2'].shape[1]] = j['rect2']
        batch = (mgm_multi_match_batch if algo == 'mgm_multi'
                 else mgm_binary_match_batch)
        out = batch(
            b1, b2, [j['dmin'] for j in group], Dp,
            [j['rect1'].shape[0] for j in group],
            [j['rect1'].shape[1] for j in group],
            [j['rect2'].shape[1] for j in group],
            [j['dmax'] - j['dmin'] + 1 for j in group], variant, device=dev)
        disp_b = out['disp'].cpu().numpy()
        if algo == 'mgm_multi':
            conf_b = out['confidence'].cpu().numpy()
        else:
            # uint8 consensus counts -> the device's exact f32 division
            conf_b = (out['confidence_u8'].cpu().numpy().astype(np.float32)
                      / np.float32(nv))
        for k, j in enumerate(group):
            h, w = j['rect1'].shape
            disp = disp_b[k, :h, :w]
            valid = np.isfinite(disp)
            if algo == 'mgm_multi' and cfg.stereo_speckle_filter:
                valid = remove_small_disparity_speckles(
                    np.nan_to_num(disp), valid, cfg.stereo_speckle_filter,
                    tol=1.0)
                disp = np.where(valid, disp, np.nan)
            disp, mask = matching.finalize_disparity(
                disp, valid, j['rect1'], j['rect2'])
            _write_matching(cfg, j['out_dir'], disp, mask, conf_b[k, :h, :w])


# --------------------------------------------------------------------- #
# Stage 5: triangulation (pair mode)
# --------------------------------------------------------------------- #

def linear_stretching_and_quantization_8bit(img, p=1):
    """Percentile-stretched uint8 quantization (reference common.py)."""
    a, b = np.nanpercentile(img, (p, 100 - p))
    return np.round(255 * (np.clip(img, a, b) - a) / max(b - a, 1e-9)) \
        .astype(np.uint8)


def _clr_colors(cfg: Config, jobs, device):
    """Each tile's colours from the ``clr`` image: its bands warped into
    the tile's rectified frame by the reference homography (order 5, one
    prefilter per band for all tiles) and used raw, NaN as 0: float
    colours in the PLY, as the reference writes them."""
    clr = _image(cfg.images[0].clr)    # (h, w) or (h, w, bands)
    bands = [clr] if clr.ndim == 2 else \
        [np.ascontiguousarray(clr[:, :, b]) for b in range(clr.shape[2])]
    warps = [(b, j['H1'], j['disp'].shape[1], j['disp'].shape[0])
             for j in jobs for b in bands]
    warped = warp_jobs_batched(warps, device=device)
    n = len(bands)
    return [np.nan_to_num(np.stack(warped[k * n:(k + 1) * n]))
            .astype(np.float32) for k in range(len(jobs))]


def _tile_colors(tile):
    """Colours for the point cloud without a ``clr`` image: the 8-bit
    stretched rectified reference."""
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


def _ply_tile_finish(cfg: Config, tile, job, xyz, count, colors):
    """Host post of one tile: 3D filter, colours, PLY write."""
    if cfg.filtering_3d_r and cfg.filtering_3d_n:
        filter_xyz(xyz, cfg.filtering_3d_r, cfg.filtering_3d_n, cfg.gsd,
                   count=count)
    if colors is None:
        colors = _tile_colors(tile)
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


def _triangulate(cfg: Config, live, dev, timeout, nb_workers):
    """Stage 5 of the (tile, job) pairs in ``live``: the batched
    triangulation, neighbour counts and ``clr`` warps on ``dev``, then the
    host finish of each tile on :func:`runner.launch_calls`."""
    results = triangulation.disp_to_xyz_batch(
        [j for _, j in live], out_crs=crsmod.CRS(cfg.out_crs), device=dev)
    counts = [None] * len(results)
    if cfg.filtering_3d_r and cfg.filtering_3d_n:
        p = int(np.ceil(cfg.filtering_3d_r / cfg.gsd))
        counts = count_3d_neighbors_batch([r[0] for r in results],
                                          cfg.filtering_3d_r, p, dev)
    colors = [None] * len(live)
    if cfg.images[0].clr:
        colors = _clr_colors(cfg, [j for _, j in live], dev)
    runner.launch_calls(
        functools.partial(_ply_tile_finish, cfg),
        [(t, j, xyz, cnt, col) for (t, j), (xyz, _), cnt, col
         in zip(live, results, counts, colors)], nb_workers,
        tilewise=False, timeout=timeout)


def disparity_to_ply(cfg: Config, tile, device=None):
    """Stage 5, pair mode, for one tile: :func:`disparity_to_ply_all` of
    that tile, except that a missing stage-4 file raises."""
    dev = resolve(device)
    _triangulate(cfg, [(tile, _ply_tile_job(cfg, tile))], dev, None, 1)


def disparity_to_ply_all(cfg: Config, tiles, timeout=600, nb_workers=None,
                         device=None):
    """Stage 5, pair mode, for every tile: each shape bucket triangulates
    as one batch on the device
    (:func:`s2p_tpu_torch.core.triangulation.disp_to_xyz_batch`), the 3D
    filter's neighbour counts of all tiles run as one batch too, a
    ``clr`` image's warps of all tiles run as one batch per band (W1),
    and the host finish (filter, colours, PLY) fans out on a thread pool of
    ``nb_workers`` threads (default min(8, tiles)) through
    :func:`runner.launch_calls`, ``timeout`` seconds for each from its own
    start.  A tile whose stage-4 files are missing is skipped.
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
    if live:
        _triangulate(cfg, live, dev, timeout, nb_workers)


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


# --------------------------------------------------------------------- #
# Stage 5, three or more images: height maps, offsets, fusion, clouds
# --------------------------------------------------------------------- #

def disparity_to_height(cfg: Config, tile, i, device=None):
    """Stage 5a for one tile pair: the pair's altitudes on the reference
    image's grid (:func:`s2p_tpu_torch.core.triangulation.height_map` on
    ``device``), written to ``pair_<i>/height_map.tif``."""
    out_dir = os.path.join(tile['dir'], f'pair_{i}')
    x, y, w, h = tile['coordinates']
    rpc1, rpc2 = cfg.images[0].rpcm, cfg.images[i].rpcm
    H_ref = np.loadtxt(os.path.join(out_dir, 'H_ref.txt'))
    H_sec = np.loadtxt(os.path.join(out_dir, 'H_sec.txt'))
    disp = geotiff.read(os.path.join(out_dir, 'rectified_disp.tif'))
    mask_rect = geotiff.read_png(os.path.join(out_dir, 'rectified_mask.png'))
    mask_orig = geotiff.read_png(os.path.join(tile['dir'], 'mask.png'))
    pointing_file = os.path.join(cfg.out_dir, f'global_pointing_pair_{i}.txt')

    hmap = triangulation.height_map(x, y, w, h, rpc1, rpc2, H_ref, H_sec,
                                    disp, mask_rect, mask_orig,
                                    A=np.loadtxt(pointing_file),
                                    device=device)
    geotiff.write(os.path.join(out_dir, 'height_map.tif'),
                  hmap.astype(np.float32), nodata=float('nan'))
    if cfg.clean_intermediate:
        _clean_after_height_map(out_dir)


def _clean_after_height_map(out_dir):
    """A pair's homographies and stage-4 maps are dead once its height map
    is written."""
    _remove(os.path.join(out_dir, 'H_ref.txt'),
            os.path.join(out_dir, 'H_sec.txt'),
            os.path.join(out_dir, 'rectified_disp.tif'),
            os.path.join(out_dir, 'rectified_mask.png'))


def disparity_to_height_all(cfg: Config, tiles_pairs, timeout=600,
                            nb_workers=None, device=None):
    """Stage 5a for every (tile, pair index) in ``tiles_pairs``: every
    tile pair triangulates in one batch per shape bucket on the device
    (:func:`s2p_tpu_torch.core.triangulation.disp_to_xyz_batch`, lon/lat/
    alt), then each pair's altitudes are resampled onto the reference
    image's grid and written (scipy, host) on :func:`runner.launch_calls`
    with ``nb_workers`` threads, ``timeout`` seconds for each from its own
    start.  A tile pair whose stage-4 files are missing is skipped.
    ``device`` None runs on CUDA and raises without it; "cpu" runs
    there."""
    dev = resolve(device)
    jobs, live = [], []
    for tile, i in tiles_pairs:
        out_dir = os.path.join(tile['dir'], f'pair_{i}')
        x, y, w, h = tile['coordinates']
        try:
            job = triangulation.height_map_job(
                x, y, w, h, cfg.images[0].rpcm, cfg.images[i].rpcm,
                np.loadtxt(os.path.join(out_dir, 'H_ref.txt')),
                np.loadtxt(os.path.join(out_dir, 'H_sec.txt')),
                geotiff.read(os.path.join(out_dir, 'rectified_disp.tif')),
                geotiff.read_png(os.path.join(out_dir,
                                              'rectified_mask.png')),
                geotiff.read_png(os.path.join(tile['dir'], 'mask.png')),
                A=np.loadtxt(os.path.join(
                    cfg.out_dir, f'global_pointing_pair_{i}.txt')))
        except (OSError, ValueError):
            continue     # missing tile outputs tolerated
        jobs.append(job)
        live.append((tile, i))
    if not jobs:
        return
    results = triangulation.disp_to_xyz_batch(jobs, out_crs=None, device=dev)

    def finish(item, res):
        (tile, i), job = item
        xyz, _ = res
        x, y, w, h = tile['coordinates']
        hmap = triangulation.height_map_resample(xyz[:, :, 2], x, y, w, h,
                                                 job['H1'])
        geotiff.write(os.path.join(tile['dir'], f'pair_{i}',
                                   'height_map.tif'),
                      hmap.astype(np.float32), nodata=float('nan'))
        if cfg.clean_intermediate:
            _clean_after_height_map(os.path.join(tile['dir'], f'pair_{i}'))

    runner.launch_calls(finish, list(zip(zip(live, jobs), results)),
                        nb_workers, tilewise=False, timeout=timeout)


def mean_heights(cfg: Config, tile):
    """Stage 5b for one tile: the mean of each pair's height map over the
    pixels where every pair has a height, in float64, written to the
    tile's ``local_mean_heights.txt`` (NaN where there are none)."""
    w, h = tile['coordinates'][2:]
    n = len(cfg.images) - 1
    maps = np.full((h, w, n), np.nan)
    for i in range(n):
        p = os.path.join(tile['dir'], f'pair_{i + 1}', 'height_map.tif')
        if os.path.exists(p):
            maps[:, :, i] = geotiff.read(p)
    validity = maps.sum(axis=2)               # nan propagates
    validity += 1 - validity                  # 1 on valid, nan on invalid
    np.savetxt(os.path.join(tile['dir'], 'local_mean_heights.txt'),
               [np.nanmean(validity * maps[:, :, i]) for i in range(n)])


def global_mean_heights(cfg: Config, tiles):
    """Stage 5c: each pair's mean over the tiles' local means, written to
    the scene's ``global_mean_height_pair_<i>.txt``."""
    locals_ = [np.loadtxt(os.path.join(t['dir'], 'local_mean_heights.txt'))
               for t in tiles]
    g = np.nanmean(np.atleast_2d(locals_), axis=0)
    for i in range(len(cfg.images) - 1):
        np.savetxt(os.path.join(cfg.out_dir,
                                f'global_mean_height_pair_{i + 1}.txt'),
                   [np.atleast_1d(g)[i]])


def heights_fusion(cfg: Config, tile, device=None):
    """Stage 5d's fusion for one tile: each pair's height map despeckled
    (``cargarse_basura``; its window ops on ``device``, None: CUDA,
    raising without it) and written back, then all merged with the
    pairs' global mean offsets (``fusion_operator``, ``fusion_thresh``)
    into the tile's ``height_map.tif``.  Under ``debug`` each pair's map
    registered to the mean offset is saved beside it."""
    dev = resolve(device)
    tile_dir = tile['dir']
    n = len(cfg.images) - 1
    paths = [os.path.join(tile_dir, f'pair_{i + 1}', 'height_map.tif')
             for i in range(n)]
    maps = []
    for p in paths:
        hm = geotiff.read(p)
        if cfg.cargarse_basura:
            hm = despeckle_height_map(hm, device=dev)
            geotiff.write(p, hm.astype(np.float32), nodata=float('nan'))
        maps.append(hm)
    offsets = [float(np.loadtxt(os.path.join(
        cfg.out_dir, f'global_mean_height_pair_{i + 1}.txt')))
        for i in range(n)]
    if cfg.debug:
        mean_off = float(np.mean(offsets))
        for p, hm, off in zip(paths, maps, offsets):
            geotiff.write(p[:-len('.tif')] + '_registered.tif',
                          (hm - off + mean_off).astype(np.float32),
                          nodata=float('nan'))
    merged = fusion.merge_n_arrays(maps, offsets, cfg.fusion_operator,
                                   cfg.fusion_thresh)
    geotiff.write(os.path.join(tile_dir, 'height_map.tif'),
                  merged.astype(np.float32), nodata=float('nan'))
    if cfg.clean_intermediate:
        _remove(*paths)


def _heights_tile_xyz(cfg: Config, tile, device=None):
    """Stage 5d's first half for one tile: :func:`heights_fusion`, the
    colours (the ``clr`` image's window used raw, else the 8-bit
    stretched crop of the reference image) and the fused map localized on
    the host in float64 into ``out_crs``.  Returns (xyz, colours)."""
    heights_fusion(cfg, tile, device)
    out_dir = tile['dir']
    x, y, w, h = tile['coordinates']
    hmap = geotiff.read(os.path.join(out_dir, 'height_map.tif'))

    if cfg.images[0].clr:
        colors = geotiff.read(cfg.images[0].clr, window=(x, y, w, h))
        colors = colors[None] if colors.ndim == 2 \
            else np.moveaxis(colors, 2, 0)
    else:
        img = _image(cfg.images[0].img)[y:y + h, x:x + w]
        colors = linear_stretching_and_quantization_8bit(img)[None]

    xyz = triangulation.height_map_to_xyz(hmap, cfg.images[0].rpcm, x, y,
                                          crsmod.CRS(cfg.out_crs))
    return xyz, colors


def _heights_tile_finish(cfg: Config, tile, xyz, colors, count=None):
    """Stage 5d's tail for one tile: 3D filter, ``cloud.ply``, clean-up."""
    out_dir = tile['dir']
    if cfg.filtering_3d_r and cfg.filtering_3d_n:
        filter_xyz(xyz, cfg.filtering_3d_r, cfg.filtering_3d_n, cfg.gsd,
                   count=count)
    _write_tile_cloud(os.path.join(out_dir, 'cloud.ply'), xyz, colors,
                      'CRS {}'.format(cfg.out_crs))
    if cfg.clean_intermediate:
        _remove(os.path.join(out_dir, 'height_map.tif'),
                os.path.join(out_dir, 'mask.png'))


def heights_to_ply(cfg: Config, tile, device=None):
    """Stage 5d for one tile: fusion, localization, 3D filter (its
    neighbour count on ``device``) and ``cloud.ply``."""
    dev = resolve(device)
    xyz, colors = _heights_tile_xyz(cfg, tile, dev)
    count = None
    if cfg.filtering_3d_r and cfg.filtering_3d_n:
        p = int(np.ceil(cfg.filtering_3d_r / cfg.gsd))
        count, = count_3d_neighbors_batch([xyz], cfg.filtering_3d_r, p, dev)
    _heights_tile_finish(cfg, tile, xyz, colors, count)


def heights_to_ply_all(cfg: Config, tiles, timeout=600, nb_workers=None,
                       device=None):
    """Stage 5d for every tile: fusion, colours and localization per tile
    on :func:`runner.launch_calls` (``nb_workers`` threads, the first tile
    alone and without a deadline, the others ``timeout`` seconds each),
    the 3D filter's neighbour counts of all tiles as one batch on the
    device, then the filter and ``cloud.ply`` per tile on the thread
    pool.  ``device`` None runs on CUDA and raises without it; "cpu" runs
    there."""
    dev = resolve(device)
    if not tiles:
        return
    prepped = runner.launch_calls(
        lambda t: _heights_tile_xyz(cfg, t, dev), tiles, nb_workers,
        timeout=timeout, debug=cfg.debug, warmup_first=True)
    counts = [None] * len(tiles)
    if cfg.filtering_3d_r and cfg.filtering_3d_n:
        p = int(np.ceil(cfg.filtering_3d_r / cfg.gsd))
        counts = count_3d_neighbors_batch([x for x, _ in prepped],
                                          cfg.filtering_3d_r, p, dev)
    runner.launch_calls(
        lambda t, xc, cnt: _heights_tile_finish(cfg, t, xc[0], xc[1],
                                                count=cnt),
        list(zip(tiles, prepped, counts)), nb_workers, tilewise=False,
        timeout=timeout)


# --------------------------------------------------------------------- #
# Stages 6 and 7: rasterization and mosaic (host numpy)
# --------------------------------------------------------------------- #

def plys_to_dsm(cfg: Config, tile):
    """Stage 6 for one tile: rasterize the tile's cloud together with its
    neighbours' clouds (the splat halo) on the grid of the tile's own
    cloud's extent, into the tile's ``dsm.tif`` and (when the clouds carry
    a confidence) ``confidence.tif``."""
    out_dsm = os.path.join(tile['dir'], 'dsm.tif')
    out_conf = os.path.join(tile['dir'], 'confidence.tif')
    r = cfg.dsm_resolution

    own = os.path.join(tile['dir'], 'cloud.ply')
    if not os.path.exists(own):
        return
    points, _ = plymod.read_ply(own)
    if len(points) == 0:
        return
    xmin, ymin = points[:, 0].min(), points[:, 1].min()
    xmax, ymax = points[:, 0].max(), points[:, 1].max()
    xoff, yoff, xsize, ysize = rasterize.grid_from_roi(xmin, ymin, xmax, ymax,
                                                       r)

    clouds = [os.path.join(tile['dir'], n, 'cloud.ply')
              for n in tile['neighborhood_dirs']]
    clouds = [c for c in clouds if os.path.exists(c)] or [own]
    raster, profile = rasterize.plyflatten_from_plyfiles_list(
        clouds, resolution=r, roi=(xoff, yoff, xsize, ysize),
        radius=cfg.dsm_radius, sigma=cfg.dsm_sigma)
    profile = profile.copy(crs=crsmod.CRS(cfg.out_crs))

    geotiff.write(out_dsm, raster[:, :, 0].astype(np.float32), profile=profile)
    if raster.shape[-1] == 5:
        geotiff.write(out_conf, raster[:, :, 4].astype(np.float32),
                      profile=profile)


def _merge_rasters(paths, out_path, res, bounds=None):
    """'First'-wins mosaic of georeferenced rasters onto a common grid of
    cell ``res`` over ``bounds`` (left, bottom, right, top; default the
    union of the rasters), written as a deflate-compressed, tiled GeoTIFF
    with nodata NaN; returns the mosaic."""
    profs = [geotiff.read_profile(p) for p in paths]
    if bounds is None:
        xs0 = [pr.transform[2] for pr in profs]
        ys1 = [pr.transform[5] for pr in profs]
        xs1 = [pr.transform[2] + pr.width * res for pr in profs]
        ys0 = [pr.transform[5] - pr.height * res for pr in profs]
        bounds = (min(xs0), min(ys0), max(xs1), max(ys1))
    left, bottom, right, top = bounds
    W = int(round((right - left) / res))
    H = int(round((top - bottom) / res))
    out = np.full((H, W), np.nan, dtype=np.float32)
    for p, pr in zip(paths, profs):
        arr = geotiff.read_with_nans(p)
        j0 = int(round((pr.transform[2] - left) / res))
        i0 = int(round((top - pr.transform[5]) / res))
        hh, ww = arr.shape
        i1 = min(i0 + hh, H)
        j1 = min(j0 + ww, W)
        ci0, cj0 = max(-i0, 0), max(-j0, 0)
        if i1 <= max(i0, 0) or j1 <= max(j0, 0):
            continue
        dst = out[max(i0, 0):i1, max(j0, 0):j1]
        src = arr[ci0:ci0 + dst.shape[0], cj0:cj0 + dst.shape[1]]
        np.copyto(dst, src, where=np.isnan(dst) & np.isfinite(src))
    geotiff.write(out_path, out,
                  crs=profs[0].crs,
                  transform=(res, 0.0, left, 0.0, -res, top),
                  nodata=float('nan'), compress='deflate', tiled=True)
    return out


def global_dsm(cfg: Config, tiles):
    """Stage 7: the scene's ``dsm.tif`` and ``confidence.tif``, mosaics of
    the tiles' on the grid of ``dsm_resolution``, cut to the bounds of
    ``roi_geojson`` where the config has one."""
    bounds = None
    if cfg.roi_geojson is not None:
        ll_poly = read_lon_lat_poly_from_geojson(cfg.roi_geojson)
        out_crs = crsmod.CRS(cfg.out_crs)
        xs, ys = crsmod.transform(ll_poly[:, 0], ll_poly[:, 1], 4326, out_crs)
        a = cfg.dsm_resolution
        bounds = (a * np.floor(xs.min() / a), a * np.floor(ys.min() / a),
                  a * np.ceil(xs.max() / a), a * np.ceil(ys.max() / a))

    dsms = [os.path.join(t['dir'], 'dsm.tif') for t in tiles]
    dsms = [d for d in dsms if os.path.exists(d)]
    confs = [os.path.join(t['dir'], 'confidence.tif') for t in tiles]
    confs = [c for c in confs if os.path.exists(c)]
    if dsms:
        _merge_rasters(dsms, os.path.join(cfg.out_dir, 'dsm.tif'),
                       cfg.dsm_resolution, bounds)
    if confs:
        _merge_rasters(confs, os.path.join(cfg.out_dir, 'confidence.tif'),
                       cfg.dsm_resolution, bounds)


# --------------------------------------------------------------------- #
# The entry: config, tiling, stages 1 to 7
# --------------------------------------------------------------------- #

def build_cfg(user_cfg: dict) -> Config:
    """Validate a user config (the s2p JSON schema as a dict) and derive
    the run's parameters: absolute image paths, each image's camera (from
    its ``rpc`` entry, else from its GeoTIFF's RPC tag), the ROI in whole
    pixels (``full_img``, ``roi`` or ``roi_geojson``), the output CRS (the
    ROI centre's UTM zone unless ``out_crs`` names one, '+5773' with
    ``out_geoid``) and the ground sample distance."""
    d = dict(user_cfg)
    if 'images' not in d or len(d['images']) < 2:
        raise ValueError('missing paths to input images')

    images = []
    for img in d['images']:
        spec = img if isinstance(img, ImageSpec) else ImageSpec(
            **{k: img[k] for k in ('img', 'rpc', 'clr', 'cld', 'roi', 'wat')
               if k in img})
        spec = dataclasses.replace(spec, **{
            f: os.path.abspath(getattr(spec, f))
            for f in ('img', 'clr', 'cld', 'roi', 'wat')
            if getattr(spec, f) is not None
            and not os.path.isabs(getattr(spec, f))})
        rpcm = rpc_io.load_rpc(spec.rpc) if spec.rpc is not None \
            else rpc_io.rpc_from_geotiff(spec.img)
        images.append(dataclasses.replace(spec, rpcm=rpcm))
    d['images'] = tuple(images)

    if d.get('full_img'):
        prof = geotiff.read_profile(images[0].img)
        d['roi'] = {'x': 0, 'y': 0, 'w': prof.width, 'h': prof.height}
    elif 'roi' in d and all(k in d['roi'] for k in 'xywh'):
        pass
    elif 'roi_geojson' in d:
        ll_poly = read_lon_lat_poly_from_geojson(d['roi_geojson'])
        d['roi'] = rpc_geom.roi_process(
            images[0].rpcm, ll_poly, use_srtm=d.get('use_srtm', False),
            exogenous_dem=d.get('exogenous_dem'),
            exogenous_dem_geoid_mode=d.get('exogenous_dem_geoid_mode', True))
    else:
        raise ValueError('missing or incomplete roi definition')
    d['roi'] = {'x': int(np.floor(d['roi']['x'])),
                'y': int(np.floor(d['roi']['y'])),
                'w': int(np.ceil(d['roi']['w'])),
                'h': int(np.ceil(d['roi']['h']))}

    cfg = Config.from_user_dict(d)
    if cfg.out_crs is None:
        r = cfg.roi
        zone = rpc_geom.utm_zone(images[0].rpcm, r['x'], r['y'], r['w'],
                                 r['h'])
        out_crs = f'epsg:{crsmod.epsg_code_from_utm_zone(zone)}'
        if cfg.out_geoid:
            out_crs += '+5773'
        cfg = cfg.replace(out_crs=out_crs)
    crsmod.CRS(cfg.out_crs)  # validate
    return cfg.replace(gsd=rpc_geom.gsd_from_rpc(images[0].rpcm))


def read_lon_lat_poly_from_geojson(poly):
    """The (lon, lat) ring of a GeoJSON polygon, feature or feature
    collection (its first feature), given as a path or a dict."""
    if isinstance(poly, str):
        with open(poly) as f:
            a = json.load(f)
    else:
        a = poly
    if a['type'] == 'FeatureCollection':
        a = a['features'][0]
    if a['type'] == 'Feature':
        a = a['geometry']
    return np.asarray(a['coordinates'][0])


@contextlib.contextmanager
def _stage(label, times):
    """Stage banner and elapsed-time print (kept in ``times[label]``);
    when S2P_TPU_PROFILE names a directory, a ``torch.profiler`` trace of
    the stage (host, and the card's kernels where CUDA is present) is
    written there as ``<label>.json``, a Chrome trace."""
    print(label)
    prof_dir = os.environ.get('S2P_TPU_PROFILE')
    t0 = time.time()
    try:
        if prof_dir:
            import torch
            slug = ''.join(c if c.isalnum() else '_'
                           for c in label.strip('. '))
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(prof_dir, exist_ok=True)
            with torch.profiler.profile(activities=acts) as prof:
                yield
            prof.export_chrome_trace(os.path.join(prof_dir, slug + '.json'))
        else:
            yield
    finally:
        times[label] = time.time() - t0
        print('elapsed time: {:.3f} s'.format(times[label]))


@contextlib.contextmanager
def _step(label, times, show=True):
    """A step inside a stage: its label printed (unless ``show`` is
    false) and its seconds kept in ``times[label]``, with no elapsed-time
    line, so that the stage's output stays the JAX package's."""
    if show:
        print(label)
    t0 = time.time()
    try:
        yield
    finally:
        times[label] = time.time() - t0


# first per-tile input file each resumable stage reads; resuming a stage
# whose inputs were swept by ``clean_intermediate`` must fail loudly, not
# recompute on garbage.  Only the TOTAL absence of the file across tiles
# errors -- individual missing tiles stay tolerated (failed tiles leave
# gaps that the later stages skip).
_RESUME_NEEDS = {
    2: 'pointing.txt',
    3: 'pointing.txt',
    4: 'rectified_sec.tif',
    5: 'rectified_disp.tif',
}


def _check_resume_inputs(start_from, tiles_pairs):
    fname = _RESUME_NEEDS.get(start_from)
    if fname is None or not tiles_pairs:
        return
    if not any(os.path.exists(os.path.join(t['dir'], f'pair_{i}', fname))
               for t, i in tiles_pairs):
        raise RuntimeError(
            f'start_from={start_from} resumes a stage that reads per-tile '
            f'{fname!r}, but no tile has it: the intermediate files were '
            f'deleted (clean_intermediate trades resumability for disk) '
            f'or the earlier stages never ran. Re-run from an earlier '
            f'stage.')


def main(user_cfg, start_from=0, device=None, stage_times=None):
    """Run a scene from ``user_cfg`` (the s2p JSON schema as a dict, e.g.
    from :func:`read_config_file`) through stages 1 to 7, from stage
    ``start_from`` on (the earlier stages' files must be there), and
    return the built :class:`Config`.

    With two images stage 5 triangulates each tile into its
    ``cloud.ply``.  With three or more (the triplet), stages 1-4 run for
    every pair (reference image, image i) and stage 5 runs in four steps:
    5a writes each pair's ``pair_<i>/height_map.tif``, 5b each tile's
    ``local_mean_heights.txt``, 5c the scene's
    ``global_mean_height_pair_<i>.txt``, and 5d each tile's fused
    ``height_map.tif`` and ``cloud.ply`` (the file set is the JAX
    package's, with and without ``clean_intermediate``).

    Several processes: with ``S2P_TPU_COORDINATOR``,
    ``S2P_TPU_NUM_PROCESSES`` and ``S2P_TPU_PROCESS_ID`` set (or the group
    already up, :func:`parallel.distributed.init`), the processes share
    ``out_dir`` over a gloo group.  The primary writes the scene's files
    and the tiles' and the others reload ``tiles.txt``; each process runs
    stages 1, 3, 4, 5 (5a, 5b and 5d for a triplet) and 6 on its own
    contiguous block of tiles; stages 2, 5c and 7 run on the primary; every
    stage ends at a barrier.  Each process drives one device and owns each
    of its tiles' whole chain, so the DSM equals a one-process run's.  The
    JAX package also shards a bucket over the local devices of one process
    (stages 1 and 3-5); the port does not: run one process per GPU.

    ``device`` is resolved once (None: CUDA device ``process index %
    device count``, raising without CUDA; "cpu": the kernels' plain
    versions) and passed to every stage that runs on a device.  SIFT
    takes the route of ``cfg.sift_device`` (set for the process and left
    so, as the JAX package's ``main`` does).  ``micmac`` and unknown
    matchers raise NotImplementedError before anything is written.  A dict
    passed as ``stage_times`` receives each stage's elapsed seconds under
    its banner and, for a triplet, each of 5a-5d's under its own label."""
    from .parallel import distributed as dist

    dev = resolve(device)
    dist.init()
    if device is None:
        dev = torch.device('cuda',
                           dist.process_index() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    cfg = build_cfg(user_cfg)
    sift_ops.set_device_mode(cfg.sift_device)
    if start_from <= 4:
        # refuse, before any file is written, a run no matcher can finish
        matching.check_matcher(cfg.matching_algorithm)
    times = {} if stage_times is None else stage_times

    # the scene's and the tiles' initial files are written once, by the
    # primary; the others wait and reload the tile list
    nb_workers = cfg.max_processes or min(8, os.cpu_count() or 1)
    tw, th = tiling.adjust_tile_size(cfg)
    tiles_txt = os.path.join(cfg.out_dir, 'tiles.txt')
    if dist.is_primary():
        os.makedirs(cfg.out_dir, exist_ok=True)
        cfg.dump_json(os.path.join(cfg.out_dir, 'config.json'))
        tiles = tiling.tiles_full_info(
            cfg, tw, th, tiles_txt, create_masks=True,
            runner=runner.PoolRunner(nb_workers, cfg.timeout))
        if not tiles:
            raise RuntimeError(
                'the ROI is not seen in two images or is totally masked')
        if start_from > 0:
            assert os.path.exists(tiles_txt), (
                f'start_from set to {start_from} but tiles.txt not found in '
                f'{cfg.out_dir!r}')
        else:
            with open(tiles_txt, 'w') as f:
                for t in tiles:
                    print(t['json'], file=f)
    dist.barrier('initialization')
    if not dist.is_primary():
        tiles = tiling.tiles_full_info(cfg, tw, th, tiles_txt,
                                       create_masks=False)
        if not tiles:
            raise RuntimeError(
                'the ROI is not seen in two images or is totally masked')

    n = len(cfg.images)
    timeout = cfg.timeout
    my_tiles = dist.partition_tiles(tiles)
    my_pairs = [(t, i) for i in range(1, n) for t in my_tiles]
    if start_from > 0:
        _check_resume_inputs(start_from, my_pairs)

    if start_from <= 1:
        with _stage('1) correcting pointing locally...', times):
            pointing_correction_all(cfg, my_pairs, timeout=timeout,
                                    nb_workers=nb_workers, device=dev)
        dist.barrier('pointing')
    if start_from <= 2:
        with _stage('2) correcting pointing globally...', times):
            if dist.is_primary():
                global_pointing_correction(cfg, tiles)
        dist.barrier('global_pointing')
    if start_from <= 3:
        with _stage('3) rectifying tiles...', times):
            rectification_all(cfg, my_pairs, timeout=timeout,
                              nb_workers=nb_workers, device=dev)
        dist.barrier('rectification')
        if cfg.clean_intermediate:
            # swept after the barrier, not during the stage, so that the
            # neighbours' matches stage 3 reads (in any process) are all
            # still there
            for t, i in my_pairs:
                d = os.path.join(t['dir'], f'pair_{i}')
                _remove(os.path.join(d, 'pointing.txt'),
                        os.path.join(d, 'sift_matches.txt'))
    if start_from <= 4:
        with _stage('4) running stereo matching...', times):
            stereo_matching_all(cfg, my_pairs, timeout=cfg.mgm_timeout,
                                device=dev)
        dist.barrier('matching')
    if start_from <= 5:
        if n > 2:
            with _stage('5) height maps, offsets, fusion, point clouds...',
                        times):
                # 5a prints no label of its own, as in the JAX package
                with _step('5a) height maps...', times, show=False):
                    disparity_to_height_all(cfg, my_pairs,
                                            timeout=timeout,
                                            nb_workers=nb_workers,
                                            device=dev)
                with _step('5b) computing local pairwise height offsets...',
                           times):
                    runner.launch_calls(functools.partial(mean_heights, cfg),
                                        my_tiles, nb_workers,
                                        timeout=timeout, debug=cfg.debug)
                    dist.barrier('mean_heights')
                with _step('5c) computing global pairwise height '
                           'offsets...', times):
                    if dist.is_primary():
                        global_mean_heights(cfg, tiles)
                    dist.barrier('global_mean_heights')
                with _step('5d) merging height maps and computing point '
                           'clouds...', times):
                    heights_to_ply_all(cfg, my_tiles, timeout=timeout,
                                       nb_workers=nb_workers, device=dev)
        else:
            with _stage('5) triangulating tiles...', times):
                disparity_to_ply_all(cfg, my_tiles, timeout=timeout,
                                     nb_workers=nb_workers, device=dev)
        dist.barrier('clouds')
    if start_from <= 6:
        with _stage('6) computing DSM by tile...', times):
            runner.launch_calls(functools.partial(plys_to_dsm, cfg),
                                my_tiles, nb_workers, timeout=timeout,
                                debug=cfg.debug)
        dist.barrier('tile_dsm')
    if start_from <= 7:
        with _stage('7) computing global DSM...', times):
            if dist.is_primary():
                global_dsm(cfg, tiles)
        dist.barrier('global_dsm')

    clear_image_cache()
    return cfg
