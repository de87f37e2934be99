"""Stage-4 matching: the mgm variant of a config, the disparity range
policy, the rejection mask and the single-pair matcher dispatch.

Counterpart of ``mgm_variant_from_cfg``, ``compute_disparity_map`` (every
matcher of the JAX package: ``mgm``, ``mgm_multi``, ``mgm_multi_lsd``,
``sgbm``, the three ``hirschmuller08`` variants, ``hirschmuller02``,
``msmw``, ``msmw2``, ``msmw3`` and ``tvl1``; ``micmac`` raises, as there),
``finalize_disparity``, ``clamp_disparity_range`` and
``MaxDisparityRangeError`` in ``s2p_tpu/core/matching.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import runner
from ..config import Config
from ..ops.lsd import lsd_weights
from ..ops import msmw, tvl1
from ..ops.mgm_flow import MgmVariant, mgm_binary_match, mgm_multi_match
from ..ops.morphology import remove_small_disparity_speckles
from ..ops.sgm import SgmParams, match_pair

# OpenCV's SGBM behind the reference's prefilters (callSGBM*.sh)
SGBM_MATCHERS = ('sgbm', 'hirschmuller08', 'hirschmuller08_laplacian',
                 'hirschmuller08_cauchy')
# one engine under three names
MSMW_MATCHERS = ('msmw', 'msmw2', 'msmw3')
MATCHERS = (('mgm', 'mgm_multi', 'mgm_multi_lsd') + SGBM_MATCHERS
            + ('hirschmuller02',) + MSMW_MATCHERS + ('tvl1',))

MICMAC_MESSAGE = (
    "matcher 'micmac' requires an external MicMac installation; use one of "
    "the built-in engines (mgm, mgm_multi, sgbm, msmw, tvl1, "
    "hirschmuller02/08*)")


def check_matcher(algo):
    """Raise NotImplementedError for a matcher that no engine runs:
    ``micmac`` (an external installation in the reference s2p) and any
    unknown name, with the JAX package's messages."""
    if algo == 'micmac':
        raise NotImplementedError(MICMAC_MESSAGE)
    if algo not in MATCHERS:
        raise NotImplementedError(f'unknown matching algorithm {algo!r}')


class MaxDisparityRangeError(Exception):
    pass


def mgm_variant_from_cfg(cfg: Config) -> MgmVariant:
    """The mgm binary's invocation contract: penalties 8/32 scaled by
    ``stereo_regularity_multiplier``, the config's direction count and
    census window, the left-right test from ``mgm_leftright_control``."""
    mult = cfg.stereo_regularity_multiplier
    return MgmVariant(
        p1=8.0 * mult,
        p2=32.0 * mult,
        nb_dir=cfg.mgm_nb_directions,
        census_win=cfg.census_ncc_win,
        lr_enabled=cfg.mgm_leftright_control != 0,
        lr_tau=cfg.mgm_leftright_threshold,
    )


def _laplacian(img):
    """Laplacian-of-gaussian prefilter (sigma 1), NaN where the input is
    not finite."""
    from scipy.ndimage import gaussian_laplace
    out = gaussian_laplace(np.nan_to_num(img), sigma=1.0)
    out[~np.isfinite(img)] = np.nan
    return out


def _cauchy_prefilter(img, scale=32.0):
    """Cauchy influence prefilter: compresses large intensity excursions
    around the image's median."""
    med = np.nanmedian(img)
    out = scale * np.arctan((img - med) / scale)
    return out.astype(np.float32)


def compute_disparity_map(cfg: Config, im1, im2, disp_min=None,
                          disp_max=None, algo=None, max_disp_range=None,
                          device=None):
    """Run the configured matcher on one rectified pair.

    Args:
        im1, im2: rectified pair (2D float arrays, NaN outside the domain).
        disp_min, disp_max: disparity search bounds, clamped and rounded
            by :func:`clamp_disparity_range`.
        device: None for CUDA (raises without it), or "cpu".
    Returns:
        (disp, mask, confidence): numpy float32 disparity (NaN invalid),
        the uint8 validity mask and the float32 consensus confidence, None
        for the matchers without one (the SGBM ones, ``hirschmuller02``,
        ``msmw*`` and ``tvl1``).  ``micmac`` and unknown names raise
        (:func:`check_matcher`)."""
    algo = algo or cfg.matching_algorithm
    im1 = np.asarray(im1, dtype=np.float32)
    im2 = np.asarray(im2, dtype=np.float32)
    disp_min, disp_max = clamp_disparity_range(cfg, im1.shape[1], disp_min,
                                               disp_max, max_disp_range)
    check_matcher(algo)
    if algo == 'hirschmuller02' or algo in MSMW_MATCHERS:
        # correlation stereo; hirschmuller02 behind a LoG prefilter (the
        # reference's BoofCV subpix.sh contract)
        if algo == 'hirschmuller02':
            im1, im2 = _laplacian(im1), _laplacian(im2)
        disp, valid = msmw.disparity(im1, im2, disp_min, disp_max,
                                     device=device)
        return finalize_disparity(disp, valid, im1, im2) + (None,)
    if algo == 'tvl1':
        disp, valid = tvl1.disparity(im1, im2, device=device)
        return finalize_disparity(disp, valid, im1, im2) + (None,)
    if algo in SGBM_MATCHERS:
        # OpenCV-style SGBM: Birchfield-Tomasi over a 3x3 block, P1/P2
        # 8/32 times the block area, parabola subpixel, uniqueness ratio
        # 10, no median, then the speckle filter (50 px, range 1)
        if algo == 'hirschmuller08_laplacian':
            im1, im2 = _laplacian(im1), _laplacian(im2)
        elif algo == 'hirschmuller08_cauchy':
            im1, im2 = _cauchy_prefilter(im1), _cauchy_prefilter(im2)
        params = SgmParams(census_win=3, cost='bt', p1=8.0 * 9, p2=32.0 * 9,
                           nb_dir=8, subpix='parabola', median=False,
                           lr_tau=1.0, lr_enabled=True, uniqueness_ratio=10.0)
        disp, valid, _ = match_pair(im1, im2, disp_min, disp_max, params,
                                    device=device)
        valid = remove_small_disparity_speckles(
            np.nan_to_num(disp), valid, 50, tol=1.0)
        disp = np.where(valid, disp, np.nan)
        return finalize_disparity(disp, valid, im1, im2) + (None,)
    variant = mgm_variant_from_cfg(cfg)
    if algo == 'mgm':
        disp, conf = mgm_binary_match(im1, im2, disp_min, disp_max, variant,
                                      device=device)
        disp = disp.cpu().numpy()
        return finalize_disparity(disp, np.isfinite(disp), im1, im2) + (
            conf.cpu().numpy(),)
    # the mgm_multi binary's contract: the -S 6 cascade with half-pixel
    # candidates, no median, the speckle filter on the result; the lsd
    # variant lowers P2 on line segments (weight maps of both images),
    # raises P1/P2 to 12/48 and runs the median before the LR test
    runner.checkpoint()
    kw = {'median_order': 'none'}
    p2_map = p2_map_r = None
    if algo == 'mgm_multi_lsd':
        mult = cfg.stereo_regularity_multiplier
        kw = {'median_order': 'before_lr', 'p1': 12.0 * mult,
              'p2': 48.0 * mult}
        p2_map = lsd_weights(im1) * kw['p2']
        p2_map_r = lsd_weights(im2) * kw['p2']
    disp, conf = mgm_multi_match(im1, im2, disp_min, disp_max,
                                 dataclasses.replace(variant, **kw),
                                 scales=6, subpix=2, p2_map=p2_map,
                                 p2_map_r=p2_map_r, device=device)
    disp = disp.cpu().numpy()
    valid = np.isfinite(disp)
    if cfg.stereo_speckle_filter:
        valid = remove_small_disparity_speckles(
            np.nan_to_num(disp), valid, cfg.stereo_speckle_filter, tol=1.0)
        disp = np.where(valid, disp, np.nan)
    return finalize_disparity(disp, valid, im1, im2) + (conf.cpu().numpy(),)


def finalize_disparity(disp, valid, im1, im2):
    """Rejection mask: matched AND finite in both input images."""
    mask = valid.astype(bool) & np.isfinite(im1)
    xs = np.arange(im1.shape[1])[None, :] + np.nan_to_num(disp)
    xs_i = np.clip(np.round(xs).astype(np.int64), 0, im2.shape[1] - 1)
    im2_pull = np.take_along_axis(im2, xs_i, axis=1)
    mask &= np.isfinite(im2_pull)
    disp = np.where(mask, disp, np.nan)
    return disp.astype(np.float32), mask.astype(np.uint8)


def clamp_disparity_range(cfg: Config, width, disp_min, disp_max,
                          max_disp_range=None):
    """Range clamping and rounding, and the MaxDisparityRangeError guard
    (reference block_matching.py:61-84)."""
    if disp_min is not None and disp_max is not None:
        if disp_max - disp_min > width:
            center = 0.5 * (disp_min + disp_max)
            disp_min = int(center - 0.5 * width)
            disp_max = int(center + 0.5 * width)
    if disp_min is not None:
        disp_min = int(np.floor(disp_min))
    if disp_max is not None:
        disp_max = int(np.ceil(disp_max))
    max_disp_range = (max_disp_range if max_disp_range is not None
                      else cfg.max_disp_range)
    if max_disp_range is not None and disp_max - disp_min > max_disp_range:
        raise MaxDisparityRangeError(
            'Disparity range [{}, {}] greater than {}'.format(
                disp_min, disp_max, max_disp_range))
    return disp_min, disp_max
