"""Stage-4 matching: the mgm variant of a config, the disparity range
policy, the rejection mask and the single-pair matcher dispatch.

Counterpart of ``mgm_variant_from_cfg``, ``compute_disparity_map`` (for
``mgm``, ``mgm_multi`` and ``mgm_multi_lsd``), ``finalize_disparity``,
``clamp_disparity_range`` and ``MaxDisparityRangeError`` in
``s2p_tpu/core/matching.py``.  The other matchers are not ported yet
(ROADMAP M12).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import runner
from ..config import Config
from ..ops.lsd import lsd_weights
from ..ops.mgm_flow import MgmVariant, mgm_binary_match, mgm_multi_match
from ..ops.morphology import remove_small_disparity_speckles

MATCHERS = ('mgm', 'mgm_multi', 'mgm_multi_lsd')


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
        (disp, mask, confidence) numpy arrays: float32 disparity (NaN
        invalid), the uint8 validity mask and the float32 consensus
        confidence.  Any matcher but those of ``MATCHERS`` raises."""
    algo = algo or cfg.matching_algorithm
    im1 = np.asarray(im1, dtype=np.float32)
    im2 = np.asarray(im2, dtype=np.float32)
    disp_min, disp_max = clamp_disparity_range(cfg, im1.shape[1], disp_min,
                                               disp_max, max_disp_range)
    if algo not in MATCHERS:
        raise NotImplementedError(
            f'matcher {algo!r} is not ported yet (ROADMAP M12); the port '
            f'runs {", ".join(MATCHERS)}')
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
