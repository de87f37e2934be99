"""Stage-4 matching: the mgm variant of a config, the disparity range
policy, the rejection mask and the single-pair matcher dispatch.

Counterpart of ``mgm_variant_from_cfg``, ``compute_disparity_map`` (for
``mgm``), ``finalize_disparity``, ``clamp_disparity_range`` and
``MaxDisparityRangeError`` in ``s2p_tpu/core/matching.py``.  The other
matchers are not ported yet (ROADMAP M12).
"""

from __future__ import annotations

import numpy as np

from ..config import Config
from ..ops.mgm_flow import MgmVariant, mgm_binary_match


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
        confidence.  Only ``mgm`` is ported; any other matcher raises."""
    algo = algo or cfg.matching_algorithm
    im1 = np.asarray(im1, dtype=np.float32)
    im2 = np.asarray(im2, dtype=np.float32)
    disp_min, disp_max = clamp_disparity_range(cfg, im1.shape[1], disp_min,
                                               disp_max, max_disp_range)
    if algo != 'mgm':
        raise NotImplementedError(
            f'matcher {algo!r} is not ported yet (ROADMAP M12); the port '
            'runs mgm')
    disp, conf = mgm_binary_match(im1, im2, disp_min, disp_max,
                                  mgm_variant_from_cfg(cfg), device=device)
    disp = disp.cpu().numpy()
    return finalize_disparity(disp, np.isfinite(disp), im1, im2) + (
        conf.cpu().numpy(),)


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
