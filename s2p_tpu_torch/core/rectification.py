"""Epipolar rectification of RPC image pairs.

The port's copy of ``s2p_tpu/core/rectification.py``: functional parity
with the reference s2p ``rectification.py`` (cited inline), reorganized
around in-memory arrays: ``rectify_pair`` returns the two rectified crops
instead of writing temp TIFFs, and the dense warp runs on the card (W1,
:func:`s2p_tpu_torch.ops.interp.warp_homography`) instead of shelling out
to the ``homography`` binary.  The geometry is host numpy in float64.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..config import Config
from ..ops.homography import (bounding_box2D, image_apply_homographies,
                              matrix_translation, points_apply_homography)
from . import estimation, rpc_geom
from .evaluation import distances_points_to_lines


class NoRectificationMatchesError(Exception):
    pass


class NoHorizontalRegistrationWarning(Warning):
    pass


def filter_matches_epipolar_constraint(F, matches, thresh):
    """Keep matches within ``thresh`` of their epipolar lines.

    Parity: reference rectification.py:27-50 (max of the two symmetric
    distances), vectorized.
    """
    matches = np.asarray(matches, dtype=np.float64)
    if len(matches) == 0:
        return matches
    F = np.asarray(F, dtype=np.float64)
    p1 = np.hstack([matches[:, 0:2], np.ones((len(matches), 1))])
    p2 = np.hstack([matches[:, 2:4], np.ones((len(matches), 1))])
    d1 = distances_points_to_lines(matches[:, 0:2], p2 @ F)        # lines F^T x'
    d2 = distances_points_to_lines(matches[:, 2:4], p1 @ F.T)      # lines F x
    return matches[np.maximum(d1, d2) < thresh]


def register_horizontally_shear(matches, H1, H2):
    """Compose H2 with the least-squares tilt/shear/translation that sends
    the matches' disparities to zero.  Parity: reference rectification.py:53-86.
    """
    p1 = points_apply_homography(H1, matches[:, :2])
    p2 = points_apply_homography(H2, matches[:, 2:])
    x1 = p1[:, 0]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = np.column_stack([x2, y2, np.ones_like(x2)])
    a, b, c = np.linalg.lstsq(A, x1, rcond=None)[0]
    return np.array([[a, b, c], [0, 1, 0], [0, 0, 1]]) @ H2


def register_horizontally_translation(matches, H1, H2, flag='center'):
    """Compose H2 with a horizontal translation shaping the disparity range.

    Parity: reference rectification.py:89-134 ('center' zero-mean,
    'positive', 'negative').
    """
    p1 = points_apply_homography(H1, matches[:, :2])
    p2 = points_apply_homography(H2, matches[:, 2:])
    disp = p2[:, 0] - p1[:, 0]
    t = {'center': np.mean, 'positive': np.min, 'negative': np.max}[flag](disp)
    return matrix_translation(-t, 0) @ H2


def disparity_range_from_matches(matches, H1, H2, disp_range_extra_margin=0.2):
    """Disparity extrema of the matches plus a relative security margin.

    Parity: reference rectification.py:137-166.
    """
    x1 = points_apply_homography(H1, matches[:, :2])[:, 0]
    x2 = points_apply_homography(H2, matches[:, 2:])[:, 0]
    disp_min = np.floor(np.min(x2 - x1))
    disp_max = np.ceil(np.max(x2 - x1))
    disp_min -= (disp_max - disp_min) * disp_range_extra_margin
    disp_max += (disp_max - disp_min) * disp_range_extra_margin
    return disp_min, disp_max


def disparity_range(cfg: Config, rpc1, rpc2, x, y, w, h, H1, H2, matches, A=None):
    """Choose the disparity search range according to cfg.disp_range_method.

    Parity: reference rectification.py:169-239 (all five policies, the
    minimal +-3 px floor, and the wider-of-both combination rule).
    """
    method = cfg.disp_range_method
    alt_kwargs = dict(exogenous_dem=cfg.exogenous_dem,
                      exogenous_dem_geoid_mode=cfg.exogenous_dem_geoid_mode,
                      use_srtm=cfg.use_srtm,
                      rpc_alt_range_scale_factor=cfg.rpc_alt_range_scale_factor)

    exogenous_disp = None
    if method in ('exogenous', 'wider_sift_exogenous'):
        exogenous_disp = rpc_geom.exogenous_disp_range_estimation(
            rpc1, rpc2, x, y, w, h, H1, H2, A,
            cfg.disp_range_exogenous_high_margin,
            cfg.disp_range_exogenous_low_margin, **alt_kwargs)

    sift_disp = None
    if method in ('sift', 'wider_sift_exogenous'):
        if matches is not None and len(matches) >= 2:
            sift_disp = disparity_range_from_matches(
                matches, H1, H2, cfg.disp_range_extra_margin)

    if method == 'exogenous':
        disp = exogenous_disp
    elif method == 'sift':
        disp = sift_disp
    elif method == 'wider_sift_exogenous':
        if sift_disp is not None and exogenous_disp is not None:
            disp = (min(exogenous_disp[0], sift_disp[0]),
                    max(exogenous_disp[1], sift_disp[1]))
        else:
            disp = sift_disp or exogenous_disp
    elif method == 'fixed_altitude_range':
        disp = rpc_geom.altitude_range_to_disp_range(
            cfg.alt_min, cfg.alt_max, rpc1, rpc2, x, y, w, h, H1, H2, A)
    elif method == 'fixed_pixel_range':
        disp = (cfg.disp_min, cfg.disp_max)
    else:
        raise ValueError(f'unknown disp_range_method {method!r}')

    if disp is None:
        disp = (-3, 3)
    return min(-3, disp[0]), max(3, disp[1])


def rectification_homographies(matches, x, y, w, h, debug=False):
    """Affine F + rectifying similarities + origin normalization for a ROI.

    Parity: reference rectification.py:242-278 (golden-tested against
    tests/data/expected_output/units/{H1,H2,F}.txt).
    """
    F = estimation.affine_fundamental_matrix(matches)
    S1, S2 = estimation.rectifying_similarities_from_affine_fundamental_matrix(F, debug)
    # move the ROI's top-left corner (under S1) to the origin
    roi = [[x, y], [x + w, y], [x + w, y + h], [x, y + h]]
    pts = points_apply_homography(S1, roi)
    x0, y0 = bounding_box2D(pts)[:2]
    T = matrix_translation(-x0, -y0)
    return T @ S1, T @ S2, F


def rectify_pair_geometry(cfg: Config, rpc1, rpc2, x, y, w, h, A=None,
                          sift_matches=None, method='rpc', hmargin=0,
                          vmargin=0):
    """Host-side half of :func:`rectify_pair`: the rectifying homographies,
    disparity range, and output size -- everything except the dense warps.
    Lets a batched driver run ALL tiles' warps in batches
    (pipeline.rectification_all).

    Returns:
        (H1, H2, disp_min, disp_max, out_w, out_h).

    Parity: reference rectification.py:281-369 (everything before the two
    subprocess warps).
    """
    alt_kwargs = dict(exogenous_dem=cfg.exogenous_dem,
                      exogenous_dem_geoid_mode=cfg.exogenous_dem_geoid_mode,
                      use_srtm=cfg.use_srtm,
                      rpc_alt_range_scale_factor=cfg.rpc_alt_range_scale_factor)

    if method == 'rpc':
        matches = rpc_geom.matches_from_rpc(rpc1, rpc2, x, y, w, h,
                                            cfg.n_gcp_per_axis, **alt_kwargs)
        if A is not None:
            matches[:, 2:] = points_apply_homography(np.linalg.inv(A), matches[:, 2:])
    elif method == 'sift':
        matches = sift_matches
    else:
        raise ValueError(f"unknown rectification method {method!r}")

    if matches is None or len(matches) < 4:
        raise NoRectificationMatchesError(
            'No or not enough matches found to rectify image pair')

    H1, H2, F = rectification_homographies(matches, x, y, w, h, cfg.debug)

    if cfg.register_with_shear:
        # shear registration on an RPC grid at the mean altitude
        # (reference rectification.py:330-340)
        a = np.mean(rpc_geom.altitude_range(rpc1, x, y, w, h, **alt_kwargs))
        lon, lat, alt = rpc_geom.ground_control_points(rpc1, x, y, w, h, a, a, 4)
        x1, y1 = rpc1.projection(lon, lat, alt)
        x2, y2 = rpc2.projection(lon, lat, alt)
        m = np.unique(np.vstack([x1, y1, x2, y2]).T, axis=0)
        H2 = register_horizontally_shear(m, H1, H2)

    if sift_matches is not None:
        sift_matches = filter_matches_epipolar_constraint(
            F, sift_matches, cfg.epipolar_thresh)
        if len(sift_matches) < 1:
            warnings.warn('Need at least one sift match for the horizontal '
                          'registration', category=NoHorizontalRegistrationWarning)
            sift_matches = None
        else:
            H2 = register_horizontally_translation(sift_matches, H1, H2)

    disp_m, disp_M = disparity_range(cfg, rpc1, rpc2, x, y, w, h, H1, H2,
                                     sift_matches, A)

    # enlarge the horizontal margin to cover the disparity range
    # (reference rectification.py:365-369)
    hmargin = int(np.ceil(max(hmargin, np.fabs(disp_m), np.fabs(disp_M))))
    T = matrix_translation(hmargin, vmargin)
    H1, H2 = T @ H1, T @ H2

    roi = [[x, y], [x + w, y], [x + w, y + h], [x, y + h]]
    pts1 = points_apply_homography(H1, roi)
    x0, y0, w0, h0 = bounding_box2D(pts1)
    np.testing.assert_allclose(np.round([x0, y0]), [hmargin, vmargin], atol=.01)

    out_w = int(w0 + 2 * hmargin)
    out_h = int(h0 + 2 * vmargin)
    return H1, H2, disp_m, disp_M, out_w, out_h


def rectify_pair(cfg: Config, im1, im2, rpc1, rpc2, x, y, w, h, A=None,
                 sift_matches=None, method='rpc', hmargin=0, vmargin=0,
                 device=None):
    """Rectify the ROI of an image pair.

    Args:
        cfg: pipeline configuration.
        im1, im2: full reference/secondary images as 2D numpy arrays.
        rpc1, rpc2: RPC models.
        x, y, w, h: ROI in the reference image.
        A: optional pointing correction for image 2.
        sift_matches: (n, 4) matches in full-image coordinates.
        method: 'rpc' (virtual matches) or 'sift'.
        hmargin, vmargin: margins around the rectified crops.
        device: where the warps run; None is CUDA (raises without it),
            "cpu" the plain version.

    Returns:
        (rect1, rect2, H1, H2, disp_min, disp_max): the two rectified float32
        arrays (same size) and the homographies applied to the full images.

    Parity: reference rectification.py:281-382, with the two subprocess
    warps replaced by W1.
    """
    H1, H2, disp_m, disp_M, out_w, out_h = rectify_pair_geometry(
        cfg, rpc1, rpc2, x, y, w, h, A=A, sift_matches=sift_matches,
        method=method, hmargin=hmargin, vmargin=vmargin)
    rect1, rect2 = image_apply_homographies(
        [(im1, H1, out_w, out_h), (im2, H2, out_w, out_h)], device=device)
    return rect1, rect2, H1, H2, disp_m, disp_M
