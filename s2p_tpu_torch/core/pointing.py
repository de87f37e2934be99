"""Pointing-error correction: stage 1's local fit and stage 2's global
fit.

Satellite attitude errors displace the second image by a few pixels
against the epipolar geometry that the RPCs predict; stage 1 measures
this per tile with keypoint matches (``pointing.txt`` and
``center_keypts_sec.txt``), and stage 2 fits one planar transform to all
tiles.  A numpy copy of ``s2p_tpu/core/pointing.py`` (parity: the
reference s2p ``pointing_accuracy.py``).
"""

from __future__ import annotations

import numpy as np

from . import estimation, rpc_geom


def error_vectors(m, F, ind='ref'):
    """Epipolar error vectors of matches under a fundamental matrix: for
    each match, the vector from the projection of the point onto its
    epipolar line to the point itself."""
    m = np.asarray(m, dtype=np.float64)
    N = len(m)
    x = np.column_stack([m[:, 0:2], np.ones(N)])
    xx = np.column_stack([m[:, 2:4], np.ones(N)])
    F = np.asarray(F, dtype=np.float64)

    if ind == 'sec':
        lines = x @ F.T
        pts = xx
    elif ind == 'ref':
        lines = xx @ F
        pts = x
    else:
        raise ValueError("ind must be 'ref' or 'sec'")

    num = np.sum(pts[:, :2] * lines[:, :2], axis=1) + lines[:, 2]
    den = lines[:, 0] ** 2 + lines[:, 1] ** 2
    a = num / den
    return np.column_stack([a * lines[:, 0], a * lines[:, 1]])


def local_translation(r1, r2, x, y, w, h, m, n_gcp_per_axis=5, **alt_kwargs):
    """Optimal translation correcting the pointing error on a tile: the
    component-wise median of the error vectors, which is exact because
    affine-F error vectors are collinear (the sort-based upper median,
    as the reference takes it)."""
    rpc_matches = rpc_geom.matches_from_rpc(r1, r2, x, y, w, h,
                                            n_gcp_per_axis, **alt_kwargs)
    F = estimation.affine_fundamental_matrix(rpc_matches)
    e = error_vectors(m, F, 'sec')
    N = len(e)
    out_x = np.sort(e[:, 0])[N // 2]
    out_y = np.sort(e[:, 1])[N // 2]
    return np.array([[1, 0, -out_x], [0, 1, -out_y], [0, 0, 1]])


def compute_correction(img1, img2, rpc1, rpc2, x, y, w, h, method,
                       sift_thresh, epipolar_threshold, n_gcp_per_axis=5,
                       device=None, **alt_kwargs):
    """SIFT matches + pointing translation for a tile pair.

    Args:
        img1, img2: full image arrays (numpy) for keypoint extraction.
        device: where SIFT runs (None: CUDA).

    Returns:
        (A, m): 3x3 correction for image 2 (or None) and the matches used.
    """
    from ..ops import sift as sift_ops

    m = sift_ops.matches_on_rpc_roi(img1, img2, rpc1, rpc2, x, y, w, h,
                                    method, sift_thresh, epipolar_threshold,
                                    device=device, **alt_kwargs)
    if m is None:
        return None, None
    A = local_translation(rpc1, rpc2, x, y, w, h, m, n_gcp_per_axis,
                          **alt_kwargs)
    return A, m


def global_from_local(corrections):
    """Fit one global transform from per-tile local corrections.

    Args:
        corrections: list of (A, center) pairs where A is the 3x3 local
            correction of a tile and center the mean secondary keypoint.

    Returns:
        3x3 transform: identity / the single correction / a translation fit
        (2 tiles) / an affine fit (>= 3 tiles).
    """
    x = []
    xx = []
    last_A = None
    for A, p in corrections:
        A = np.asarray(A, dtype=np.float64)
        p = np.asarray(p, dtype=np.float64)
        if A.shape == (3, 3) and p.shape == (2,):
            q = A @ np.array([p[0], p[1], 1.0])
            x.append(p)
            xx.append(q[:2])
            last_A = A
    if not x:
        return np.eye(3)
    if len(x) == 1:
        return last_A
    if len(x) == 2:
        return estimation.translation(np.array(x), np.array(xx))
    return estimation.affine_transformation(np.array(x), np.array(xx))
