"""Pointing-error correction: the global fit of stage 2.

Satellite attitude errors displace the second image by a few pixels
against the epipolar geometry that the RPCs predict; stage 1 measures
this per tile with keypoint matches (``pointing.txt`` and
``center_keypts_sec.txt``), and stage 2 fits one planar transform to all
tiles.  A numpy copy of ``global_from_local`` in
``s2p_tpu/core/pointing.py`` (parity: the reference s2p
``pointing_accuracy.py``:135-176); stage 1's functions wait for the
port of SIFT.
"""

from __future__ import annotations

import numpy as np

from . import estimation


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
