"""Geometric evaluation helpers: a numpy copy of
``s2p_tpu/core/evaluation.py`` (parity: the reference s2p
``evaluation.py``)."""

from __future__ import annotations

import numpy as np


def distance_point_to_line(x, l):
    """Distance between a homogeneous 2D point and a homogeneous line.

    Returns the largest float when the point is ideal or the line is the line
    at infinity (parity: reference evaluation.py:8-31).
    """
    x = np.asarray(x, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    eps = np.finfo(float).eps
    if np.abs(x[2]) < eps or np.hypot(l[0], l[1]) < eps:
        return np.finfo(float).max
    return np.abs(x @ l) / (np.hypot(l[0], l[1]) * np.abs(x[2]))


def distances_points_to_lines(pts, lines):
    """Vectorized point-to-epipolar-line distances.

    Args:
        pts: (n, 2) inhomogeneous points.
        lines: (n, 3) homogeneous lines.

    Returns:
        (n,) distances (np.inf where the line is degenerate).
    """
    pts = np.asarray(pts, dtype=np.float64)
    lines = np.asarray(lines, dtype=np.float64)
    num = np.abs(pts[:, 0] * lines[:, 0] + pts[:, 1] * lines[:, 1] + lines[:, 2])
    den = np.hypot(lines[:, 0], lines[:, 1])
    with np.errstate(divide='ignore', invalid='ignore'):
        d = num / den
    d[den < np.finfo(float).eps] = np.inf
    return d
