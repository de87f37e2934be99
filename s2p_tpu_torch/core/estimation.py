"""Closed-form geometric estimation (Hartley & Zisserman algorithms).

Host-side float64 numpy: these solves run on tiny point sets (tens to
hundreds of matches per tile), so they stay off-device; their outputs
(3x3 matrices) parameterize the device-side warps.

A numpy copy of ``s2p_tpu/core/estimation.py`` (the port imports nothing
of the JAX package); the same algorithms and conventions as the reference
s2p ``estimation.py``, whose lines each function cites.
"""

from __future__ import annotations

import numpy as np


def fundamental_matrix_cameras(P1, P2):
    """F from two 3x4 camera matrices (H&Z 2nd ed., formula 17.3).

    Parity: reference estimation.py:9-38.
    """
    F = np.empty((3, 3))
    rows1 = [P1[[1, 2]], P1[[2, 0]], P1[[0, 1]]]
    rows2 = [P2[[1, 2]], P2[[2, 0]], P2[[0, 1]]]
    for i in range(3):
        for j in range(3):
            F[i, j] = np.linalg.det(np.vstack([rows1[j], rows2[i]]))
    return F


def affine_fundamental_matrix(matches):
    """Affine F from >=4 correspondences, Gold Standard (H&Z chap. 14).

    Args:
        matches: (n, 4) array of (x1, y1, x2, y2) correspondences.

    Returns:
        3x3 affine fundamental matrix with zero upper-left 2x2 block.

    Parity: reference estimation.py:114-154 (including the H&Z algo-14.1
    column ordering x', y', x, y of the design matrix).
    """
    X = np.asarray(matches, dtype=np.float64)[:, [2, 3, 0, 1]]
    centroid = X.mean(axis=0)
    A = X - centroid
    # null vector = right singular vector with the smallest singular value
    nvec = np.linalg.svd(A)[2][-1]
    F = np.zeros((3, 3))
    F[0, 2], F[1, 2] = nvec[0], nvec[1]
    F[2, 0], F[2, 1] = nvec[2], nvec[3]
    F[2, 2] = -nvec @ centroid
    return F


def rectifying_similarities_from_affine_fundamental_matrix(F, debug=False):
    """Two rectifying similarities S1, S2 from an affine F.

    After resampling with S1 (reference image) and S2 (secondary image), the
    epipolar lines of the pair become horizontal and aligned.

    Parity: reference estimation.py:51-111 (Loop-Zhang style closed form for
    the affine case: rotations from the epipolar directions, reciprocal
    zooms sqrt(r/s), opposite half vertical offsets e/(2 sqrt(rs))).
    """
    F = np.asarray(F, dtype=np.float64)
    assert F.shape == (3, 3)
    assert np.linalg.matrix_rank(F) == 2
    np.testing.assert_allclose(F[:2, :2], np.zeros((2, 2)))

    a, b = F[0, 2], F[1, 2]
    c, d = F[2, 0], F[2, 1]
    e = F[2, 2]

    r = np.hypot(c, d)
    s = np.hypot(a, b)
    R1 = np.array([[d, -c], [c, d]]) / r
    R2 = np.array([[-b, a], [-a, -b]]) / s
    z = np.sqrt(r / s)
    t = 0.5 * e / np.sqrt(r * s)

    S1 = np.eye(3)
    S1[:2, :2] = z * R1
    S1[1, 2] = t
    S2 = np.eye(3)
    S2[:2, :2] = R2 / z
    S2[1, 2] = -t
    return S1, S2


def affine_transformation(x, xx):
    """Affine homography mapping points x -> xx, Gold Standard (H&Z p.130).

    Args:
        x, xx: (n, 2) arrays of corresponding points (n >= 3).

    Returns:
        3x3 homogeneous affine transform.

    Parity: reference estimation.py:157-205.
    """
    x = np.asarray(x, dtype=np.float64)
    xx = np.asarray(xx, dtype=np.float64)
    if len(x) < 3:
        print('ERROR: estimation.affine_transformation needs 3 correspondences')
        return np.eye(3)

    t = -x.mean(axis=0)
    tt = -xx.mean(axis=0)
    A = np.hstack([x + t, xx + tt])

    # the two dominant right singular vectors span the graph of the linear map
    V = np.linalg.svd(A)[2]
    basis = V[:2].T          # (4, 2)
    B, C = basis[:2], basis[2:]
    H = C @ np.linalg.inv(B)

    out = np.eye(3)
    out[:2, :2] = H
    out[:2, 2] = H @ t - tt
    return out


def translation(x, xx):
    """Mean-displacement translation mapping x -> xx.

    Parity: reference estimation.py:208-227.
    """
    t = np.mean(np.asarray(xx, dtype=np.float64)
                - np.asarray(x, dtype=np.float64), axis=0)
    A = np.eye(3)
    A[:2, 2] = t
    return A
