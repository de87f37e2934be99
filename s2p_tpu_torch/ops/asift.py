"""Affine-SIFT (ASIFT): affine-invariant keypoints by tilt simulation.

Counterpart of ``s2p_tpu/ops/asift.py``.  The reference s2p vendors the
IPOL ASIFT demo as an optional tool that its Python layer never wires in;
this is the same algorithm (Morel-Yu 2009) over the port's SIFT: simulate
camera tilts t = 2^(k/2) with rotations phi sampled at 72deg/t, run SIFT
on each simulated view (:func:`sift.keypoints_from_array`, on the route
:func:`sift.set_device_mode` selects), and map the keypoints back through
the inverse affine transform.  Descriptors stay comparable across views,
so the ratio-test matcher applies to the concatenated sets.  The view
simulation is host scipy, copied from the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

from . import sift


def _simulate(img, t, phi_deg):
    """Affine view simulation: rotate by phi, then tilt (x-compression by t
    after an anti-aliasing blur along x), per the ASIFT paper.

    Returns (view, A) with A the 2x3 affine mapping ORIGINAL -> VIEW
    pixel coordinates.
    """
    from scipy import ndimage

    h, w = img.shape
    phi = math.radians(phi_deg)
    c, s = math.cos(phi), math.sin(phi)
    R = np.array([[c, -s], [s, c]])
    corners = np.array([[0, 0], [w, 0], [0, h], [w, h]], float) @ R.T
    lo = corners.min(axis=0)
    T = np.array([[1, 0], [0, 1 / t]]) @ R
    off = -np.array([lo[0], lo[1] / t])
    hi = (corners.max(axis=0) - lo)
    out_w = int(math.ceil(hi[0]))
    out_h = int(math.ceil(hi[1] / t))

    # output(y, x) = img(Minv @ (x, y) - ...): build the inverse map
    Tinv = np.linalg.inv(T)
    yy, xx = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    src = np.einsum('ij,jhw->ihw', Tinv,
                    np.stack([xx - off[0], yy - off[1]]))
    # anti-alias along the compressed direction before sampling
    if t > 1:
        sigma = 0.8 * math.sqrt(t * t - 1)
        gy = R[1]  # original-image direction that gets compressed
        blurred = ndimage.gaussian_filter(
            np.nan_to_num(img), sigma=(abs(gy[1]) * sigma, abs(gy[0]) * sigma),
            mode='nearest')
    else:
        blurred = np.nan_to_num(img)
    view = ndimage.map_coordinates(blurred, [src[1], src[0]], order=1,
                                   cval=np.nan)
    A = np.hstack([T, off[:, None]])
    return view.astype(np.float32), A


def keypoints(img, n_tilts=3, thresh_dog=0.0133, n_octaves=8, n_scales=3,
              device=None):
    """ASIFT keypoints: (n, 132) rows (x, y, scale, orientation, 128-desc)
    in ORIGINAL image coordinates, concatenated over the simulated views
    (tilt t=1 is plain SIFT).  ``device`` (None: CUDA) is where the device
    route runs SIFT."""
    img = np.asarray(img, dtype=np.float32)
    rows = []
    for k in range(n_tilts):
        t = 2.0 ** (0.5 * k)
        phis = [0.0] if t == 1.0 else \
            list(np.arange(0.0, 180.0, 72.0 / t))
        for phi in phis:
            view, A = _simulate(img, t, phi)
            if min(view.shape) < 32:
                continue
            kp = sift.keypoints_from_array(view, thresh_dog, n_octaves,
                                           n_scales, device=device)
            if len(kp) == 0:
                continue
            # map positions back: x_orig = Ainv @ (x_view - off)
            M = A[:, :2]
            Minv = np.linalg.inv(M)
            xy = (kp[:, :2] - A[:, 2]) @ Minv.T
            kp = kp.copy()
            kp[:, :2] = xy
            # cull points mapped outside the original domain
            inb = ((xy[:, 0] >= 0) & (xy[:, 0] < img.shape[1])
                   & (xy[:, 1] >= 0) & (xy[:, 1] < img.shape[0]))
            rows.append(kp[inb])
    if not rows:
        return np.zeros((0, 132), np.float32)
    return np.vstack(rows).astype(np.float32)
