"""Homography algebra and image warps.

The port's counterpart of ``s2p_tpu/ops/homography.py``.  The host
helpers are numpy float64 (applied to small point sets); the dense warp
is :func:`s2p_tpu_torch.ops.interp.warp_homography`, W1 on the card and
its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from .interp import warp_dilate, warp_homography

# jobs of one launch: bounds the device memory of a group's output
MAX_JOBS = 64


def matrix_translation(x, y):
    """3x3 translation matrix (parity: reference common.py:97-101)."""
    t = np.eye(3)
    t[0, 2] = x
    t[1, 2] = y
    return t


def points_apply_homography(H, pts):
    """Apply a 3x3 homography to an (n, 2) list of points.

    Parity: reference common.py:183-211.
    """
    pts = np.asarray(pts, dtype=np.float64)
    if pts.ndim == 1:
        pts = pts[None, :]
    ones = np.ones((len(pts), 1))
    hp = np.hstack([pts[:, :2], ones]) @ np.asarray(H, dtype=np.float64).T
    return hp[:, :2] / hp[:, 2:3]


def bounding_box2D(pts):
    """(xmin, ymin, width, height) of a point list (common.py:214-221)."""
    pts = np.asarray(pts, dtype=np.float64)
    mins = pts.min(axis=0)
    maxs = pts.max(axis=0)
    return mins[0], mins[1], maxs[0] - mins[0], maxs[1] - mins[1]


def _spline5_inputs(img):
    """Host-side quintic spline prefilter (separable IIR, scipy) + NaN mask.

    The IIR prefilter would smear NaNs over whole rows/columns, so NaNs are
    zero-filled for filtering and tracked in a mask that the sampler uses
    to re-invalidate any output whose 6x6 support touches one.
    """
    from scipy import ndimage
    img = np.asarray(img, dtype=np.float32)
    nan = ~np.isfinite(img)
    coeffs = ndimage.spline_filter(np.nan_to_num(img), order=5,
                                   mode='mirror', output=np.float32)
    mask = nan.astype(np.float32) if nan.any() else None
    return coeffs, mask


def _inverse_f32(H):
    return np.linalg.inv(np.asarray(H, dtype=np.float64)).astype(np.float32)


def warp_jobs_batched(jobs, order=5, device=None):
    """Warp many (img, H, w, h) jobs; returns (h, w) float32 arrays in job
    order.

    The spline prefilter runs once per distinct source array (by
    identity), its coefficients are uploaded once and, on the card, its
    NaN mask is dilated once for W1 (:func:`warp_dilate`).  Jobs sharing a
    source and an output bucket (h up to a multiple of 64, w up to a
    multiple of 128) run as one warp of up to :data:`MAX_JOBS`
    homographies, and each output is cropped to its own (h, w).  The warp
    is pointwise in output pixels, so the padding and the batch change no
    value: each output equals :func:`image_apply_homography` of its job.
    ``device`` None runs on CUDA (W1) and raises without it; "cpu" runs
    the plain version."""
    dev = resolve(device)
    jobs = list(jobs)
    srcs = {}
    for img, _, _, _ in jobs:
        if id(img) in srcs:
            continue
        if order == 5:
            coeffs, mask = _spline5_inputs(img)
        else:
            coeffs, mask = np.asarray(img, dtype=np.float32), None
        coeffs = torch.from_numpy(np.ascontiguousarray(coeffs)).to(dev)
        if mask is not None:
            mask = torch.from_numpy(mask).to(dev)
        # W1 reads the mask dilated, once per source; the CPU route reads
        # the mask itself
        dilated = (warp_dilate(mask) if mask is not None
                   and dev.type == 'cuda' else None)
        srcs[id(img)] = (coeffs, mask, dilated)
    groups = {}
    for k, (img, H, w, h) in enumerate(jobs):
        hb = -(-int(h) // 64) * 64
        wb = -(-int(w) // 128) * 128
        groups.setdefault((id(img), hb, wb), []).append((k, _inverse_f32(H)))
    outs = [None] * len(jobs)
    for (key, hb, wb), members in groups.items():
        coeffs, mask, dilated = srcs[key]
        for i in range(0, len(members), MAX_JOBS):
            part = members[i:i + MAX_JOBS]
            hinvs = torch.from_numpy(np.stack([hv for _, hv in part])).to(dev)
            out = warp_homography(coeffs, hinvs, wb, hb, order=order,
                                  nanmask=mask, dilated=dilated)
            for row, (k, _) in enumerate(part):
                outs[k] = out[row]
    return [o[:int(h), :int(w)].cpu().numpy()
            for o, (_, _, w, h) in zip(outs, jobs)]


def image_apply_homography(img, H, w, h, order=5, device=None):
    """Warp an image array under homography H to a (h, w) output:
    out(x) = img(H^-1 x), the in-memory equivalent of the reference's
    ``homography`` binary (common.py:159-180)."""
    return warp_jobs_batched([(img, H, w, h)], order, device)[0]


def image_apply_homographies(jobs, order=5, device=None):
    """Warp a list of (img, H, w, h) jobs; returns a list of numpy arrays.
    The JAX package dispatches these one warp at a time; here they go
    through :func:`warp_jobs_batched`, which gives the same values."""
    return warp_jobs_batched(jobs, order, device)
