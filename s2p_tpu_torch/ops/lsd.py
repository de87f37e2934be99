"""LSD: Line Segment Detector (von Gioi et al., IPOL 2012), on the host.

Counterpart of ``s2p_tpu/ops/lsd.py``, a copy of its numpy/scipy code:
the reference pipes ``qauto | lsd | pview segments | plambda`` to build
the regularization weight maps of ``mgm_multi_lsd``.  Gaussian
downscaling, the 2x2 level-line field, greedy region growing in
decreasing gradient-magnitude order, the rectangle fit with density
refinement and the binomial NFA test, then the segment rasterization
and the plambda weight formula ``max(((255 - v)/255)^2, 0.1)``.

It runs once per tile pair, only for ``mgm_multi_lsd``, on the host: the
region growing is a sequential flood fill over a tile-sized image.
"""

from __future__ import annotations

import math

import numpy as np

_NOTDEF = -1024.0


def _scale_image(img, scale=0.8, sigma_scale=0.6):
    from scipy.ndimage import gaussian_filter, map_coordinates
    if scale >= 1.0:
        return np.asarray(img, np.float64)
    sigma = sigma_scale / scale
    sm = gaussian_filter(np.asarray(img, np.float64), sigma, mode='nearest')
    h, w = img.shape
    nh, nw = int(math.ceil(h * scale)), int(math.ceil(w * scale))
    ys = (np.arange(nh) / scale)[:, None] * np.ones((1, nw))
    xs = np.ones((nh, 1)) * (np.arange(nw) / scale)[None, :]
    return map_coordinates(sm, [ys, xs], order=1, mode='nearest')


def _gradient(img, rho):
    """2x2 gradient scheme; returns (angle, magnitude) with angle =
    level-line angle (atan2(gx, -gy)), NOTDEF below the threshold rho."""
    h, w = img.shape
    gx = np.zeros((h, w))
    gy = np.zeros((h, w))
    a = img[:-1, :-1]
    b = img[:-1, 1:]
    c = img[1:, :-1]
    d = img[1:, 1:]
    gx[:-1, :-1] = 0.5 * ((b + d) - (a + c))
    gy[:-1, :-1] = 0.5 * ((c + d) - (a + b))
    mag = np.hypot(gx, gy)
    ang = np.arctan2(gx, -gy)
    ang[mag < rho] = _NOTDEF
    mag[-1, :] = 0
    mag[:, -1] = 0
    ang[-1, :] = _NOTDEF
    ang[:, -1] = _NOTDEF
    return ang, mag


def _angle_diff(a, b):
    d = a - b
    d = np.where(d <= -np.pi, d + 2 * np.pi, d)
    d = np.where(d > np.pi, d - 2 * np.pi, d)
    return np.abs(d)


_OFFS = np.array([(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                  if (dy, dx) != (0, 0)])


def _grow_region(seed, ang, used, tol):
    """Greedy 8-connected region of pixels whose level-line angle stays
    within ``tol`` of the (running) region angle."""
    h, w = ang.shape
    sy, sx = seed
    theta = ang[sy, sx]
    sx_sum = math.cos(theta)
    sy_sum = math.sin(theta)
    pts = [(sy, sx)]
    used[sy, sx] = True
    i = 0
    while i < len(pts):
        y, x = pts[i]
        i += 1
        for dy, dx in _OFFS:
            yy, xx = y + dy, x + dx
            if yy < 0 or yy >= h or xx < 0 or xx >= w:
                continue
            if used[yy, xx]:
                continue
            a = ang[yy, xx]
            if a == _NOTDEF:
                continue
            d = a - theta
            if d <= -np.pi:
                d += 2 * np.pi
            elif d > np.pi:
                d -= 2 * np.pi
            if abs(d) < tol:
                used[yy, xx] = True
                pts.append((yy, xx))
                sx_sum += math.cos(a)
                sy_sum += math.sin(a)
                theta = math.atan2(sy_sum, sx_sum)
    return pts, theta


def _region_to_rect(pts, mag, theta, prec):
    """Weighted rectangle fit (center of mass + inertia main axis)."""
    pts = np.asarray(pts)
    wgt = mag[pts[:, 0], pts[:, 1]]
    tw = wgt.sum()
    cy = float((pts[:, 0] * wgt).sum() / tw)
    cx = float((pts[:, 1] * wgt).sum() / tw)
    dy = pts[:, 0] - cy
    dx = pts[:, 1] - cx
    ixx = float((wgt * dy * dy).sum() / tw)
    iyy = float((wgt * dx * dx).sum() / tw)
    ixy = -float((wgt * dy * dx).sum() / tw)
    lam = 0.5 * (ixx + iyy - math.sqrt((ixx - iyy) ** 2 + 4 * ixy * ixy))
    if abs(ixx) > abs(iyy):
        ang_rect = math.atan2(lam - ixx, ixy)
    else:
        ang_rect = math.atan2(ixy, lam - iyy)
    # align the rectangle angle with the region's level-line angle
    if _angle_diff(np.array(ang_rect), np.array(theta + math.pi / 2)) \
            > prec:
        ang_rect += math.pi

    ux, uy = math.cos(ang_rect), math.sin(ang_rect)
    l = dx * ux + dy * uy
    t = -dx * uy + dy * ux
    return dict(cx=cx, cy=cy, theta=ang_rect,
                l1=float(l.min()), l2=float(l.max()),
                w1=float(t.min()), w2=float(t.max()))


def _log_binomial_tail(n, k, p):
    """log10 of the binomial tail P[X >= k], X ~ B(n, p)."""
    from scipy.stats import binom
    return float(binom.logsf(k - 1, n, p) / math.log(10)) if k > 0 else 0.0


def lsd(img, scale=0.8, sigma_scale=0.6, quant=2.0, ang_th=22.5,
        log_eps=0.0, density_th=0.7):
    """Detect line segments; returns (n, 5) rows x1, y1, x2, y2, width in
    the coordinates of ``img`` (IPOL defaults)."""
    img = np.asarray(img, np.float64)
    img = np.nan_to_num(img)
    scaled = _scale_image(img, scale, sigma_scale)
    prec = math.pi * ang_th / 180.0
    p = ang_th / 180.0
    rho = quant / math.sin(prec)
    ang, mag = _gradient(scaled, rho)
    h, w = scaled.shape

    # pseudo-ordering by magnitude (1024 bins, descending)
    order = np.argsort(-mag, axis=None, kind='stable')
    seeds = np.column_stack(np.unravel_index(order, mag.shape))
    seeds = seeds[mag[seeds[:, 0], seeds[:, 1]] > rho]

    used = ang == _NOTDEF            # never grow into undefined pixels
    used = used.copy()
    logNT = 2.5 * math.log10(float(h * w)) + math.log10(11.0)
    min_size = int(-logNT / math.log10(p)) + 1

    segments = []
    for sy, sx in seeds:
        if used[sy, sx]:
            continue
        pts, theta = _grow_region((sy, sx), ang, used, prec)
        if len(pts) < min_size:
            continue
        rect = _region_to_rect(pts, mag, theta, prec)

        # density refinement: shrink the region around the center until
        # the rectangle is at least density_th covered
        for _ in range(3):
            length = rect['l2'] - rect['l1']
            width = max(rect['w2'] - rect['w1'], 1.0)
            density = len(pts) / max(length * width, 1e-9)
            if density >= density_th or len(pts) < min_size:
                break
            r75 = 0.75 * max(abs(rect['l1']), abs(rect['l2']))
            pa = np.asarray(pts)
            keep = ((pa[:, 1] - rect['cx']) ** 2
                    + (pa[:, 0] - rect['cy']) ** 2) <= r75 * r75
            if keep.all():
                break
            pts = [tuple(q) for q in pa[keep]]
            if len(pts) < min_size:
                break
            rect = _region_to_rect(pts, mag, theta, prec)
        if len(pts) < min_size:
            continue

        # NFA validation: aligned points inside the rectangle
        length = rect['l2'] - rect['l1']
        width = max(rect['w2'] - rect['w1'], 1.0)
        n_pix = max(int(round(length * width)), len(pts))
        log_nfa = -(logNT + _log_binomial_tail(n_pix, len(pts), p))
        if log_nfa <= log_eps:
            continue

        ux, uy = math.cos(rect['theta']), math.sin(rect['theta'])
        x1 = (rect['cx'] + rect['l1'] * ux) / scale
        y1 = (rect['cy'] + rect['l1'] * uy) / scale
        x2 = (rect['cx'] + rect['l2'] * ux) / scale
        y2 = (rect['cy'] + rect['l2'] * uy) / scale
        segments.append((x1, y1, x2, y2, width / scale))

    return np.asarray(segments, np.float64).reshape(-1, 5)


def draw_segments(segments, w, h):
    """Rasterize segments into a uint8 image (255 on segments), the
    ``pview segments`` equivalent."""
    out = np.zeros((h, w), np.uint8)
    for x1, y1, x2, y2, wid in segments:
        n = max(2, int(2 * math.hypot(x2 - x1, y2 - y1)) + 1)
        t = np.linspace(0.0, 1.0, n)
        xs = np.round(x1 + t * (x2 - x1)).astype(int)
        ys = np.round(y1 + t * (y2 - y1)).astype(int)
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        out[ys[ok], xs[ok]] = 255
    return out


def lsd_weights(img):
    """Edge-weight map for mgm_multi_lsd: the reference plambda formula
    ``max(((255 - v)/255)^2, 0.1)`` over the rasterized segments
    (block_matching.py:191-218): 0.1 on detected line segments, 1 off."""
    from ..pipeline import linear_stretching_and_quantization_8bit
    h, w = img.shape
    q = linear_stretching_and_quantization_8bit(np.nan_to_num(img))
    segs = lsd(q.astype(np.float64))
    v = draw_segments(segs, w, h).astype(np.float64)
    return np.maximum(((255.0 - v) / 255.0) ** 2, 0.1).astype(np.float32)
