"""TV-L1 optical flow (duality-based, Zach et al. / IPOL tvl1flow).

Counterpart of ``s2p_tpu/ops/tvl1.py``: the reference s2p's ``tvl1``
matcher takes the horizontal component of the TV-L1 flow as the
disparity.  A coarse-to-fine pyramid (a gaussian blur and a factor-2
subsampling per level), per level 5 warps of 30 primal-dual iterations
(IPOL defaults: tau 0.25, lambda 0.15, theta 0.3), the flow upsampled
bilinearly between levels.

Every step is eager torch on the tensors' device, in the JAX package's
order of float32 operations, each rounded on its own: additions,
products, true divisions (never by a python number, which the card would
turn into a product with its reciprocal), and ``jnp.hypot``'s formula
with a correctly rounded square root.  So the CPU and the card compute
the same bits.  The JAX package
runs :func:`_tvl1_scale` as one jitted program, in which XLA's CPU run
fuses some multiplies into the adds that follow them, in an order that
depends on its fusion (the bilinear sums and the dual updates, not the
data term), and rounds its hypot differently on about 0.7% of the
inputs; 150 iterations a level carry those ulps into the flow.
tests/test_torch_tvl1.py holds the port against the JAX package within
a stated tolerance.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve
from .sift import _gauss_kernel


def _zoom_out(img, factor=0.5):
    """Anti-aliased downscale by 0.5 (gaussian blur + subsampling), edge
    padding, each tap's product added to the running sum from +0: the
    JAX package's eager run."""
    sigma = 0.6 * math.sqrt(1.0 / (factor * factor) - 1.0)
    k = [float(v) for v in _gauss_kernel(sigma)]
    r = (len(k) - 1) // 2
    h, w = img.shape
    p = torch.cat([img[:1].expand(r, w), img, img[-1:].expand(r, w)], 0)
    acc = p[0:h] * k[0]
    for i in range(1, len(k)):
        acc = acc + p[i:i + h] * k[i]
    p = torch.cat([acc[:, :1].expand(h, r), acc,
                   acc[:, -1:].expand(h, r)], 1)
    out = p[:, 0:w] * k[0]
    for i in range(1, len(k)):
        out = out + p[:, i:i + w] * k[i]
    return out[::2, ::2]


def _gather2d(img, iy, ix):
    h, w = img.shape
    iy = iy.long().clamp(0, h - 1)
    ix = ix.long().clamp(0, w - 1)
    return img.reshape(-1)[iy * w + ix]


def _bilinear(img, xs, ys):
    """Bilinear sample of ``img`` at (xs, ys), 0 outside: ``interp
    .bilinear_sample`` with fill 0."""
    h, w = img.shape
    x0 = torch.floor(xs).to(torch.int32)
    y0 = torch.floor(ys).to(torch.int32)
    fx = xs - x0
    fy = ys - y0
    v00 = _gather2d(img, y0, x0)
    v01 = _gather2d(img, y0, x0 + 1)
    v10 = _gather2d(img, y0 + 1, x0)
    v11 = _gather2d(img, y0 + 1, x0 + 1)
    gx, gy = 1 - fx, 1 - fy
    out = v00 * gy * gx + v01 * gy * fx + v10 * fy * gx + v11 * fy * fx
    inside = (xs >= 0) & (ys >= 0) & (xs <= w - 1) & (ys <= h - 1)
    return torch.where(inside, out, 0.0)


def _zoom_in_flow(u, v, shape):
    """Bilinear upsample of a flow field to ``shape`` (values rescaled)."""
    h, w = shape
    sh, sw = u.shape
    dev = u.device
    # the JAX package's coordinates: ((i + 0.5) * s / n - 0.5) in
    # float32, a true division (a python divisor would make the card
    # multiply by its reciprocal)
    def coords(n, s):
        i = torch.arange(n, device=dev, dtype=torch.float32)
        return (i + 0.5) * s / torch.tensor(float(n), device=dev) - 0.5

    ys, xs = coords(h, sh), coords(w, sw)
    Y = ys[:, None].expand(h, w).clamp(0, sh - 1)
    X = xs[None, :].expand(h, w).clamp(0, sw - 1)
    uu = _bilinear(u, X, Y)
    vv = _bilinear(v, X, Y)
    return uu * (w / sw), vv * (h / sh)


def _forward_grad(a):
    z = torch.zeros_like(a)
    gx = torch.cat([a[:, 1:] - a[:, :-1], z[:, :1]], 1)
    gy = torch.cat([a[1:, :] - a[:-1, :], z[:1, :]], 0)
    return gx, gy


def _divergence(px, py):
    dx = torch.cat([px[:, :1], px[:, 1:-1] - px[:, :-2], -px[:, -2:-1]], 1)
    dy = torch.cat([py[:1, :], py[1:-1, :] - py[:-2, :], -py[-2:-1, :]], 0)
    return dx + dy


def _cdx(a):
    out = torch.zeros_like(a)
    out[:, 1:-1] = 0.5 * (a[:, 2:] - a[:, :-2])
    return out


def _cdy(a):
    out = torch.zeros_like(a)
    out[1:-1, :] = 0.5 * (a[2:, :] - a[:-2, :])
    return out


def _hypot(x, y):
    """``jnp.hypot``'s formula: max * sqrt(1 + r * r), r = min / max.  The
    square root of the float32 value is taken in float64 and rounded once
    to float32, which is its correctly rounded float32 root: torch's
    float32 ``sqrt`` on the card is not (its last bit differs from the
    CPU's on some inputs), the float64 one is."""
    x, y = x.abs(), y.abs()
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    r = lo / torch.where(zero, 1.0, hi)
    root = torch.sqrt((1 + r * r).double()).float()
    out = torch.where(zero, hi, hi * root)
    return torch.where(torch.isposinf(x) | torch.isposinf(y),
                       float('inf'), out)


def _tvl1_scale(I0, I1, u, v, warps=5, inner=30, tau=0.25, lam=0.15,
                theta=0.3):
    """One pyramid level: ``warps`` warps of ``inner`` primal-dual
    iterations from the flow (u, v); returns the new flow."""
    h, w = I0.shape
    dev = I0.device
    f32 = np.float32
    Y = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w)
    X = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w)
    lt = float(f32(lam * theta))
    taut = float(f32(tau / theta))
    theta32 = float(f32(theta))
    eps = torch.tensor(1e-10, dtype=torch.float32, device=dev)
    z = torch.zeros_like(I0)
    p11 = p12 = p21 = p22 = z
    I1x, I1y = _cdx(I1), _cdy(I1)
    for _ in range(warps):
        xw = X + u
        yw = Y + v
        I1w = _bilinear(I1, xw, yw)
        I1wx = _bilinear(I1x, xw, yw)
        I1wy = _bilinear(I1y, xw, yw)
        grad2 = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u - I1wy * v - I0
        gmax = torch.maximum(grad2, eps)
        big = grad2 > eps
        lo_t, hi_t = -lt * grad2, lt * grad2
        for _ in range(inner):
            rho = rho_c + I1wx * u + I1wy * v
            neg, pos = rho < lo_t, rho > hi_t
            d1 = torch.where(neg, lt * I1wx, torch.where(
                pos, -lt * I1wx, torch.where(big, -rho * I1wx / gmax, 0.0)))
            d2 = torch.where(neg, lt * I1wy, torch.where(
                pos, -lt * I1wy, torch.where(big, -rho * I1wy / gmax, 0.0)))
            u = (u + d1) + theta32 * _divergence(p11, p12)
            v = (v + d2) + theta32 * _divergence(p21, p22)
            ux, uy = _forward_grad(u)
            vx, vy = _forward_grad(v)
            ng1 = 1.0 + taut * _hypot(ux, uy)
            ng2 = 1.0 + taut * _hypot(vx, vy)
            p11 = (p11 + taut * ux) / ng1
            p12 = (p12 + taut * uy) / ng1
            p21 = (p21 + taut * vx) / ng2
            p22 = (p22 + taut * vy) / ng2
    return u, v


def flow(im1, im2, n_scales=None, warps=5, inner=30, device=None):
    """Dense optical flow im1 -> im2: numpy (u, v).  ``device`` None runs
    on CUDA (raises without it), "cpu" there."""
    dev = resolve(device)
    a = torch.as_tensor(np.nan_to_num(np.asarray(im1, np.float32)),
                        device=dev)
    b = torch.as_tensor(np.nan_to_num(np.asarray(im2, np.float32)),
                        device=dev)
    # intensities normalized jointly to [0, 255] (IPOL preprocessing)
    mn = torch.minimum(a.min(), b.min())
    mx = torch.maximum(a.max(), b.max())
    rng = torch.maximum(mx - mn, torch.tensor(1e-9, dtype=torch.float32,
                                               device=dev))
    a = 255.0 * (a - mn) / rng
    b = 255.0 * (b - mn) / rng

    if n_scales is None:
        n_scales = max(1, int(math.log2(min(np.shape(im1)) / 16)))
    pyr_a, pyr_b = [a], [b]
    for _ in range(n_scales - 1):
        if min(pyr_a[-1].shape) < 32:
            break
        pyr_a.append(_zoom_out(pyr_a[-1]))
        pyr_b.append(_zoom_out(pyr_b[-1]))

    u = torch.zeros_like(pyr_a[-1])
    v = torch.zeros_like(pyr_a[-1])
    for s in range(len(pyr_a) - 1, -1, -1):
        u, v = _tvl1_scale(pyr_a[s], pyr_b[s], u, v, warps=warps,
                           inner=inner)
        if s > 0:
            u, v = _zoom_in_flow(u, v, pyr_a[s - 1].shape)
    return u.cpu().numpy(), v.cpu().numpy()


def disparity(im1, im2, device=None):
    """Disparity = horizontal flow; valid where the reference is finite
    and the vertical flow is at most 1 px (the rectified geometry's
    consistency check).  Returns numpy (disp, valid)."""
    u, v = flow(im1, im2, device=device)
    valid = np.isfinite(np.asarray(im1)) & (np.abs(v) <= 1.0)
    disp = np.where(valid, u, np.nan).astype(np.float32)
    return disp, valid
