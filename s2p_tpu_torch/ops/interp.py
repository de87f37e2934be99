"""Image resampling: the samplers of ``s2p_tpu/ops/interp.py`` in torch,
and the homography warp W1 (``csrc/warp.cu``).

The samplers (:func:`bilinear_sample`, :func:`bicubic_sample`,
:func:`bspline5_sample`) and :func:`warp_homography_plain` are plain
functions on float32 tensors.  They repeat the JAX package's float32
arithmetic operation by operation, in its order: each weight, tap and
sum rounds where the JAX function's eager (unjitted) run rounds, so the
two agree bitwise.  The fifth power is written ``x * ((x*x) * (x*x))``,
the order of ``lax.integer_pow``; ``t ** 5`` would round differently.

:func:`warp_homography` is the port's warp: for a CPU tensor it runs
:func:`warp_homography_plain`, for a CUDA tensor it launches W1, one
thread per output pixel of a batch of homographies over one source.  It
never falls back: a failed build or launch raises.  W1 reads an order-5
NaN mask through :func:`warp_dilate`, a byte map made once per source
whose plain version is :func:`dilate_nanmask6`; the plain warp keeps the
36-tap rule of the JAX package.

Sampling convention: integer coordinates land on pixel centres.  A
sample whose support leaves the image (or, for the quintic spline with a
NaN mask, touches a NaN of the original image) is NaN.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_launches = {'warp': 0, 'warp_dilate': 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_WARP_ARGS = [_P, _P, _P, _P] + [_I] * 6 + [_P]
_DILATE_ARGS = [_P, _P, _I, _I, _P]


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return dict(_launches)


def reset_launch_counts():
    for k in _launches:
        _launches[k] = 0


def _gather2d(img, iy, ix):
    """img[iy, ix] with indices clipped to the valid range."""
    h, w = img.shape
    iy = iy.long().clamp(0, h - 1)
    ix = ix.long().clamp(0, w - 1)
    return img.reshape(-1)[iy * w + ix]


def _floor_int(v):
    return torch.floor(v).to(torch.int32)


def _div(a, d):
    """``a / d`` as an IEEE division on every device.  A Python scalar
    divisor becomes a tensor on ``a``'s device: PyTorch's CUDA ``div``
    by a CPU scalar multiplies by the reciprocal instead."""
    return a / torch.tensor(d, dtype=a.dtype, device=a.device)


def bilinear_sample(img, xs, ys, fill_value=float('nan')):
    """Bilinear sample of img at float coords (xs, ys); NaN outside."""
    h, w = img.shape
    x0 = _floor_int(xs)
    y0 = _floor_int(ys)
    fx = xs - x0
    fy = ys - y0
    v00 = _gather2d(img, y0, x0)
    v01 = _gather2d(img, y0, x0 + 1)
    v10 = _gather2d(img, y0 + 1, x0)
    v11 = _gather2d(img, y0 + 1, x0 + 1)
    out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
           + v10 * fy * (1 - fx) + v11 * fy * fx)
    inside = (xs >= 0) & (ys >= 0) & (xs <= w - 1) & (ys <= h - 1)
    return torch.where(inside, out, fill_value)


def _cubic_weights(t):
    """Keys cubic convolution weights (a = -0.5, Catmull-Rom) for offsets
    (-1, 0, 1, 2) given the fractional position t in [0, 1)."""
    t2 = t * t
    t3 = t2 * t
    w_m1 = -0.5 * t3 + t2 - 0.5 * t
    w_0 = 1.5 * t3 - 2.5 * t2 + 1.0
    w_p1 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w_p2 = 0.5 * t3 - 0.5 * t2
    return w_m1, w_0, w_p1, w_p2


def bicubic_sample(img, xs, ys, fill_value=float('nan')):
    """Bicubic (Catmull-Rom) sample of img at float coords; NaN outside."""
    h, w = img.shape
    x0 = _floor_int(xs)
    y0 = _floor_int(ys)
    wx = _cubic_weights(xs - x0)
    wy = _cubic_weights(ys - y0)
    out = torch.zeros_like(xs)
    for j, wyj in enumerate(wy):
        row = torch.zeros_like(out)
        for i, wxi in enumerate(wx):
            row = row + wxi * _gather2d(img, y0 + j - 1, x0 + i - 1)
        out = out + wyj * row
    inside = (xs >= 1) & (ys >= 1) & (xs <= w - 2) & (ys <= h - 2)
    return torch.where(inside, out, fill_value)


# binomial C(6, k) for the truncated-power quintic B-spline formula
_BIN6 = (1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0)


def _pow5(x):
    return x * ((x * x) * (x * x))


def _bspline5_weights(t):
    """Quintic B-spline weights for the 6 taps at offsets (-2..3) given the
    fractional position t in [0, 1):  w_o = beta5(t - o) with
    beta5(x) = 1/120 * sum_k (-1)^k C(6,k) max(x + 3 - k, 0)^5."""
    ws = []
    for o in (-2, -1, 0, 1, 2, 3):
        x = t - o
        acc = torch.zeros_like(t)
        # for t in [0, 1], x + 3 <= 4 - o, so each k >= 4 - o adds c * 0,
        # which leaves the sum (from +0, never -0) unchanged bit for bit
        for k in range(4 - o):
            term = _pow5(torch.clamp_min(x + 3.0 - k, 0.0))
            acc = acc + (_BIN6[k] if k % 2 == 0 else -_BIN6[k]) * term
        ws.append(_div(acc, 120.0))
    return ws


def bspline5_sample(coeffs, xs, ys, nanmask=None, fill_value=float('nan')):
    """Quintic B-spline sample at float coords; ``coeffs`` must be the
    PREFILTERED spline coefficients of the image (``_spline5_inputs`` of
    :mod:`s2p_tpu_torch.ops.homography`).

    Args:
        nanmask: optional (H, W) tensor, nonzero where the ORIGINAL image
            was NaN (prefiltering cannot propagate NaNs); any NaN tap in
            the 6x6 support invalidates the sample.
    """
    h, w = coeffs.shape
    x0 = _floor_int(xs)
    y0 = _floor_int(ys)
    wx = _bspline5_weights(xs - x0)
    wy = _bspline5_weights(ys - y0)
    out = torch.zeros_like(xs)
    bad = torch.zeros_like(xs)
    for j in range(6):
        row = torch.zeros_like(out)
        rbad = torch.zeros_like(bad)
        for i in range(6):
            row = row + wx[i] * _gather2d(coeffs, y0 + j - 2, x0 + i - 2)
            if nanmask is not None:
                rbad = torch.maximum(rbad, _gather2d(nanmask, y0 + j - 2,
                                                     x0 + i - 2))
        out = out + wy[j] * row
        bad = torch.maximum(bad, rbad)
    inside = (xs >= 0) & (ys >= 0) & (xs <= w - 1) & (ys <= h - 1)
    if nanmask is not None:
        inside = inside & (bad == 0)
    return torch.where(inside, out, fill_value)


def warp_homography_plain(img, hinv, out_w, out_h, order=3, nanmask=None):
    """Plain version of :func:`warp_homography` for one (3, 3) inverse
    homography: the JAX package's ``warp_homography``."""
    dev = img.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] \
        .expand(out_h, out_w)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :] \
        .expand(out_h, out_w)
    z = hinv[2, 0] * xs + hinv[2, 1] * ys + hinv[2, 2]
    sx = (hinv[0, 0] * xs + hinv[0, 1] * ys + hinv[0, 2]) / z
    sy = (hinv[1, 0] * xs + hinv[1, 1] * ys + hinv[1, 2]) / z
    if order == 1:
        return bilinear_sample(img, sx, sy)
    if order == 5:
        return bspline5_sample(img, sx, sy, nanmask=nanmask)
    return bicubic_sample(img, sx, sy)


def dilate_nanmask6(nanmask):
    """Plain version of :func:`warp_dilate`: the (H, W) uint8 map that is 1
    where a value m of ``nanmask`` with ``!(m <= 0)`` (positive or NaN)
    lies in rows clamp(y - 2 .. y + 3) and columns clamp(x - 2 .. x + 3).
    A quintic sample whose integer parts are (x0, y0) is NaN under
    :func:`bspline5_sample`'s 36-tap rule exactly where the map is 1 at
    (y0, x0)."""
    bad = ~(nanmask <= 0)
    h, w = bad.shape
    dev = bad.device
    rows = torch.zeros_like(bad)
    for i in range(-2, 4):
        rows |= bad[:, (torch.arange(w, device=dev) + i).clamp(0, w - 1)]
    out = torch.zeros_like(bad)
    for j in range(-2, 4):
        out |= rows[(torch.arange(h, device=dev) + j).clamp(0, h - 1)]
    return out.to(torch.uint8)


def warp_dilate(nanmask):
    """The dilated NaN mask of one source for W1's order 5 (see
    :func:`dilate_nanmask6`): for a CPU tensor the plain version, for a
    CUDA tensor one launch of the dilation kernel of ``csrc/warp.cu``."""
    if nanmask.dtype != torch.float32 or nanmask.dim() != 2:
        raise TypeError(f'nanmask: expected 2-D float32, got '
                        f'{nanmask.dtype} {tuple(nanmask.shape)}')
    if nanmask.device.type == 'cpu':
        return dilate_nanmask6(nanmask)
    if nanmask.device.type != 'cuda':
        raise ValueError(f'unsupported device {nanmask.device}')
    nanmask = nanmask.contiguous()
    out = torch.empty(nanmask.shape, dtype=torch.uint8,
                      device=nanmask.device)
    if out.numel():
        _build.call('warp', 's2p_warp_dilate', _DILATE_ARGS,
                    nanmask.data_ptr(), out.data_ptr(), *nanmask.shape)
        _launches['warp_dilate'] += 1
    return out


def warp_homography(img, hinvs, out_w, out_h, order=3, nanmask=None,
                    dilated=None):
    """Resample ``img`` under a batch of homographies: out[b](x) =
    img(hinvs[b] @ x).

    Args:
        img: (H, W) float32 source.  For order 5 it holds the prefiltered
            quintic spline coefficients.
        hinvs: (B, 3, 3) or (3, 3) float32 INVERSE homographies (output
            to source coordinates), on ``img``'s device.
        out_w, out_h: the output size.
        order: 1 (bilinear), 3 (bicubic) or 5 (prefiltered quintic
            B-spline).
        nanmask: for order 5, an optional (H, W) float32 tensor, nonzero
            where the original image was NaN.
        dilated: for a CUDA tensor, ``warp_dilate(nanmask)`` where the
            caller already has it (one source warped in several launches
            is dilated once); None dilates ``nanmask`` here.  It must be
            that map of this ``nanmask``: W1 reads it in place of
            ``nanmask``, and the shapes and type are all that is checked.
            The CPU route reads ``nanmask`` alone.

    Returns (B, out_h, out_w) float32, or (out_h, out_w) for one (3, 3)
    homography.  A CPU tensor runs :func:`warp_homography_plain` for each
    homography; a CUDA tensor launches W1 once for the batch (and the
    dilation once, when ``nanmask`` comes without ``dilated``)."""
    if order not in (1, 3, 5):
        raise ValueError(f'order must be 1, 3 or 5, got {order}')
    one = hinvs.dim() == 2
    hinvs = hinvs[None] if one else hinvs
    for name, t, nd, dtype in (('img', img, 2, torch.float32),
                               ('hinvs', hinvs, 3, torch.float32),
                               ('nanmask', nanmask, 2, torch.float32),
                               ('dilated', dilated, 2, torch.uint8)):
        if t is None:
            continue
        if t.dtype != dtype or t.dim() != nd:
            raise TypeError(f'{name}: expected {nd}-D {dtype}, got '
                            f'{t.dtype} {tuple(t.shape)}')
        if t.device != img.device:
            raise ValueError(f'{name} on {t.device}, img on {img.device}')
    if hinvs.shape[1:] != (3, 3):
        raise ValueError(f'hinvs must be (B, 3, 3), got {tuple(hinvs.shape)}')
    if nanmask is not None and (order != 5 or nanmask.shape != img.shape):
        raise ValueError('nanmask needs order 5 and the shape of img')
    if dilated is not None and (nanmask is None
                                or dilated.shape != img.shape):
        raise ValueError('dilated needs nanmask and the shape of img')
    if img.device.type == 'cpu':
        out = torch.stack([warp_homography_plain(img, hv, out_w, out_h,
                                                 order, nanmask)
                           for hv in hinvs])
        return out[0] if one else out
    if img.device.type != 'cuda':
        raise ValueError(f'unsupported device {img.device}')
    img = img.contiguous()
    hinvs = hinvs.contiguous()
    B, (H, W) = hinvs.shape[0], img.shape
    out = torch.empty((B, out_h, out_w), dtype=torch.float32,
                      device=img.device)
    if out.numel():
        if nanmask is not None and dilated is None:
            dilated = warp_dilate(nanmask)
        bad6 = None if dilated is None else dilated.contiguous()
        _build.call('warp', 's2p_warp', _WARP_ARGS, img.data_ptr(),
                    None if bad6 is None else bad6.data_ptr(),
                    hinvs.data_ptr(), out.data_ptr(), B, H, W, out_h, out_w,
                    order)
        _launches['warp'] += 1
    return out[0] if one else out


def warp_ops(order, masked, n_inside, n_pixels):
    """float32 operations W1 must do for a warp with ``n_pixels`` output
    pixels, ``n_inside`` of them sampled (inside their source and, with a
    mask, clear of its NaNs; the others stop after their coordinates, the
    inside test and the mask's byte), counting only what the output needs:
    no identity (a multiply by 1, an add to +0, a subtraction of 0, a
    maximum that cannot bind) and each shared product once.

    Per pixel 18: the coordinates (6 multiplies, 6 adds, 2 divisions) and
    the inside test's 4 comparisons.  Per sampled pixel 4 for the integer
    parts and fractions, then the weights of each axis:

    * order 1: 1 - t;
    * order 3: t^2, t^3, 6 distinct products (+-0.5 t^3, +-1.5 t^3,
      +-0.5 t, 2.5 t^2, 2 t^2, 0.5 t^2) and 7 adds: 15;
    * order 5: 11 for the offsets (t - o for o != 0, then + 3) and, over
      the 21 terms an axis that can be nonzero, 6n - 3 for an offset of
      n = 4 - o terms (the fifth power's 3 multiplies a term, and a
      subtraction, a coefficient's multiply and an add for each term but
      the first: k = 0 subtracts 0, multiplies by 1 and adds to +0); the
      maximum max(v - k, 0) binds for no kept term (v >= 3 - o >= k), so
      it is not counted; 6 divisions by 120 of 3 (a multiply and two
      fused multiply-adds): 137.

    Then the taps: at order 1 the blend's 8 multiplies and 3 adds; at
    orders 3 and 5, N x N taps, N^2 multiplies and N (N - 1) adds in the
    rows (a row's first add to +0 changes no bit of the output: a row that
    is +-0 adds +-0 to an outer sum that starts from +0), N multiplies and
    N adds in the outer sum; and with a mask one comparison."""
    taps = {1: 8 + 3, 3: 16 + 12 + 4 + 4, 5: 36 + 30 + 6 + 6}[order]
    inner = 2 * {1: 1, 3: 15, 5: 137}[order] + taps \
        + (1 if masked and order == 5 else 0)
    return 18 * n_pixels + (4 + inner) * n_inside
