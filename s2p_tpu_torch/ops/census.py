"""Census transform and the cost volumes of the classic SGM matcher.

Counterpart of ``s2p_tpu/ops/census.py``: the signature of a pixel has one
bit per neighbour of its win x win window, set where the neighbour is
below the centre.  NaN centres compare as 0, window samples outside the
image as +inf (never below the centre), and a pixel is valid when it and
its whole window are finite.  :func:`census_words` packs any window into
32-bit words (and, with ``raw``, the mgm binary's conventions of the
flow's ``census_bits_raw``); :func:`census_transform` gives them as int32
bit patterns, the JAX package's contract, and the cost volumes of the lax
route (:func:`census_cost_volume`, :func:`census_cost_volume_dyn`,
:func:`birchfield_tomasi_cost_volume`) build on them.
"""

from __future__ import annotations

import numpy as np
import torch

from .sgm_kernels import _popcount


def census_words(img, win: int = 5, raw: bool = False):
    """(signature, valid) of a (..., h, w) image over any window.

    Returns the signatures as (..., h, w, n_words) int64 holding unsigned
    32-bit words (bit ``b`` of the window in word ``b // 32``) and the
    validity mask (bool, (..., h, w)).  With ``raw`` the comparisons are
    the mgm binary's: raw IEEE (NaN neighbours and centres give 0 bits),
    samples outside the image give 0 bits."""
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    r = win // 2
    n_words = (win * win - 1 + 31) // 32
    finite = torch.isfinite(img)
    center = img if raw else torch.nan_to_num(img)
    pad = torch.nn.functional.pad(center, (r, r, r, r),
                                  value=float('nan' if raw else 'inf'))
    pad_fin = torch.nn.functional.pad(finite.to(torch.uint8), (r, r, r, r),
                                      value=0) == 1
    words = [torch.zeros(img.shape, dtype=torch.int64, device=img.device)
             for _ in range(n_words)]
    valid = finite
    bit = 0
    for dy in range(win):
        for dx in range(win):
            if dy == r and dx == r:
                continue
            nb = pad[..., dy:dy + h, dx:dx + w]
            words[bit // 32] = words[bit // 32] | (
                (nb < center).to(torch.int64) << (bit % 32))
            valid = valid & pad_fin[..., dy:dy + h, dx:dx + w]
            bit += 1
    return torch.stack(words, dim=-1), valid


def census_transform(img, win: int = 5):
    """(signature, valid) of a (..., h, w) image over any window, the JAX
    package's contract: the signatures as int32 bit patterns of shape
    (..., h, w, n_words) and the validity mask (bool, (..., h, w))."""
    sig, valid = census_words(img, win)
    return sig.to(torch.int32), valid


def census_cost_volume(im1, im2, disp_min: int, disp_max: int, win: int = 5,
                       invalid_cost: float = None):
    """Census cost C[y, x, k] = hamming(sig1[y, x], sig2[y, x + disp_min +
    k]) of a rectified pair (one height, widths may differ).

    Returns (cost (h, w, D) float32, valid1 (h, w) bool): ``invalid_cost``
    (default the window's bit count) where either signature is invalid
    or the candidate leaves the secondary; valid1 where the reference
    pixel is valid and has a valid candidate."""
    return census_cost_volume_dyn(im1, im2, disp_min,
                                  disp_max - disp_min + 1, win, invalid_cost)


def census_cost_volume_dyn(im1, im2, disp_min: int, D: int, win: int = 5,
                           invalid_cost: float = None):
    """:func:`census_cost_volume` of ``D`` candidates from ``disp_min``."""
    if invalid_cost is None:
        invalid_cost = float(win * win - 1)
    sig1, val1 = census_words(im1, win)
    sig2, val2 = census_words(im2, win)
    h, w = sig1.shape[:2]
    w2 = sig2.shape[1]
    dev = sig1.device
    xs = (torch.arange(w, device=dev)[:, None] + int(disp_min)
          + torch.arange(D, device=dev)[None, :])
    inb = (xs >= 0) & (xs < w2)
    xs_c = xs.clamp(0, w2 - 1)
    sig2_g = sig2[:, xs_c, :]                        # (h, w, D, n_words)
    val2_g = val2[:, xs_c] & inb[None]
    ham = _popcount(sig1[:, :, None, :] ^ sig2_g).sum(dim=-1) \
        .to(torch.float32)
    ok = val1[:, :, None] & val2_g
    cost = torch.where(ok, ham, float(invalid_cost))
    return cost, val1 & ok.any(dim=-1)


def _half_neighbors(img):
    """Birchfield-Tomasi's interpolated extremes: min and max of the pixel
    and its half-way points to its left and right neighbours."""
    left = torch.cat([img[:, :1], img[:, :-1]], dim=1)
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    hl, hr = 0.5 * (img + left), 0.5 * (img + right)
    lo = torch.minimum(torch.minimum(hl, hr), img)
    hi = torch.maximum(torch.maximum(hl, hr), img)
    return lo, hi


def bt_cost_sum(im1, im2, disp_min: int, disp_max: int, win: int = 3,
                invalid_cost: float = None, trunc: float = 63.0):
    """The terms of :func:`birchfield_tomasi_cost_volume`: (box sum (h, w,
    D) float32, scale, valid (h, w) bool), the cost being ``sum * scale``
    with ``scale`` = f32(1 / win**2), or the sum itself (scale 1.0) for a
    1x1 block."""
    D = disp_max - disp_min + 1
    a = im1.to(torch.float32)
    b = im2.to(torch.float32)
    fin1, fin2 = torch.isfinite(a), torch.isfinite(b)
    a0, b0 = torch.nan_to_num(a), torch.nan_to_num(b)
    h, w = a0.shape
    w2 = b0.shape[1]
    dev = a0.device
    lo2, hi2 = _half_neighbors(b0)
    lo1, hi1 = _half_neighbors(a0)
    xs = (torch.arange(w, device=dev)[:, None]
          + torch.arange(disp_min, disp_max + 1, device=dev)[None, :])
    inb = (xs >= 0) & (xs < w2)
    xs_c = xs.clamp(0, w2 - 1)
    b_g, lo2_g, hi2_g = b0[:, xs_c], lo2[:, xs_c], hi2[:, xs_c]
    fin2_g = fin2[:, xs_c] & inb[None]
    a3 = a0[:, :, None]
    d_fwd = torch.clamp(torch.maximum(a3 - hi2_g, lo2_g - a3), min=0.0)
    d_bwd = torch.clamp(torch.maximum(b_g - hi1[:, :, None],
                                      lo1[:, :, None] - b_g), min=0.0)
    cost = torch.clamp(torch.minimum(d_fwd, d_bwd), max=float(trunc))
    ok = fin1[:, :, None] & fin2_g
    if invalid_cost is None:
        invalid_cost = trunc
    cost = torch.where(ok, cost, float(invalid_cost))
    valid = fin1 & ok.any(dim=-1)
    r = win // 2
    if r == 0:
        return cost, 1.0, valid
    pad = torch.nn.functional.pad(cost.permute(2, 0, 1)[None],
                                  (r, r, r, r), mode='replicate')[0]
    pad = pad.permute(1, 2, 0)
    acc = torch.zeros_like(cost)
    for dy in range(win):
        for dx in range(win):
            acc = acc + pad[dy:dy + h, dx:dx + w]
    return acc, float(np.float32(1 / (win * win))), valid


def birchfield_tomasi_cost_volume(im1, im2, disp_min: int, disp_max: int,
                                  win: int = 3, invalid_cost: float = None,
                                  trunc: float = 63.0):
    """Birchfield-Tomasi sampling-insensitive cost, box-aggregated over a
    win x win block (edge padding), as OpenCV's SGBM pixel cost.

    Returns (cost (h, w, D) float32, valid (h, w) bool): ``invalid_cost``
    (default ``trunc``) before the box sum where either pixel is not
    finite or the candidate leaves the secondary.  The box mean multiplies
    by f32(1 / win**2): the JAX package's jitted division by a constant
    rounds so."""
    acc, scale, valid = bt_cost_sum(im1, im2, disp_min, disp_max, win,
                                    invalid_cost, trunc)
    return (acc if scale == 1.0 else acc * scale), valid
