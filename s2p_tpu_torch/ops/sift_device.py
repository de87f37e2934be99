"""SIFT detection and description on the device, in torch.

The port's counterpart of ``s2p_tpu/ops/sift_tpu.py`` (the JAX package's
device route, which a TPU always takes); the function names are the
JAX module's.  A crop runs in three steps, each over whole tensors:

  1. the pyramid (:func:`_pyramid_program`): bilinear x2 upsample, the
     cascade of separable gaussian blurs (symmetric boundary, the taps
     summed in the JAX package's order), DoG, strict 26-neighbour
     extremum masks, per-octave top-K candidates (ties to the lower
     index, as ``jax.lax.top_k``) and the 5-step quadratic refinement of
     all candidates at once, plus the ATLAS image that packs every
     (octave, scale) gaussian field used by the next steps;
  2. the orientation histograms (:func:`_ori_kernel_atlas`): 36 masked
     sums over each job's patch of the atlas's gradient fields and six
     circular smoothings;
  3. the descriptors (:func:`_desc_kernel_atlas`): the 4x4x8 trilinear
     histogram as batched matrix products over the patch, the 0.2 clamp
     and the quantisation to ``min(floor(512 d / |d|), 255)``.

Between the steps the host reads the candidate tables (one copy for all
crops of a wave) and the histograms, as the JAX package does; with
``device_desc=True`` the descriptors stay on the device for the match.

Every step is eager torch on whatever device it is given, with no
hand-written kernel: the JAX package runs these as jitted jnp programs,
outside any Pallas kernel.  Results agree with the JAX package's to a
stated set criterion, not bitwise: ``exp``, ``hypot``, ``atan2``, ``cos``
and ``sin`` round differently in XLA and torch, and XLA reorders and
contracts float32 expressions.

The crop is padded by symmetric extension to its 128-px bucket
(:func:`_crop_bucket`); candidates outside the original per-octave domain
are culled.  The bucket is part of the output contract: mirror padding
does not commute with the pyramid's decimation at deep octaves.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from ..device import resolve
from .sift import (DELTA_MIN, SIGMA_MIN, SIGMA_IN, N_SPO, C_EDGE, LAMBDA_ORI,
                   LAMBDA_DESCR, N_BINS, N_HIST, N_ORI, _gauss_kernel,
                   _hist_peaks)

_CHUNK_ORI = 4096     # orientation jobs per batch
_DESC_SAMPLES = 512 * 113 ** 2   # patch samples per descriptor batch
_MARGIN = 64          # atlas outer margin (>= max patch radius)
_R_ORI = 24           # shared orientation patch radius (covers sigma_oct<=5)
_R_DESC = 56          # the JAX package's one descriptor patch radius
_R_DESC_CLASSES = (16, 24, 32, 40, 48, _R_DESC)
_K0 = 8192            # candidate capacity, octave 0 (halved per octave)
_WAVE = 16            # crops per breadth-first detection wave (memory cap)

# float32 constants as Python floats (exact), so torch multiplies in f32
_TWO_PI = float(np.float32(2 * np.pi))
_BINS_PER_RAD = float(np.float32(N_BINS / (2 * np.pi)))


def _octave_layout(hb, wb, n_octaves):
    """Static per-octave field sizes for a padded crop (hb, wb) and the
    atlas slot offsets.  Octaves stop when the NEXT octave would have
    min dim < 24 (the host loop's `min//2 < 12` break)."""
    sizes = []
    h, w = 2 * hb, 2 * wb
    for _ in range(n_octaves):
        sizes.append((h, w))
        if min(h, w) // 2 < 12:
            break
        h, w = (h + 1) // 2, (w + 1) // 2
    # atlas: octaves stacked vertically, the n_spo+1 descriptor scales of
    # each octave side by side horizontally
    slots = {}
    y = _MARGIN
    width = 0
    for o, (ho, wo) in enumerate(sizes):
        for s in range(1, N_SPO + 2):
            slots[(o, s)] = (y, _MARGIN + (s - 1) * (wo + _MARGIN))
        width = max(width, (N_SPO + 1) * (wo + _MARGIN))
        y += ho + _MARGIN
    Ha = -(-(y + _MARGIN) // 8) * 8
    Wa = -(-(width + _MARGIN) // 128) * 128
    return sizes, slots, (Ha, Wa)


def _remainder(x, y):
    """``x mod y`` with the sign of ``y``: ``jnp.remainder``'s exact rule
    (a truncated ``fmod``, plus ``y`` where the signs differ)."""
    t = torch.fmod(x, y)
    return torch.where((t != 0) & ((t < 0) != (y < 0)), t + y, t)


def _symmetric_index(n, r, device):
    """Indices of a length-``n`` axis padded by ``r`` on each side in
    numpy's 'symmetric' mode (reflection that repeats the edge sample,
    repeated when ``r`` exceeds ``n``: the symmetric extension is periodic
    with period 2n).  Made on the device: a host copy would wait for the
    device's queue."""
    j = torch.remainder(torch.arange(-r, n + r, device=device), 2 * n)
    return torch.where(j < n, j, 2 * n - 1 - j)


def _blur_jnp(img, sigma):
    """Separable gaussian, symmetric boundary; the taps are summed one by
    one from the first, as the JAX package's ``sum`` over them."""
    k = [float(t) for t in _gauss_kernel(sigma)]
    r = (len(k) - 1) // 2
    H, W = img.shape
    p = img.index_select(0, _symmetric_index(H, r, img.device))
    out = p[0:H] * k[0]
    for i in range(1, len(k)):
        out = out + p[i:i + H] * k[i]
    p = out.index_select(1, _symmetric_index(W, r, img.device))
    out = p[:, 0:W] * k[0]
    for i in range(1, len(k)):
        out = out + p[:, i:i + W] * k[i]
    return out


def _upsample2_jnp(img):
    """Bilinear x2 upsampling to the delta_min = 0.5 grid."""
    h, w = img.shape
    dev = img.device
    ys = torch.arange(2 * h, dtype=torch.float32, device=dev) * 0.5
    xs = torch.arange(2 * w, dtype=torch.float32, device=dev) * 0.5
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    a = img[y0[:, None], x0[None, :]]
    b = img[y0[:, None], x1[None, :]]
    c = img[y1[:, None], x0[None, :]]
    d = img[y1[:, None], x1[None, :]]
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx \
        + c * fy * (1 - fx) + d * fy * fx


def _extrema_mask_jnp(dog):
    """Strict 26-neighbour extrema of a DoG stack (S, H, W), False on the
    stack's border."""
    S, H, W = dog.shape
    c = dog[1:-1, 1:-1, 1:-1]
    is_max = torch.ones_like(c, dtype=torch.bool)
    is_min = torch.ones_like(c, dtype=torch.bool)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = dog[1 + ds:S - 1 + ds, 1 + dy:H - 1 + dy,
                         1 + dx:W - 1 + dx]
                is_max = is_max & (c > nb)
                is_min = is_min & (c < nb)
    out = torch.zeros(dog.shape, dtype=torch.bool, device=dog.device)
    out[1:-1, 1:-1, 1:-1] = is_max | is_min
    return out


def _top_k(score, k):
    """Indices of the ``k`` largest of the non-negative ``score`` in
    ``jax.lax.top_k``'s order: by value, ties to the lower index.  The
    positive entries are sorted (stably, so ties keep index order); the
    zeros that fill up to ``k`` are the lowest-indexed zeros."""
    pos = torch.nonzero(score > 0).flatten()
    order = torch.sort(-score[pos], stable=True).indices
    pos = pos[order][:k]
    if len(pos) < k:
        zeros = torch.nonzero(score <= 0).flatten()[:k - len(pos)]
        pos = torch.cat([pos, zeros])
    return score[pos], pos


def _refine_device(dog, cand_s, cand_y, cand_x, alive0, c_dog, ho, wo):
    """5-step quadratic refinement of all candidates at once (parity with
    the JAX package's vmapped loop, f32).  Each step gathers the 3x3x3
    neighbourhood at the candidate (its start clamped into the stack, as
    ``dynamic_slice`` clamps) and solves the 3x3 system by its adjugate.
    Returns (s, y, x, offs, vals, keep)."""
    S, Hh, Ww = dog.shape
    flat = dog.reshape(-1)
    dev = dog.device
    # flat offsets of the 3x3x3 block in (ds, dy, dx) order
    k = torch.arange(27, device=dev)
    nb_off = (k // 9) * (Hh * Ww) + (k // 3 % 3) * Ww + k % 3

    def neighbourhood(s0, y, x, depth):
        """The (depth, 3, 3) block from scale s0 about (y, x)."""
        s0 = s0.clamp(0, S - depth)
        y0 = (y - 1).clamp(0, Hh - 3)
        x0 = (x - 1).clamp(0, Ww - 3)
        base = s0 * (Hh * Ww) + y0 * Ww + x0
        return flat[base[:, None] + nb_off[None, :9 * depth]] \
            .reshape(-1, depth, 3, 3)

    s, y, x = cand_s, cand_y, cand_x
    n = len(s)
    off = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    val = torch.zeros(n, dtype=torch.float32, device=dev)
    alive = alive0
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(5):
        nb = neighbourhood(s - 1, y, x, 3)
        c0 = nb[:, 1, 1, 1]
        g = torch.stack([0.5 * (nb[:, 2, 1, 1] - nb[:, 0, 1, 1]),
                         0.5 * (nb[:, 1, 2, 1] - nb[:, 1, 0, 1]),
                         0.5 * (nb[:, 1, 1, 2] - nb[:, 1, 1, 0])], dim=1)
        hss = nb[:, 2, 1, 1] + nb[:, 0, 1, 1] - 2 * c0
        hyy = nb[:, 1, 2, 1] + nb[:, 1, 0, 1] - 2 * c0
        hxx = nb[:, 1, 1, 2] + nb[:, 1, 1, 0] - 2 * c0
        hsy = 0.25 * (nb[:, 2, 2, 1] - nb[:, 2, 0, 1] - nb[:, 0, 2, 1]
                      + nb[:, 0, 0, 1])
        hsx = 0.25 * (nb[:, 2, 1, 2] - nb[:, 2, 1, 0] - nb[:, 0, 1, 2]
                      + nb[:, 0, 1, 0])
        hyx = 0.25 * (nb[:, 1, 2, 2] - nb[:, 1, 2, 0] - nb[:, 1, 0, 2]
                      + nb[:, 1, 0, 0])
        # Cramer / adjugate solve of H x = -g, H = [[a b c] [b d e] [c e f]]
        a, b, c, d, e, f = hss, hsy, hsx, hyy, hyx, hxx
        det = (a * (d * f - e * e) - b * (b * f - e * c)
               + c * (b * e - d * c))
        A00 = d * f - e * e
        A01 = c * e - b * f
        A02 = b * e - c * d
        A11 = a * f - c * c
        A12 = b * c - a * e
        A22 = a * d - b * b
        g0, g1, g2 = g[:, 0], g[:, 1], g[:, 2]
        x0 = -(A00 * g0 + A01 * g1 + A02 * g2)
        x1 = -(A01 * g0 + A11 * g1 + A12 * g2)
        x2 = -(A02 * g0 + A12 * g1 + A22 * g2)
        ok = det.abs() > 1e-30
        inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        sol = torch.stack([x0, x1, x2], dim=1) * inv[:, None]

        act = alive & ~done
        alive = alive & (ok | ~act)
        interior = (sol.abs() < 0.6).all(dim=1)
        w_interp = c0 + 0.5 * (g0 * sol[:, 0] + g1 * sol[:, 1]
                               + g2 * sol[:, 2])
        fin = act & ok & interior
        off = torch.where(fin[:, None], sol, off)
        val = torch.where(fin, w_interp, val)
        done = done | fin
        move = act & ok & ~interior
        step = torch.round(sol).clamp(-1, 1).to(torch.int64)
        s2 = torch.where(move, s + step[:, 0], s)
        y2 = torch.where(move, y + step[:, 1], y)
        x2 = torch.where(move, x + step[:, 2], x)
        inb = ((s2 >= 1) & (s2 <= S - 2) & (y2 >= 1) & (y2 <= ho - 2)
               & (x2 >= 1) & (x2 <= wo - 2))
        alive = alive & (inb | ~move)
        s = s2.clamp(1, S - 2)
        y = y2.clamp(1, Hh - 2)
        x = x2.clamp(1, Ww - 2)
    keep = alive & done & (val.abs() >= c_dog)

    # edge-response test on the 2D spatial hessian
    nb = neighbourhood(s, y, x, 1)[:, 0]
    c0 = nb[:, 1, 1]
    hyy = nb[:, 2, 1] + nb[:, 0, 1] - 2 * c0
    hxx = nb[:, 1, 2] + nb[:, 1, 0] - 2 * c0
    hyx = 0.25 * (nb[:, 2, 2] - nb[:, 2, 0] - nb[:, 0, 2] + nb[:, 0, 0])
    tr = hxx + hyy
    det2 = hxx * hyy - hyx * hyx
    keep = keep & (det2 > 0) & (tr * tr * C_EDGE < (C_EDGE + 1) ** 2 * det2)
    return s, y, x, off, val, keep


def _pyramid_program(img, h, w, thresh, n_octaves, n_scales):
    """Padded crop (hb, wb) -> (atlas, per-octave candidate tables).

    ``h`` and ``w`` are the crop's true dims (candidates beyond them are
    culled) and ``thresh`` its DoG threshold.  Each table has one row per
    candidate: s, y, x, the three offsets, the interpolated DoG value and
    the keep flag, all float32."""
    assert n_scales == N_SPO
    hb, wb = img.shape
    sizes, slots, (Ha, Wa) = _octave_layout(hb, wb, n_octaves)
    dev = img.device
    # float32 thresholds as exact Python floats (no host copy to the device)
    c_dog = float(np.float32(thresh))
    cut = float(np.float32(0.8) * np.float32(thresh))
    sigma0 = math.sqrt(SIGMA_MIN ** 2 - SIGMA_IN ** 2) / DELTA_MIN
    v = _blur_jnp(_upsample2_jnp(img), sigma0)
    atlas = torch.zeros((Ha, Wa), dtype=torch.float32, device=dev)
    tables = []
    ho_f = 2.0 * h
    wo_f = 2.0 * w
    for o in range(len(sizes)):
        imgs = [v]
        for s in range(1, N_SPO + 3):
            rho = (SIGMA_MIN / DELTA_MIN) * math.sqrt(
                2 ** (2.0 * s / N_SPO) - 2 ** (2.0 * (s - 1) / N_SPO))
            imgs.append(_blur_jnp(imgs[-1], rho))
        g = torch.stack(imgs)
        dog = g[1:] - g[:-1]

        # original (unpadded) octave dims; candidates beyond are culled
        ho = math.ceil(ho_f)
        wo = math.ceil(wo_f)

        S, Hh, Ww = dog.shape
        mask = _extrema_mask_jnp(dog) & (dog.abs() >= cut)
        mask[:, ho - 1:, :] = False
        mask[:, :, wo - 1:] = False
        K = max(256, _K0 >> o)
        score = torch.where(mask, dog.abs(), 0.0).reshape(-1)
        top, idx = _top_k(score, min(K, score.shape[0]))
        cs = idx // (Hh * Ww)
        cy = (idx // Ww) % Hh
        cx = idx % Ww
        alive = top > 0.0
        rs, ry, rx, off, val, keep = _refine_device(
            dog, cs, cy, cx, alive, c_dog, ho, wo)
        tables.append(torch.stack([
            rs.float(), ry.float(), rx.float(), off[:, 0], off[:, 1],
            off[:, 2], val, (keep & alive).float()], dim=1))

        for s in range(1, N_SPO + 2):
            oy, ox = slots[(o, s)]
            atlas[oy:oy + Hh, ox:ox + Ww] = g[s]
        if o + 1 < len(sizes):
            v = g[N_SPO][::2, ::2]
            ho_f = math.ceil(ho_f) / 2.0
            wo_f = math.ceil(wo_f) / 2.0
    return atlas, tables


def _grad_fields_atlas(atlas):
    """Centred-difference gradient magnitude and orientation
    (``atan2(d/dcol, d/drow)``, the IPOL axis convention) of the atlas,
    edge samples repeated."""
    gy = 0.5 * (torch.cat([atlas[1:], atlas[-1:]], dim=0)
                - torch.cat([atlas[:1], atlas[:-1]], dim=0))
    gx = 0.5 * (torch.cat([atlas[:, 1:], atlas[:, -1:]], dim=1)
                - torch.cat([atlas[:, :1], atlas[:, :-1]], dim=1))
    return torch.hypot(gx, gy), torch.atan2(gx, gy)


def _patches(field, yc, xc, R):
    """(n, 2R+1, 2R+1) windows of ``field`` about the rounded centres,
    their starts clamped into the field as ``dynamic_slice`` clamps."""
    side = 2 * R + 1
    H, W = field.shape
    y0 = (torch.round(yc) - R).to(torch.int64).clamp(0, H - side)
    x0 = (torch.round(xc) - R).to(torch.int64).clamp(0, W - side)
    r = torch.arange(side, device=field.device)
    idx = ((y0[:, None, None] + r[None, :, None]) * W
           + x0[:, None, None] + r[None, None, :])
    return field.reshape(-1)[idx]


def _patch_coords(yc, xc, R, ylo, yhi, xlo, xhi):
    """Each patch sample's atlas row and column, and whether it lies in
    the job's valid box."""
    off = torch.arange(-R, R + 1, dtype=torch.float32, device=yc.device)
    ry = torch.round(yc)[:, None, None] + off[None, :, None]
    rx = torch.round(xc)[:, None, None] + off[None, None, :]
    inb = ((ry >= ylo[:, None, None]) & (ry <= yhi[:, None, None])
           & (rx >= xlo[:, None, None]) & (rx <= xhi[:, None, None]))
    return ry, rx, inb


def _ori_kernel_atlas(gmag, gori, yc, xc, sigma, ylo, yhi, xlo, xhi,
                      R=_R_ORI):
    """Smoothed 36-bin orientation histograms of a batch of jobs.

    yc/xc in atlas coords; [ylo,yhi]x[xlo,xhi] the per-job valid sample
    box (field interior, original-dims bounds) in atlas coords.  Each bin
    is a masked sum over the patch, so the order of the sums is fixed on
    every device (no scatter)."""
    m = _patches(gmag, yc, xc, R)
    o = _patches(gori, yc, xc, R)
    ry, rx, inb = _patch_coords(yc, xc, R, ylo, yhi, xlo, xhi)

    dy = ry - yc[:, None, None]
    dx = rx - xc[:, None, None]
    d2 = dy * dy + dx * dx
    sig = sigma[:, None, None]
    ls = LAMBDA_ORI * sig
    w = torch.exp(-d2 / (2 * (ls * ls))) * m
    win = torch.maximum((ry - torch.round(yc)[:, None, None]).abs(),
                        (rx - torch.round(xc)[:, None, None]).abs())
    w = torch.where((win <= torch.round(3 * LAMBDA_ORI * sig)) & inb, w,
                    0.0)

    bins = torch.remainder(torch.round(
        _BINS_PER_RAD * _remainder(o, _TWO_PI)).to(torch.int32), N_BINS)
    hist = torch.stack([torch.where(bins == b, w, 0.0).sum(dim=(1, 2))
                        for b in range(N_BINS)], dim=1)
    for _ in range(6):
        hist = (torch.roll(hist, 1, dims=1) + hist
                + torch.roll(hist, -1, dims=1)) / 3.0
    return hist


def _desc_kernel_atlas(gmag, gori, yc, xc, sigma, theta, ylo, yhi, xlo, xhi,
                       R=_R_DESC):
    """Quantised 128-d descriptors of a batch of oriented jobs, over
    patches of radius ``R`` (the JAX package's is always _R_DESC; a
    smaller one that holds every job's window adds up the same non-zero
    terms).  The trilinear histogram D[u, v, o] = sum_p w_p hat_u hat_v
    hat_o factorises over the bin axes, so for each u-cell it is one
    batched (v, P) x (P, o) product over the patch."""
    lam = LAMBDA_DESCR
    lim_win = lam * (N_HIST + 1.0) / N_HIST
    m = _patches(gmag, yc, xc, R)
    o = _patches(gori, yc, xc, R)
    ry, rx, inb = _patch_coords(yc, xc, R, ylo, yhi, xlo, xhi)

    dy = ry - yc[:, None, None]
    dx = rx - xc[:, None, None]
    ct = torch.cos(theta)[:, None, None]
    st = torch.sin(theta)[:, None, None]
    sig = sigma[:, None, None]
    u = (ct * dy + st * dx) / sig
    v = (-st * dy + ct * dx) / sig

    sel = (u.abs() < lim_win) & (v.abs() < lim_win) & inb
    w = torch.where(sel, m * torch.exp(-(u * u + v * v) / (2 * lam * lam)),
                    0.0)
    ang = _remainder(o - theta[:, None, None], _TWO_PI)

    N = yc.shape[0]
    P = m.shape[1] * m.shape[2]
    cu = ((u + lam) * N_HIST / (2 * lam) - 0.5).reshape(N, P)
    cv = ((v + lam) * N_HIST / (2 * lam) - 0.5).reshape(N, P)
    co = (ang * N_ORI / _TWO_PI).reshape(N, P)
    w = w.reshape(N, P)

    dev = yc.device
    iu = torch.arange(N_HIST, dtype=torch.float32, device=dev)
    Av = torch.clamp_min(1.0 - (cv[..., None] - iu).abs(), 0.0)
    io = torch.arange(N_ORI, dtype=torch.float32, device=dev)
    dcirc = (_remainder(co[..., None] - io + N_ORI / 2, float(N_ORI))
             - N_ORI / 2).abs()
    Ao = torch.clamp_min(1.0 - dcirc, 0.0)

    rows = []
    for k in range(N_HIST):
        wk = w * torch.clamp_min(1.0 - (cu - float(k)).abs(), 0.0)
        rows.append(torch.einsum('npv,npo->nvo', Av * wk[..., None], Ao))
    desc = torch.stack(rows, dim=1).reshape(N, 128)

    nrm = torch.sqrt((desc * desc).sum(dim=1, keepdim=True))
    desc = torch.minimum(desc, 0.2 * nrm)
    nrm2 = torch.sqrt((desc * desc).sum(dim=1, keepdim=True))
    q = torch.clamp_max(torch.floor(512.0 * desc
                                    / torch.clamp_min(nrm2, 1e-30)), 255.0)
    return torch.where(torch.isfinite(q), q, 0.0)


def _dispatch_atlas(kern, gmag, gori, cols, chunk):
    """``kern`` over the jobs of ``cols`` (a (k, n) float32 array, one row
    per argument) in batches of ``chunk`` jobs; the n outputs in one
    tensor."""
    args = torch.from_numpy(np.ascontiguousarray(cols)).to(gmag.device)
    n = cols.shape[1]
    outs = [kern(gmag, gori, *args[:, i:i + chunk])
            for i in range(0, n, chunk)]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _desc_radius(sigma_oct):
    """Each job's descriptor patch radius: the smallest of
    _R_DESC_CLASSES that holds its window (no sample farther than
    lim_win * sqrt(2) * sigma + 0.5 from the rounded centre is selected;
    one more for rounding), at most _R_DESC, the JAX package's radius."""
    lim_win = LAMBDA_DESCR * (N_HIST + 1.0) / N_HIST
    need = np.ceil(lim_win * math.sqrt(2.0) * np.asarray(sigma_oct, np.float64)
                   + 1.5)
    classes = np.asarray(_R_DESC_CLASSES)
    return classes[np.minimum(np.searchsorted(classes, need),
                              len(classes) - 1)]


def _crop_bucket(arr):
    """Padded crop shape: the 128-px grid.  Part of the output contract:
    mirror padding does not commute with the pyramid decimation at deep
    octaves, so a crop's keypoints are only reproducible at the SAME
    bucket, which is why this is a fixed deterministic rule."""
    h, w = arr.shape
    return (-(-h // 128) * 128, -(-w // 128) * 128)


def _dispatch_pyramid(arr, thresh_dog, n_octaves, n_scales, bucket, device):
    """Pad a crop to its bucket, upload it and run the pyramid and the
    gradient fields; returns a state dict of device tensors + metadata."""
    arr = np.asarray(arr, dtype=np.float32)
    h, w = arr.shape
    hb, wb = bucket
    # symmetric-pad to the bucket (numpy symmetric == IPOL half-sample
    # reflection); symmetric extension commutes with the blur cascade
    img = np.pad(arr, ((0, hb - h), (0, wb - w)), mode='symmetric') \
        if (hb != h or wb != w) else arr
    sizes, slots, _ = _octave_layout(hb, wb, n_octaves)
    atlas, tables = _pyramid_program(
        torch.from_numpy(np.ascontiguousarray(img)).to(device), h, w,
        np.float32(thresh_dog), n_octaves, n_scales)
    gmag, gori = _grad_fields_atlas(atlas)
    return dict(h=h, w=w, sizes=sizes, slots=slots, n_scales=n_scales,
                n_octaves=n_octaves, tables_dev=tables, gmag=gmag, gori=gori)


def _build_groups(st, tables):
    """Host: candidate tables -> per-(octave, scale) job groups."""
    h, w = st['h'], st['w']
    n_scales = st['n_scales']
    # the bucketed dims can admit one more octave than the original crop
    # would (the host loop stops on the true dims); cull the extras
    n_host = 0
    hh, ww = 2 * h, 2 * w
    for _ in range(st['n_octaves']):
        n_host += 1
        if min(hh, ww) // 2 < 12:
            break
        hh, ww = (hh + 1) // 2, (ww + 1) // 2

    groups = []
    for o, tab in enumerate(tables[:n_host]):
        keep = tab[:, 7] > 0
        if not keep.any():
            continue
        tab = tab[keep]
        delta = DELTA_MIN * 2 ** o
        s_id = tab[:, 0].astype(np.int64)
        ho, wo = int(math.ceil(2 * h / 2 ** o)), int(math.ceil(2 * w / 2 ** o))
        for s_idx in range(1, n_scales + 2):
            sel = s_id == s_idx
            if not sel.any():
                continue
            ys = tab[sel, 1] + tab[sel, 4]
            xs = tab[sel, 2] + tab[sel, 5]
            ss = tab[sel, 0] + tab[sel, 3]
            sigma = delta / DELTA_MIN * SIGMA_MIN * 2.0 ** (ss / n_scales)
            oy, ox = st['slots'][(o, s_idx)]
            groups.append(dict(
                delta=delta, ys=ys, xs=xs, sigma=sigma,
                sigma_oct=sigma / delta, oy=oy, ox=ox,
                ylo=oy + 1.0, yhi=oy + ho - 2.0,
                xlo=ox + 1.0, xhi=ox + wo - 2.0))
    return groups


def _group_cols(groups, fns):
    """Per-group per-job columns concatenated into one job stream: a
    (len(fns), n) float32 array."""
    return np.stack([np.concatenate([np.broadcast_to(
        np.asarray(fn(g), np.float32), (len(g['_jobs']),)) for g in groups])
        for fn in fns])


def _dispatch_ori(st, groups):
    """Orientation histograms for ALL candidates of one image as ONE
    merged job stream."""
    for g in groups:
        g['_jobs'] = g['ys']            # phase-1 jobs = all candidates
    n_all = sum(len(g['ys']) for g in groups)
    if n_all == 0:
        return None, 0
    # the arguments of _ori_kernel_atlas: y, x, sigma and the valid box
    cols = _group_cols(groups, [
        lambda g: g['ys'] + g['oy'], lambda g: g['xs'] + g['ox'],
        lambda g: g['sigma_oct'], lambda g: g['ylo'], lambda g: g['yhi'],
        lambda g: g['xlo'], lambda g: g['xhi']])
    return _dispatch_atlas(_ori_kernel_atlas, st['gmag'], st['gori'], cols,
                           _CHUNK_ORI), n_all


def _dispatch_desc(st, groups, hist_all):
    """Histogram peaks -> oriented descriptor jobs, one merged stream per
    image."""
    pos = 0
    for grp in groups:
        n = len(grp['ys'])
        oris = _hist_peaks(hist_all[pos:pos + n])
        pos += n
        grp['job_kp'] = np.array([i for i, a in enumerate(oris) for _ in a],
                                 dtype=np.int64)
        grp['job_theta'] = np.array([t for a in oris for t in a],
                                    dtype=np.float32)
        grp['_jobs'] = grp['job_kp']    # phase-2 jobs = oriented keypoints
    m_all = sum(len(g['job_kp']) for g in groups)
    if m_all == 0:
        return None, 0
    # the arguments of _desc_kernel_atlas: y, x, sigma, theta and the box
    cols = _group_cols(groups, [
        lambda g: g['ys'][g['job_kp']] + g['oy'],
        lambda g: g['xs'][g['job_kp']] + g['ox'],
        lambda g: g['sigma_oct'][g['job_kp']], lambda g: g['job_theta'],
        lambda g: g['ylo'], lambda g: g['yhi'], lambda g: g['xlo'],
        lambda g: g['xhi']])
    # jobs by patch radius, each class in batches of _DESC_SAMPLES samples
    radius = _desc_radius(cols[2])
    dev = st['gmag'].device
    out = torch.empty((m_all, 128), dtype=torch.float32, device=dev)
    for R in np.unique(radius):
        idx = np.nonzero(radius == R)[0]
        out[torch.from_numpy(idx).to(dev)] = _dispatch_atlas(
            functools.partial(_desc_kernel_atlas, R=int(R)), st['gmag'],
            st['gori'], cols[:, idx], max(1, _DESC_SAMPLES
                                          // (2 * int(R) + 1) ** 2))
    return out, m_all


def _assemble_heads(groups, offset):
    """The (x, y, scale, theta) head columns of the keypoint rows, in the
    order of the concatenated descriptor job stream."""
    rows = []
    for grp in groups:
        jk = grp['job_kp']
        if len(jk) == 0:
            continue
        rows.append(np.column_stack([grp['xs'][jk] * grp['delta'],
                                     grp['ys'][jk] * grp['delta'],
                                     grp['sigma'][jk], grp['job_theta']]))
    if not rows:
        return np.zeros((0, 4), dtype=np.float32)
    kp = np.vstack(rows).astype(np.float32)
    if offset is not None:
        kp[:, 0] += offset[0]
        kp[:, 1] += offset[1]
    return kp


def _split(flat, counts):
    """Host rows of many images, fetched as one tensor, split back."""
    out, k = [], 0
    for n in counts:
        out.append(flat[k:k + n])
        k += n
    return out


def keypoints_from_arrays(arrs, thresh_dogs, offsets=None, n_octaves=8,
                          n_scales=3, device_desc=False, device=None,
                          timings=None):
    """SIFT detection for MANY crops (``keypoints_from_arrays_tpu`` in the
    JAX package), breadth-first: every crop's pyramid, then ONE copy of
    all candidate tables to the host, every crop's orientation jobs, ONE
    copy of all histograms, then every crop's descriptor jobs.  Per-image
    results equal :func:`keypoints_from_array` bitwise (each image's
    computation is independent of the others).

    Returns per image (n, 132) float32 rows (x, y, scale, orientation,
    128-d descriptor).  ``device_desc=True`` keeps the descriptors on the
    device and returns per image ``{'meta': (m, 4) float32 [x, y, scale,
    theta] on the host, 'desc': (m, 128) float32 tensor on the device,
    'count': m}``.  ``device`` None runs on CUDA and raises without it;
    "cpu" runs there.  ``timings``, a dict, receives the seconds of the
    waves (pyramid with the table copy, orientations, descriptors), the
    device synchronised at each boundary."""
    dev = resolve(device)
    arrs = list(arrs)
    thresh_dogs = list(thresh_dogs)
    if offsets is None:
        offsets = [None] * len(arrs)
    # memory bound: at most _WAVE crops' atlases + gradient fields live on
    # the device at once
    if len(arrs) > _WAVE:
        out = []
        for i in range(0, len(arrs), _WAVE):
            out.extend(keypoints_from_arrays(
                arrs[i:i + _WAVE], thresh_dogs[i:i + _WAVE],
                offsets[i:i + _WAVE], n_octaves, n_scales, device_desc, dev,
                timings))
        return out
    clock = _Clock(dev, timings)
    states = [_dispatch_pyramid(a, t, n_octaves, n_scales,
                                _crop_bucket(np.asarray(a)), dev)
              for a, t in zip(arrs, thresh_dogs)]
    flat = [t for st in states for t in st['tables_dev']]
    fetched = _split(torch.cat(flat).cpu().numpy(), [len(t) for t in flat])
    k = 0
    all_groups = []
    for st in states:
        n = len(st['tables_dev'])
        all_groups.append(_build_groups(st, fetched[k:k + n]))
        k += n
    clock.tick('pyramid')

    ori = [_dispatch_ori(st, groups)
           for st, groups in zip(states, all_groups)]
    hist_dev = [h for h, _ in ori if h is not None]
    hists = _split(torch.cat(hist_dev).cpu().numpy() if hist_dev else
                   np.zeros((0, N_BINS), np.float32), [n for _, n in ori])
    clock.tick('orientation')

    desc = [_dispatch_desc(st, groups, hist_all)
            for st, groups, hist_all in zip(states, all_groups, hists)]
    if device_desc:
        out = [{'meta': _assemble_heads(groups, off),
                'desc': d if d is not None else
                torch.zeros((0, 128), dtype=torch.float32, device=dev),
                'count': m}
               for (d, m), groups, off in zip(desc, all_groups, offsets)]
    else:
        d_dev = [d for d, _ in desc if d is not None]
        descs = _split(torch.cat(d_dev).cpu().numpy() if d_dev else
                       np.zeros((0, 128), np.float32), [m for _, m in desc])
        out = [np.hstack([_assemble_heads(groups, off), d])
               .astype(np.float32)
               for groups, d, off in zip(all_groups, descs, offsets)]
    clock.tick('descriptor')
    return out


def keypoints_from_array(arr, thresh_dog=0.0133, n_octaves=8, n_scales=3,
                         offset=None, device=None):
    """SIFT detection of one crop (``keypoints_from_array_tpu`` in the JAX
    package): rows of x, y, scale, orientation and the 128-d
    descriptor."""
    return keypoints_from_arrays([arr], [thresh_dog], [offset], n_octaves,
                                 n_scales, device=device)[0]


class _Clock:
    """Seconds between ticks into ``timings[name]`` (summed over calls),
    the device synchronised first; a no-op without ``timings``."""

    def __init__(self, device, timings):
        self.device = device
        self.timings = timings
        self.t = time.perf_counter()

    def tick(self, name):
        if self.timings is None:
            return
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.t
        self.t = now
