"""Multi-scale multi-window correlation stereo (the msmw matchers).

Counterpart of ``s2p_tpu/ops/msmw.py``, the msmw2 chain of the reference
s2p (``iip_stereo_correlation_multi_win2 -i 1 -n 4 -p 4 -W 5 -x 9 -y 9 -r
1 -d 1``): a 4-level pyramid solved coarse to fine, each level searching a
per-pixel range from the coarser level's accepted disparities; per level
both directions over five oriented 9x9-family windows (the mean-removed
SSD of the best window), the self-similarity test, the pixelian
reciprocity and the grain filter; a parabola subpixel fit.

:func:`_scale_step`, a level's device work, runs in torch on the tensors'
device; the pyramid, the range maps and the grain filter are host numpy
and scipy, copied from the JAX package.

The window means.  The JAX package's ``_box`` takes differences of two
``jnp.cumsum`` prefix sums.  On a full tile those reach about 2.6e10 and
every order of summation (XLA's on the CPU, numpy's, torch's parallel
scan on the card) gives other costs.  The port sums each window directly
instead, in one order on both devices (:func:`box_sum`: B1,
``csrc/box.cu``, on CUDA tensors; :func:`box_sum_plain` on CPU tensors).
Where every prefix sum is an integer below 2^24 (an integer image of a
small range) the two orders give the same sums, and the port equals the
JAX package's jitted level bit for bit; elsewhere it equals it within the
rounding of those prefix sums (tests/test_torch_msmw.py states the
criterion).  XLA's CPU run contracts three multiply-adds into fused ones
(the cost ``m2/mc - q*q``, the variance ``sum(a^2)/81 - ma*ma`` and the
self-similarity's shifted image ``0.875*src + 0.125*nxt``): the port
rounds them once too (``sgm_kernels._fma32``), on both devices.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..device import resolve
from .sgm_kernels import _fma32

_launches = {'box': 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_BOX_ARGS = [_P, _P, _I, _I, _I, _I, _I, _F, _P]


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return dict(_launches)


def reset_launch_counts():
    for k in _launches:
        _launches[k] = 0


# --------------------------------------------------------------------- #
# B1: box sums
# --------------------------------------------------------------------- #

def box_sum_plain(x, r: int, vertical: bool, scale: float = 0.0):
    """Plain version of :func:`box_sum`: the shifted planes of the
    zero-padded volume added from +0 in window order, then the product."""
    dim = 1 if vertical else 2
    n = x.shape[dim]
    pad = torch.nn.functional.pad(x, (0, 0, r, r) if vertical else (r, r))
    acc = torch.zeros_like(x)
    for t in range(2 * r + 1):
        acc = acc + pad.narrow(dim, t, n)
    return acc * scale if scale else acc


def box_sum(x, r: int, vertical: bool, scale: float = 0.0):
    """Sums of 2r + 1 consecutive values of a (B, H, W) float32 volume
    along H (``vertical``) or W, zero outside, times the float32
    ``scale`` where it is not 0.  A CPU tensor runs
    :func:`box_sum_plain`, a CUDA tensor one launch of B1
    (``csrc/box.cu``)."""
    if x.dtype != torch.float32 or x.dim() != 3:
        raise TypeError(f'box_sum: expected a 3-D float32 volume, got '
                        f'{x.dtype} {tuple(x.shape)}')
    if x.device.type == 'cpu':
        return box_sum_plain(x, r, vertical, scale)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel():
        _build.call('box', 's2p_box', _BOX_ARGS, x.data_ptr(),
                    out.data_ptr(), *x.shape, int(r), int(bool(vertical)),
                    scale)
        _launches['box'] += 1
    return out


def _box(a, ry: int, rx: int):
    """Mean over a (2ry + 1, 2rx + 1) window of the last two axes, zero
    outside: the vertical sums, then the horizontal ones times f32(1 /
    area), as XLA's CPU run of the JAX package's division rounds."""
    return _box_sums(a, ry, rx, _recip_area(ry, rx))


def _recip_area(ry: int, rx: int):
    return float(np.float32(1.0 / ((2 * ry + 1) * (2 * rx + 1))))


def _box_sums(a, ry: int, rx: int, scale: float = 0.0):
    """The window sums of :func:`_box`, times ``scale`` where it is not
    0."""
    shape = a.shape
    v = a.reshape((-1,) + tuple(shape[-2:]))
    v = box_sum(v, ry, True)
    v = box_sum(v, rx, False, scale)
    return v.reshape(shape)


def _shear(a, direction: int):
    """Roll row y of the last two axes by ``(y - h // 2) * direction``
    columns, so that a box over the sheared array averages along a
    diagonal window."""
    h, w = a.shape[-2:]
    dev = a.device
    shifts = (torch.arange(h, device=dev) - h // 2) * direction
    cols = (torch.arange(w, device=dev)[None, :] - shifts[:, None]) % w
    return torch.gather(a, -1, cols.expand(a.shape))


# (kind, ry, rx): oriented 9x9-family windows (the -W 5 orientation set)
_WINDOWS_5 = (('box', 4, 4), ('box', 1, 4), ('box', 4, 1),
              ('diag+', 1, 4), ('diag-', 1, 4))


def _window_costs(a, b_sh, fin_pair, need_var=False):
    """Mean-removed SSD of each window, minimum over the window set.

    a: (h, w); b_sh: (D, h, w) candidates; fin_pair: (D, h, w) bool,
    where both samples count.  Returns (best cost (D, h, w), the 9x9
    variance of a or None)."""
    d1 = a[None] - b_sh
    d2 = torch.where(fin_pair, d1 * d1, 0.0)
    d1 = torch.where(fin_pair, d1, 0.0)
    cnt = fin_pair.to(torch.float32)
    eps = torch.tensor(1e-6, dtype=torch.float32, device=a.device)
    best = var9 = None
    for kind, ry, rx in _WINDOWS_5:
        if kind == 'box':
            m2, m1, mc = (_box(v, ry, rx) for v in (d2, d1, cnt))
        else:
            sgn = 1 if kind == 'diag+' else -1
            m2, m1, mc = (_shear(_box(_shear(v, sgn), ry, rx), -sgn)
                          for v in (d2, d1, cnt))
        mc = torch.maximum(mc, eps)
        # E[(d - E d)^2] = E[d^2] - (E d)^2, the square fused into the
        # subtraction as XLA's CPU run does
        q = m1 / mc
        cost = _fma32(-q, q, m2 / mc)
        best = cost if best is None else torch.minimum(best, cost)
        if need_var and (kind, ry, rx) == ('box', 4, 4):
            # E[a^2] - ma^2, E[a^2]'s product by 1/81 fused into the
            # subtraction as XLA's CPU run does
            ma = _box(a, 4, 4)
            var9 = _fma32(_box_sums(a * a, 4, 4), _recip_area(4, 4),
                          -(ma * ma))
    return best, var9


def _wta_subpix(cost, disp_min: int):
    """WTA over the candidates of a (D, h, w) cost with a parabola fit:
    (disp, best cost)."""
    D = cost.shape[0]
    dev = cost.device
    ids = torch.arange(D, device=dev)[:, None, None]
    mn = cost.amin(dim=0, keepdim=True)
    k = torch.where(cost == mn, ids, D).amin(dim=0)          # first minimum

    def at(idx):
        return torch.gather(cost, 0, idx[None])[0]

    c1 = at(k)
    c0 = at((k - 1).clamp(min=0))
    c2 = at((k + 1).clamp(max=D - 1))
    c0 = torch.where(torch.isfinite(c0), c0, c1 + 1e3)
    c2 = torch.where(torch.isfinite(c2), c2, c1 + 1e3)
    den = c0 - 2 * c1 + c2
    eps = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    off = torch.where((k > 0) & (k < D - 1) & (den > eps),
                      0.5 * (c0 - c2) / torch.maximum(den, eps), 0.0)
    disp = (k + disp_min).to(torch.float32) + off.clamp(-0.5, 0.5)
    return disp, c1


def _direction(src, dst, fin_s, fin_d, lo_map, hi_map, dmin_dir: int,
               D: int, self_sim: bool, min_dist: float):
    """One direction of a level: (disparity, accepted) of each pixel of
    ``src`` matched in ``dst``."""
    dev = src.device
    h, ws = src.shape
    wd = dst.shape[1]
    ks = torch.arange(D, device=dev)
    xs = torch.arange(ws, device=dev)[None, :] + dmin_dir + ks[:, None]
    inb = (xs >= 0) & (xs < wd)                              # (D, w)
    xs_c = xs.clamp(0, wd - 1)
    d_sh = dst[:, xs_c].permute(1, 0, 2)                     # (D, h, w)
    fin_pair = fin_s[None] & fin_d[:, xs_c].permute(1, 0, 2) & inb[:, None]
    dvals = (dmin_dir + ks)[:, None, None]
    in_rng = (dvals >= lo_map[None]) & (dvals <= hi_map[None])
    ok_pair = fin_pair & in_rng
    cost, var9 = _window_costs(src, d_sh, ok_pair, need_var=min_dist > 0)
    cost = torch.where(ok_pair, cost, float('inf'))
    disp, cbest = _wta_subpix(cost, dmin_dir)
    ok = fin_s & torch.isfinite(cbest)
    if min_dist > 0:
        ok = ok & (cbest <= min_dist * torch.maximum(
            var9, torch.tensor(1e-12, dtype=torch.float32, device=dev)))
    if self_sim:
        # the reference image must not match itself at an offset of 2 px
        # or more better than it matches the secondary, by more than the
        # distance of a 1/8 px translation (fDistTrans)
        offs = ks - D // 2
        xs_s = torch.arange(ws, device=dev)[None, :] + offs[:, None]
        inb_s = (xs_s >= 0) & (xs_s < ws)
        s_sh = src[:, xs_s.clamp(0, ws - 1)].permute(1, 0, 2)
        far = (offs.abs() >= 2)[:, None, None]
        fp = fin_s[None] & inb_s[:, None] & far
        scost, _ = _window_costs(src, s_sh, fp)
        smin = torch.where(fp, scost, float('inf')).amin(dim=0)
        f = 0.125
        nxt = torch.cat([src[:, 1:], src[:, -1:]], dim=1)
        prv = torch.cat([src[:, :1], src[:, :-1]], dim=1)
        ones = fin_s[None]
        ctp, _ = _window_costs(src, _fma32(src, 1 - f, f * nxt)[None], ones)
        ctm, _ = _window_costs(src, _fma32(src, 1 - f, f * prv)[None], ones)
        ftrans = torch.maximum(ctp[0], ctm[0])
        ok = ok & ((smin - cbest) > ftrans)
    return disp, ok


def _reciprocity(dA, okA, dB, okB, wB):
    """Pixelian reciprocity (tau 1 px): A's pixel x survives where B's
    pixel round(x + dA) is accepted and |dA + dB| <= 1."""
    w = dA.shape[1]
    xs = torch.arange(w, device=dA.device)[None, :]
    x2 = torch.round(xs + dA).to(torch.int32).clamp(0, wB - 1).long()
    return okA & torch.gather(okB, 1, x2) & (
        torch.abs(dA + torch.gather(dB, 1, x2)) <= 1.0)


def _scale_step(im1, im2, dmin_map, dmax_map, idmin_map, idmax_map,
                disp_min: int, D: int, self_sim: bool = True,
                min_dist: float = -1.0):
    """One msmw2 level on (h, w) float32 tensors of one device: both
    directions over the per-pixel ranges, then the pixelian reciprocity.
    Returns (dL, dR, okL, okR)."""
    a = torch.nan_to_num(im1)
    b = torch.nan_to_num(im2)
    fin1 = torch.isfinite(im1)
    fin2 = torch.isfinite(im2)
    dL, okL = _direction(a, b, fin1, fin2, dmin_map, dmax_map, disp_min, D,
                         self_sim, min_dist)
    dR, okR = _direction(b, a, fin2, fin1, idmin_map, idmax_map,
                         -(disp_min + D - 1), D, self_sim, min_dist)
    okL = _reciprocity(dL, okL, dR, okR, im2.shape[1])
    okR = _reciprocity(dR, okR, dL, okL, im1.shape[1])
    return dL, dR, okL, okR


# --------------------------------------------------------------------- #
# Host: the pyramid, the range maps, the grain filter
# --------------------------------------------------------------------- #

def _downsample2(img):
    """Gaussian(0.8) prefilter + factor-2 subsampling (cflimage::subSample)."""
    from scipy import ndimage
    src = np.nan_to_num(img).astype(np.float32)
    blur = ndimage.gaussian_filter(src, 0.8, mode='nearest')
    nanm = ~np.isfinite(img)
    out = blur[::2, ::2].copy()
    if nanm.any():
        out[nanm[::2, ::2]] = np.nan
    return out


def _update_range_maps(disp, ok, lo_glob, hi_glob, radius=4, margin=2):
    """Per-pixel accepted-range maps from a level's output
    (update_dmin_dmax of the reference's libstereo): local window min/max
    of the accepted disparities, +- margin, clamped to the global
    bounds."""
    from scipy import ndimage
    d = np.where(ok, disp, np.nan)
    size = 2 * radius + 1
    with np.errstate(invalid='ignore'):
        lo = ndimage.minimum_filter(np.nan_to_num(d, nan=+1e9), size=size)
        hi = ndimage.maximum_filter(np.nan_to_num(d, nan=-1e9), size=size)
    none = lo > 1e8
    lo = np.where(none, lo_glob, lo - margin)
    hi = np.where(none, hi_glob, hi + margin)
    return (np.clip(lo, lo_glob, hi_glob).astype(np.float32),
            np.clip(hi, lo_glob, hi_glob).astype(np.float32))


def _upsample_range(lo, hi, shape, lo_glob, hi_glob):
    """Range maps to the next finer level: x2 in value, -/+2 margin,
    nearest-neighbour upsample, global clamp."""
    from scipy import ndimage
    zoom = (shape[0] / lo.shape[0], shape[1] / lo.shape[1])
    lo_u = ndimage.zoom(lo, zoom, order=0) * 2.0 - 2.0
    hi_u = ndimage.zoom(hi, zoom, order=0) * 2.0 + 2.0
    return (np.clip(lo_u, lo_glob, hi_glob).astype(np.float32),
            np.clip(hi_u, lo_glob, hi_glob).astype(np.float32))


def _grain_filter(ok, min_area):
    """Reject connected components of the valid mask below min_area."""
    if min_area <= 1:
        return ok
    from scipy import ndimage
    lab, n = ndimage.label(ok)
    if n == 0:
        return ok
    areas = np.bincount(lab.ravel())
    keep = areas >= min_area
    keep[0] = False
    return keep[lab]


def disparity(im1, im2, disp_min, disp_max, n_scales=4, grain_area=25,
              min_dist=-1.0, device=None):
    """MSMW disparity of a rectified pair; returns numpy (disp, valid).

    Args:
        n_scales: pyramid depth (the reference's ``-n 4``).
        grain_area: minimum connected-component area of the valid mask at
            the finest level (halved per level).
        min_dist: optional distance-vs-variance acceptance threshold
            (``-d``); <= 0 disables.
        device: None for CUDA (raises without it), or "cpu": where each
            level's :func:`_scale_step` runs.
    """
    dev = resolve(device)
    im1 = np.asarray(im1, np.float32)
    im2 = np.asarray(im2, np.float32)
    disp_min = int(np.floor(disp_min))
    disp_max = int(np.ceil(disp_max))

    # the pyramid, finest first
    pyr1, pyr2 = [im1], [im2]
    for _ in range(n_scales - 1):
        if min(pyr1[-1].shape) < 32 or min(pyr2[-1].shape) < 32:
            break
        pyr1.append(_downsample2(pyr1[-1]))
        pyr2.append(_downsample2(pyr2[-1]))
    levels = len(pyr1)

    def up(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

    lo = hi = ilo = ihi = None
    okL = dL = None
    for lev in range(levels - 1, -1, -1):
        s = 2.0 ** lev
        lo_g = disp_min / s - 1.0
        hi_g = disp_max / s + 1.0
        a, b = pyr1[lev], pyr2[lev]
        if lo is None:
            lo = np.full(a.shape, lo_g, np.float32)
            hi = np.full(a.shape, hi_g, np.float32)
            ilo = np.full(b.shape, -hi_g, np.float32)
            ihi = np.full(b.shape, -lo_g, np.float32)
        dmin_l = int(np.floor(lo_g))
        D = int(np.ceil(hi_g)) - dmin_l + 1
        D = -(-D // 8) * 8
        out = _scale_step(up(a), up(b), up(lo), up(hi), up(ilo), up(ihi),
                          dmin_l, D, self_sim=True, min_dist=float(min_dist))
        dL, dR, okL, okR = (t.cpu().numpy() for t in out)
        area = max(int(grain_area / s), 1)
        okL = _grain_filter(okL, area)
        okR = _grain_filter(okR, area)
        if lev > 0:
            lo_c, hi_c = _update_range_maps(dL, okL, lo_g, hi_g)
            ilo_c, ihi_c = _update_range_maps(dR, okR, -hi_g, -lo_g)
            s_next = 2.0 ** (lev - 1)
            lo, hi = _upsample_range(lo_c, hi_c, pyr1[lev - 1].shape,
                                     disp_min / s_next - 1.0,
                                     disp_max / s_next + 1.0)
            ilo, ihi = _upsample_range(ilo_c, ihi_c, pyr2[lev - 1].shape,
                                       -(disp_max / s_next + 1.0),
                                       -(disp_min / s_next - 1.0))

    disp = np.where(okL, dL, np.nan).astype(np.float32)
    return disp, okL
