"""Semi-global matching: the classic SGM matcher and its lax route.

Counterpart of ``s2p_tpu/ops/sgm.py``.  :func:`sgm_match` takes the route
the JAX package's ``_use_pallas`` would take with the Pallas backend:

  * the kernels (:func:`sgm_kernels.match_kernels`: the four passes with
    the census cost built in the scan, K4a, then the fused WTA with the
    right-reference disparity, K5) for ``mgm=False`` with the census
    cost, windows up to 5x5, a pair of equal shape and H, W and D
    multiples of 8;
  * the lax route everywhere else: the cost volume (census over any
    window, :func:`census.census_cost_volume_dyn`, or Birchfield-Tomasi,
    :func:`census.birchfield_tomasi_cost_volume`), then either the MGM
    wavefront (``mgm=True``, :func:`mgm.mgm_aggregate`) or eight
    independent scans (:func:`_scan_pass`), and the WTA with its subpixel
    fit in plain torch on the tensors' device.

Then the direction-consensus confidence, the left-right test (``lr_mode``
'volume' from the right-reference map, 'full' from a second match with
the images swapped) and the NaN-aware median variants.
:func:`sgm_match_batch` runs a bucket of tiles with per-tile disparity
bases, each on the lax route.  As in
the JAX package, ``uniqueness_ratio`` applies on the lax route only: the
kernel route keeps no aggregated volume.  The results equal the JAX
package's to the bit (its jitted run on the lax route).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from .census import bt_cost_sum, census_cost_volume_dyn
from .mgm import mgm_aggregate
from .sgm_kernels import _VALID_BIT, _fma32, match_kernels

_DIRS_8 = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1), (1, -1), (-1, 1))


@dataclasses.dataclass(frozen=True)
class SgmParams:
    """Aggregation parameters, with the JAX package's fields and defaults
    (its ``backend`` field has no counterpart: the device of the tensors
    chooses the route)."""
    census_win: int = 5
    cost: str = 'census'        # 'census' or 'bt' (Birchfield-Tomasi)
    p1: float = 8.0
    p2: float = 32.0
    nb_dir: int = 8
    subpix: str = 'vfit'        # 'vfit', 'parabola' or 'none'
    median: bool = True         # MEDIAN=1 3x3 median filter
    lr_tau: float = 1.0         # TESTLRRL_TAU
    lr_enabled: bool = True     # TESTLRRL
    speckle_min_area: int = 0   # REMOVESMALLCC (0 = off)
    mgm: bool = True            # MGM recursion vs classic SGM scans
    mgm_neighbors: int = 3      # causal predecessors per traversal (TSGM)
    min_confidence: float = 0.0  # drop pixels below this consensus score
    uniqueness_ratio: float = 0.0  # OpenCV-SGBM uniqueness check (lax only)
    lr_mode: str = 'volume'     # 'volume' or 'full' (second aggregation)
    p2_edge_scale: float = 1.0  # P2 multiplier at strong intensity edges
    lr_int: bool = False        # LR test on rounded disparities
    median_first: bool = False  # median BEFORE the LR test
    median_fill: bool = False   # the final median may fill rejected pixels
    fill_coh_tau: float = 0.0   # fill only where the 3x3 spread <= tau
    overcount_fix: bool = True  # MGM energy overcount fix (mgm engine only)


def _nan_median3(x):
    """3x3 NaN-aware median (lower median for even valid counts) of an
    (h, w) map, by an odd-even transposition network over the 9 taps."""
    h, w = x.shape
    pad = torch.nn.functional.pad(x, (1, 1, 1, 1), value=float('nan'))
    taps = [pad[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    n = sum(torch.isfinite(t).to(torch.int32) for t in taps)
    v = [torch.where(torch.isnan(t), float('inf'), t) for t in taps]
    for r in range(9):
        for i in range(r % 2, 8, 2):
            lo = torch.minimum(v[i], v[i + 1])
            hi = torch.maximum(v[i], v[i + 1])
            v[i], v[i + 1] = lo, hi
    idx = (n - 1).clamp(min=0) // 2
    med = v[0]
    for k in range(1, 9):
        med = torch.where(idx == k, v[k], med)
    return torch.where(n > 0, med, float('nan'))


def _nan_spread3(x):
    """max - min of the finite values in each 3x3 neighbourhood."""
    h, w = x.shape
    pad = torch.nn.functional.pad(x, (1, 1, 1, 1), value=float('nan'))
    lo = torch.full_like(x, float('inf'))
    hi = torch.full_like(x, float('-inf'))
    for dy in range(3):
        for dx in range(3):
            t = pad[dy:dy + h, dx:dx + w]
            fin = torch.isfinite(t)
            lo = torch.minimum(lo, torch.where(fin, t, float('inf')))
            hi = torch.maximum(hi, torch.where(fin, t, float('-inf')))
    return hi - lo


def _median_fill(disp, valid, coh_tau):
    """NaN-aware 3x3 median that also fills invalid pixels from valid
    neighbours; with ``coh_tau`` > 0 only where the neighbourhood spread
    is <= tau."""
    med = _nan_median3(disp)
    if coh_tau > 0:
        coherent = _nan_spread3(disp) <= coh_tau
        med = torch.where(valid | coherent, med, float('nan'))
    return med, torch.isfinite(med)


def _gradient(g, dim):
    """``jnp.gradient`` along one axis of a 2-D map with unit spacing:
    one-sided differences at the ends, halved central ones inside."""
    n = g.shape[dim]
    upper = g.narrow(dim, 1, 1) - g.narrow(dim, 0, 1)
    lower = g.narrow(dim, n - 1, 1) - g.narrow(dim, n - 2, 1)
    inner = (g.narrow(dim, 2, n - 2) - g.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([upper, inner, lower], dim=dim)


def _edge_p2_map(im1, p2, scale):
    """Edge-aware penalty: P2 scaled down across strong intensity edges
    (threshold: mean + 2 std of the gradient magnitude)."""
    g = torch.nan_to_num(im1)
    gy = torch.abs(_gradient(g, 0))
    gx = torch.abs(_gradient(g, 1))
    gm = torch.maximum(gx, gy)
    thr = gm.mean() + 2.0 * gm.std(unbiased=False)
    return torch.where(gm > thr,
                       torch.tensor(p2 * scale, dtype=torch.float32,
                                    device=g.device),
                       torch.tensor(p2, dtype=torch.float32, device=g.device))


def _p2_map(im1, params, p2_scale=None):
    """Per-pixel P2: edge-aware attenuation and/or an external
    multiplicative weight map; None for the constant P2."""
    p2_vol = None
    if params.p2_edge_scale != 1.0:
        p2_vol = _edge_p2_map(im1, params.p2, params.p2_edge_scale)
    if p2_scale is not None:
        base = p2_vol if p2_vol is not None else torch.full(
            im1.shape, params.p2, dtype=torch.float32, device=im1.device)
        p2_vol = base * p2_scale
    return p2_vol


def _min_convolution(L, p1, p2):
    """SGM penalty term of a predecessor row, (N, D) -> (N, D):
    min(L[d], L[d +- 1] + P1, min_d L + P2) - min_d L; ``p2`` is a scalar
    or an (N, 1) per-pixel penalty."""
    inf = torch.full_like(L[:, :1], float('inf'))
    lm = torch.cat([inf, L[:, :-1]], dim=1)
    lp = torch.cat([L[:, 1:], inf], dim=1)
    m = L.amin(dim=1, keepdim=True)
    return torch.minimum(torch.minimum(L, torch.minimum(lm, lp) + p1),
                         m + p2) - m


def _scan_pass(cost, dx, dy, p1, p2, p2_vol=None):
    """One classic SGM direction L_r over an (H, W, D) volume: a loop over
    the scan axis (y when ``dy`` != 0, else x) whose carry, shifted
    laterally by the diagonal's offset, feeds the min-convolution; the
    first line and the lanes shifted in from outside get no penalty term.
    ``p2_vol`` is an optional (H, W) per-pixel P2."""
    if dy == 0:
        vol = cost.transpose(0, 1)                   # (W, H, D)
        flip, lat = dx < 0, 0
    else:
        vol = cost
        flip, lat = dy < 0, dx
    if flip:
        vol = vol.flip(0)
    n, m, D = vol.shape
    dev = vol.device
    p1 = torch.tensor(p1, dtype=torch.float32, device=dev)
    if p2_vol is None:
        p2_rows = torch.tensor(p2, dtype=torch.float32,
                               device=dev).expand(n, m, 1)
    else:
        pv = p2_vol.transpose(0, 1) if dy == 0 else p2_vol
        p2_rows = (pv.flip(0) if flip else pv)[..., None]
    edge = torch.zeros(m, dtype=torch.bool, device=dev)
    if lat > 0:
        edge[:lat] = True
    elif lat < 0:
        edge[lat:] = True
    out = torch.empty_like(vol)
    L = torch.zeros((m, D), dtype=torch.float32, device=dev)
    for i in range(n):
        if i == 0:
            L = vol[0] + torch.zeros_like(L)
        else:
            Lp = torch.roll(L, lat, dims=0) if lat else L
            c = _min_convolution(Lp, p1, p2_rows[i])
            L = vol[i] + torch.where(edge[:, None], 0.0, c)
        out[i] = L
    if flip:
        out = out.flip(0)
    return out.transpose(0, 1) if dy == 0 else out


def _argmin_last(S):
    """Lowest index of the minimum over the last axis (int64)."""
    D = S.shape[-1]
    mn = S.amin(dim=-1, keepdim=True)
    ids = torch.arange(D, device=S.device)
    return torch.where(S == mn, ids, D).amin(dim=-1)


def _subpixel(S, d_int, mode):
    """Subpixel offset from the aggregated costs around the WTA index of
    an (..., D) volume: a V fit ('vfit') or a parabola ('parabola'),
    clipped to +-0.5, zero at the range's ends; non-finite neighbours
    count as the minimum plus 1e6."""
    D = S.shape[-1]

    def at(idx):
        return torch.gather(S, -1, idx.unsqueeze(-1)).squeeze(-1)

    c1 = at(d_int)
    c0 = at((d_int - 1).clamp(min=0))
    c2 = at((d_int + 1).clamp(max=D - 1))
    big = c1 + 1e6
    c0 = torch.where(torch.isfinite(c0), c0, big)
    c2 = torch.where(torch.isfinite(c2), c2, big)
    interior = (d_int > 0) & (d_int < D - 1)
    eps = torch.tensor(1e-9, dtype=torch.float32, device=S.device)
    if mode == 'vfit':
        den = 2.0 * (torch.maximum(c0, c2) - c1)
        off = (c0 - c2) / torch.maximum(den, eps)
    elif mode == 'parabola':
        den = c0 - 2.0 * c1 + c2
        off = 0.5 * (c0 - c2) / torch.maximum(den, eps)
    else:
        return torch.zeros_like(c1)
    return torch.where(interior, off.clamp(-0.5, 0.5), 0.0)


def _right_disparity(S, disp_min: int, subpix_mode='vfit'):
    """Right-reference disparity from the left volume: the WTA of
    S_R[y, x2, k] = S[y, x2 - (disp_min + k), k] (inf outside the image)
    with its subpixel fit, negated."""
    h, w, D = S.shape
    dev = S.device
    ks = torch.arange(D, device=dev)
    xs = torch.arange(w, device=dev)[:, None] - (disp_min + ks)[None, :]
    inb = (xs >= 0) & (xs < w)
    S_R = S[:, xs.clamp(0, w - 1), ks[None, :]]
    S_R = torch.where(inb[None], S_R, float('inf'))
    kR = _argmin_last(S_R)
    off = _subpixel(S_R, kR, subpix_mode)
    return -((float(disp_min) + kR.to(torch.float32)) + off)


def _use_kernels(shape1, shape2, D, params) -> bool:
    """The JAX package's ``_use_pallas`` with the Pallas backend: the
    kernels take the classic scans of a census cost over windows up to
    5x5 on a pair of equal shape, with H, W and D multiples of 8."""
    return (not params.mgm and params.cost == 'census'
            and params.census_win ** 2 - 1 <= _VALID_BIT
            and tuple(shape1) == tuple(shape2)
            and shape1[0] % 8 == 0 and shape1[1] % 8 == 0 and D % 8 == 0)


def _aggregate(im1, im2, disp_min: int, D: int, params, p2_scale=None):
    """The lax route's cost volume and aggregation: (S (H, W, D), valid1
    (H, W), votes list of (H, W) int maps in direction order)."""
    p2_vol = _p2_map(im1, params, p2_scale)
    if params.cost == 'bt':
        base, scale, val1 = bt_cost_sum(im1, im2, disp_min,
                                        disp_min + D - 1, params.census_win)
        cost = base if scale == 1.0 else base * scale
    else:
        cost, val1 = census_cost_volume_dyn(im1, im2, disp_min, D,
                                            params.census_win)
        base, scale = cost, 1.0
    if params.mgm:
        pm = None if p2_vol is None else p2_vol.expand(im1.shape)
        S, votes = mgm_aggregate(cost, params.p1, params.p2,
                                 nb_dir=params.nb_dir,
                                 tsgm=params.mgm_neighbors, p2_map=pm,
                                 overcount_fix=False)
        if params.overcount_fix:
            # S - (n - 1) * cost as the JAX package's jitted run computes
            # it: behind the box mean, the constants folded into
            # base * f32((n - 1) * scale) and the subtraction fused with
            # that product; elsewhere as written
            n = votes.shape[0]
            if scale == 1.0:
                S = S - (n - 1) * cost
            else:
                S = _fma32(base, -float(np.float32(n - 1)
                                        * np.float32(scale)), S)
        return S, val1, list(votes)
    S, votes = None, []
    for dx, dy in _DIRS_8[:max(2, min(params.nb_dir, 8))]:
        L = _scan_pass(cost, dx, dy, params.p1, params.p2, p2_vol)
        votes.append(_argmin_last(L))
        S = L if S is None else S + L
    return S, val1, votes


def _match_core(im1, im2, disp_min: int, D: int, params: SgmParams,
                p2_scale=None, p2_scale_r=None, allow_kernels=True):
    """The matcher body of the JAX package, on the kernels or the lax
    route (:func:`_use_kernels`); ``allow_kernels=False`` keeps it on the
    lax route, as the JAX package's batch entry does."""
    kernels = allow_kernels and _use_kernels(im1.shape, im2.shape, D,
                                             params)
    S = None
    if kernels:
        r = match_kernels(im1, im2, disp_min, disp_min + D - 1, params,
                          _p2_map(im1, params, p2_scale))
        d_int, votes, valid = r['d_int'], r['votes'], r['valid1']
        disp = r['disp_raw']
    else:
        S, valid, votes = _aggregate(im1, im2, disp_min, D, params,
                                     p2_scale)
        d_int = _argmin_last(S)
        disp = ((float(disp_min) + d_int.to(torch.float32))
                + _subpixel(S, d_int, params.subpix))

    nv = len(_DIRS_8[:max(2, min(params.nb_dir, 8))])
    consensus = sum((torch.abs(v - d_int) <= 1).to(torch.int32)
                    for v in votes)
    # count * f32(1 / n): how the JAX package's jitted division rounds
    confidence = consensus.to(torch.float32) * float(np.float32(1 / nv))

    if params.min_confidence > 0:
        valid = valid & (confidence >= params.min_confidence)
    if params.uniqueness_ratio > 0 and S is not None:
        # OpenCV SGBM uniqueness: every candidate farther than 1 from the
        # WTA must cost more than the minimum by the given margin; the
        # kernel route keeps no volume and skips it, as the JAX package's
        ks = torch.arange(S.shape[-1], device=S.device)
        far = torch.abs(ks - d_int[..., None]) > 1
        second = torch.where(far, S, float('inf')).amin(dim=-1)
        minS = torch.gather(S, -1, d_int[..., None])[..., 0]
        valid = valid & (second * (100.0 - params.uniqueness_ratio)
                         >= minS * 100.0)

    if params.median and params.median_first:
        disp = torch.where(valid, _nan_median3(
            torch.where(valid, disp, float('nan'))), float('nan'))
        valid = valid & torch.isfinite(disp)

    if params.lr_enabled:
        if params.lr_mode == 'full':
            # the true RL pass over the mirrored range, with the secondary
            # image's weight map
            dmin_r = -(disp_min + D - 1)
            if kernels:
                dR = match_kernels(im2, im1, dmin_r, -disp_min, params,
                                   _p2_map(im2, params, p2_scale_r)
                                   )['disp_raw']
            else:
                S_R, _, _ = _aggregate(im2, im1, dmin_r, D, params,
                                       p2_scale_r)
                kR = _argmin_last(S_R)
                dR = ((float(dmin_r) + kR.to(torch.float32))
                      + _subpixel(S_R, kR, params.subpix))
        elif kernels:
            dR = r['dR']
        else:
            dR = _right_disparity(S, disp_min)
        if params.median and params.median_first:
            dR = _nan_median3(dR)
        w = im1.shape[1]
        xs = torch.arange(w, dtype=torch.int32, device=disp.device)[None, :]
        x2 = torch.round(xs + disp).to(torch.int32).clamp(0, dR.shape[1] - 1)
        dR_at = torch.gather(dR, 1, x2.to(torch.int64))
        if params.lr_int:
            lr_ok = (torch.abs(torch.round(disp) + torch.round(dR_at))
                     <= params.lr_tau)
        else:
            lr_ok = torch.abs(disp + dR_at) <= params.lr_tau
        valid = valid & lr_ok

    disp = torch.where(valid, disp, float('nan'))
    if params.median and not params.median_first:
        if params.median_fill:
            disp, valid = _median_fill(disp, valid, params.fill_coh_tau)
        else:
            disp = torch.where(valid, _nan_median3(disp), float('nan'))
            valid = valid & torch.isfinite(disp)
    elif params.median and params.median_first and params.median_fill:
        disp, valid = _median_fill(disp, valid, params.fill_coh_tau)

    return {'disp': disp, 'valid': valid, 'confidence': confidence}


def sgm_match(im1, im2, disp_min: int, disp_max: int, params: SgmParams,
              p2_scale=None, p2_scale_r=None, device=None):
    """Dense disparity of a rectified pair by census + SGM aggregation.

    Args:
        im1, im2: rectified reference/secondary images (NaN = invalid),
            of one height.
        disp_min, disp_max: inclusive integer disparity bounds.
        params: aggregation parameters.
        p2_scale, p2_scale_r: optional multiplicative P2 weight maps of
            the reference and (for ``lr_mode='full'``) the secondary.
        device: None for CUDA (raises without it), or "cpu".

    Returns:
        dict of tensors on the device: 'disp' (float32, NaN invalid),
        'valid' (bool) and 'confidence' (float32 in [0, 1])."""
    D = int(disp_max) - int(disp_min) + 1
    dev = resolve(device)

    def to_dev(a):
        return (None if a is None
                else torch.as_tensor(a, dtype=torch.float32, device=dev))

    return _match_core(to_dev(im1), to_dev(im2), int(disp_min), D, params,
                       to_dev(p2_scale), to_dev(p2_scale_r))


def sgm_match_batch(im1_b, im2_b, disp_min_b, D: int, params: SgmParams,
                    device=None):
    """The matcher over a bucket of tiles of one padded shape, each with
    its own disparity base: the JAX package's ``sgm_match_batch``.

    Args:
        im1_b, im2_b: (n, H, W) float32 rectified pairs (NaN = invalid),
            arrays or tensors.
        disp_min_b: (n,) per-tile disparity bases.
        D: the candidate count of every tile.
        device: None for CUDA (raises without it), or "cpu".
    Each tile runs the lax route on its own, as the JAX package's
    ``allow_pallas=False`` does (the kernels' route adds the directions in
    another order); the Birchfield-Tomasi cost raises, as there.
    Returns:
        dict of (n, H, W) tensors on the device: 'disp' (float32, NaN
        invalid), 'valid' (bool) and 'confidence' (float32)."""
    if params.cost == 'bt':
        raise NotImplementedError(
            'Birchfield-Tomasi cost needs a static disparity range')
    dev = resolve(device)
    a = torch.as_tensor(im1_b, dtype=torch.float32, device=dev)
    b = torch.as_tensor(im2_b, dtype=torch.float32, device=dev)
    outs = [_match_core(a[k], b[k], int(dm), int(D), params,
                        allow_kernels=False)
            for k, dm in enumerate(np.asarray(disp_min_b).reshape(-1))]
    return {key: torch.stack([o[key] for o in outs])
            for key in ('disp', 'valid', 'confidence')}


def match_pair(im1, im2, disp_min, disp_max, params: SgmParams = SgmParams(),
               d_pad_multiple: int = 16, hw_pad_multiple: int = 64,
               p2_scale=None, p2_scale_r=None, device=None):
    """Host wrapper: pads the disparity range to a multiple of
    ``d_pad_multiple`` and the images to multiples of ``hw_pad_multiple``
    (NaN margin), runs :func:`sgm_match`, and returns numpy (disp, valid,
    confidence) cropped back to the input shape, without the candidates
    that the disparity padding introduced."""
    disp_min = int(np.floor(disp_min))
    disp_max = int(np.ceil(disp_max))
    D = disp_max - disp_min + 1
    D_pad = -(-D // d_pad_multiple) * d_pad_multiple
    disp_max_p = disp_min + D_pad - 1

    im1 = np.asarray(im1, dtype=np.float32)
    im2 = np.asarray(im2, dtype=np.float32)
    h, w = im1.shape
    Hp = -(-h // hw_pad_multiple) * hw_pad_multiple
    Wp = -(-max(w, im2.shape[1]) // hw_pad_multiple) * hw_pad_multiple

    def pad(a):
        out = np.full((Hp, Wp), np.nan, dtype=np.float32)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    def pad_scale(sc):
        if sc is None:
            return None
        out = np.ones((Hp, Wp), dtype=np.float32)
        out[:sc.shape[0], :sc.shape[1]] = sc
        return out

    out = sgm_match(pad(im1), pad(im2), disp_min, disp_max_p, params,
                    pad_scale(p2_scale), pad_scale(p2_scale_r), device=device)
    disp = out['disp'].cpu().numpy()[:h, :w]
    valid = out['valid'].cpu().numpy()[:h, :w]
    conf = out['confidence'].cpu().numpy()[:h, :w]
    # discard candidates introduced by the disparity padding
    bad = disp > disp_max + 0.5
    disp[bad] = np.nan
    valid &= ~bad
    return disp, valid, conf
