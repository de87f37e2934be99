"""Semi-global matching: the classic SGM census matcher on the kernels.

Counterpart of ``s2p_tpu/ops/sgm.py`` for the route its ``_use_pallas``
sends to the Pallas kernels: census cost, the independent-scan SGM
aggregation (:func:`sgm_kernels.match_kernels`: the four passes with the
cost built in the scan, K4a, then the fused WTA with the right-reference
disparity, K5), the direction-consensus confidence, the left-right test
(``lr_mode`` 'volume' from K5's right map, 'full' from a second match with
the images swapped) and the NaN-aware median variants.  The results equal
the JAX package's to the bit.

The JAX package sends the rest to its lax path, which is not ported: this
module raises ``NotImplementedError`` (ROADMAP M12) for ``mgm=True`` (the
wavefront recursion of ``ops/mgm.py``), the Birchfield-Tomasi cost,
census windows above 5x5, and a direct :func:`sgm_match` call on a pair of
unequal shapes or with H, W or D not a multiple of 8.  :func:`match_pair`
pads, so only the first three reach it.  As in the JAX package, the
kernel route has no aggregated volume, so ``uniqueness_ratio`` is not
applied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from .sgm_kernels import _VALID_BIT, match_kernels

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


def _check_kernel_route(shape1, shape2, D, params):
    """Raise where the JAX package would leave the kernels for its lax
    path, which the port does not have."""
    if params.mgm:
        raise NotImplementedError(
            'mgm=True runs the MGM wavefront recursion (s2p_tpu/ops/mgm.py), '
            'which is not ported yet (ROADMAP M12); use mgm=False')
    if params.cost != 'census':
        raise NotImplementedError(f'cost {params.cost!r} runs on the lax '
                                  'path, not ported yet (ROADMAP M12)')
    if params.census_win ** 2 - 1 > _VALID_BIT:
        raise NotImplementedError(f'census_win {params.census_win}: the '
                                  'kernels take windows up to 5x5; larger '
                                  'ones run on the lax path, not ported '
                                  'yet (ROADMAP M12)')
    if (tuple(shape1) != tuple(shape2) or shape1[0] % 8 or shape1[1] % 8
            or D % 8):
        raise NotImplementedError(
            f'shapes {tuple(shape1)} / {tuple(shape2)} with {D} candidates: '
            'the kernels need equal shapes and H, W and D multiples of 8; '
            'the rest runs on the lax path, not ported yet (ROADMAP M12); '
            'match_pair pads to such shapes')


def _match_core(im1, im2, disp_min: int, D: int, params: SgmParams,
                p2_scale=None, p2_scale_r=None):
    """The kernel branch of the JAX package's matcher body."""
    r = match_kernels(im1, im2, disp_min, disp_min + D - 1, params,
                      _p2_map(im1, params, p2_scale))
    d_int, votes, valid = r['d_int'], r['votes'], r['valid1']
    disp = r['disp_raw']

    nv = len(_DIRS_8[:max(2, min(params.nb_dir, 8))])
    consensus = sum((torch.abs(v - d_int) <= 1).to(torch.int32)
                    for v in votes)
    # count * f32(1 / n): how the JAX package's jitted division rounds
    confidence = consensus.to(torch.float32) * float(np.float32(1 / nv))

    if params.min_confidence > 0:
        valid = valid & (confidence >= params.min_confidence)
    # uniqueness_ratio needs the aggregated volume, which the kernel route
    # does not keep: the JAX package skips it there, and so does the port

    if params.median and params.median_first:
        disp = torch.where(valid, _nan_median3(
            torch.where(valid, disp, float('nan'))), float('nan'))
        valid = valid & torch.isfinite(disp)

    if params.lr_enabled:
        if params.lr_mode == 'full':
            # the true RL pass over the mirrored range, with the secondary
            # image's weight map
            dmin_r = -(disp_min + D - 1)
            dR = match_kernels(im2, im1, dmin_r, -disp_min, params,
                               _p2_map(im2, params, p2_scale_r))['disp_raw']
        else:
            dR = r['dR']
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
        im1, im2: rectified reference/secondary images (NaN = invalid), of
            equal shape with H and W multiples of 8.
        disp_min, disp_max: inclusive integer disparity bounds; the count
            must be a multiple of 8.
        params: aggregation parameters (``mgm=False``).
        p2_scale, p2_scale_r: optional multiplicative P2 weight maps of
            the reference and (for ``lr_mode='full'``) the secondary.
        device: None for CUDA (raises without it), or "cpu".

    Returns:
        dict of tensors on the device: 'disp' (float32, NaN invalid),
        'valid' (bool) and 'confidence' (float32 in [0, 1])."""
    D = int(disp_max) - int(disp_min) + 1
    _check_kernel_route(np.shape(im1), np.shape(im2), D, params)
    dev = resolve(device)

    def to_dev(a):
        return (None if a is None
                else torch.as_tensor(a, dtype=torch.float32, device=dev))

    return _match_core(to_dev(im1), to_dev(im2), int(disp_min), D, params,
                       to_dev(p2_scale), to_dev(p2_scale_r))


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
