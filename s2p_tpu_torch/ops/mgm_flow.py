"""The mgm binary's output flow: one tile, or a batch of tiles (stage 4).

Counterpart of ``s2p_tpu/ops/mgm_flow.py`` for the single-tile entry
:func:`mgm_binary_match`, the batch entry :func:`mgm_binary_match_batch`
(with its lane-folded groups) and the pieces they run.  The semantics are
those of the JAX package, to the bit: census on raw values (NaN pixels
give 0 bits), BIG = 1e9 for out-of-range candidates, the classic
8-direction SGM recursion with the overcount fix, vfit subpixel, a 3x3
NaN-discarding median on both maps before the left-right test, and the
consensus confidence of the L side's per-direction votes.

The single tile runs on the kernels for CUDA tensors
(``sgm_kernels.flow_one_side``) and on its plain reference for CPU
tensors: the (h, w, D) cost volume (:func:`census_cost_raw`), the scans
direction by direction (:func:`_aggregate_flow`) and the WTA
(:func:`_wta_refine`), the JAX package's lax route.

Batched tiles share a padded (B, H, W) shape.  Every tile is rebased to
disparity base 0: its base rides a column shift of the secondary
signatures (:func:`_shift_sig_cols`), its true extents ride signature bits
(``_VALID_BIT`` clear -> BIG cost, ``_PAD_BIT`` set -> zero cost over
reference padding), and its true candidate count is a (D,) mask.  Each
tile's output is bitwise the output of its unpadded run.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..device import resolve
from .sgm_kernels import (_PAD_BIT, _VALID_BIT, _popcount, _scan_loop,
                          flow_one_side, flow_partials_folded,
                          flow_partials_sides, unfold_lanes_v, wta)

BIG = float(np.float32(1e9))    # out-of-range sentinel (finite: argmin and
#                                 the overcount fix stay NaN-free)

_DIRS_8 = ((1, 0), (-1, 0), (0, 1), (0, -1),
           (1, 1), (-1, -1), (1, -1), (-1, 1))


@dataclasses.dataclass(frozen=True)
class MgmVariant:
    """Semantics knobs of the binary flow, with the JAX package's fields
    and defaults (its ``backend`` field has no counterpart: the device
    of the tensors chooses the route)."""
    p1: float = 8.0
    p2: float = 32.0
    nb_dir: int = 8
    tsgm: int = 1
    census_win: int = 5
    subpix: str = 'vfit'
    lr_enabled: bool = True
    lr_tau: float = 1.0
    lr_nan_survives: bool = True
    median_order: str = 'before_lr'  # 'before_lr' | 'after_lr' | 'none'
    median_fill: bool = False
    median_even: str = 'upper'
    median_shape: str = 'box'
    subpix_plateau: str = 'clip'
    edge_subpix: bool = False
    overcount_fix: bool = True
    fan: str = 'a'


def census_bits_raw(img, win: int):
    """(B, H, W) int32 census signatures with the binary's conventions:
    raw IEEE comparisons (NaN neighbours and centres give 0 bits),
    outside-image window samples give 0 bits.  One 32-bit word: win <= 5."""
    nbits = win * win - 1
    if nbits > 31:
        raise NotImplementedError('census windows above 5x5 need several '
                                  'signature words (ROADMAP M12)')
    img = img.to(torch.float32)
    B, h, w = img.shape
    r = win // 2
    pad = torch.nn.functional.pad(img, (r, r, r, r), value=float('nan'))
    sig = torch.zeros((B, h, w), dtype=torch.int32, device=img.device)
    bit = 0
    for dy in range(win):
        for dx in range(win):
            if dy == r and dx == r:
                continue
            nb = pad[:, dy:dy + h, dx:dx + w]
            sig = sig | ((nb < img).to(torch.int32) << bit)
            bit += 1
    return sig


def _pad_mask(h, w, h_true, w_true, device):
    """(B, h, w) bool: True beyond each tile's true extents, given as (B,)
    tensors or, for one tile, ints."""
    h_true = torch.as_tensor(h_true, device=device).reshape(-1)
    w_true = torch.as_tensor(w_true, device=device).reshape(-1)
    ys = torch.arange(h, device=device)[None, :, None] >= h_true[:, None, None]
    xs = torch.arange(w, device=device)[None, None, :] >= w_true[:, None, None]
    return ys | xs


def census_cost_raw(im1, im2, disp_min: int, D: int, win: int, h1=None,
                    w1=None, w2=None, d_true=None):
    """(h, w, D) float32 hamming cost of one (h, w) pair; out-of-range
    candidates (``x + disp_min + k`` outside ``[0, w2)``, or ``k >=
    d_true``) cost BIG, and the cost is zero over the reference's padding
    beyond ``(h1, w1)`` when either is given.  The extents are static
    ints, None for the full shape."""
    sig1 = census_bits_raw(im1[None], win)[0].long()
    sig2 = census_bits_raw(im2[None], win)[0].long()
    h, w = sig1.shape
    dev = sig1.device
    if w2 is None:
        w2 = sig2.shape[1]
    ks = torch.arange(D, device=dev)
    xs = torch.arange(w, device=dev)[:, None] + disp_min + ks[None, :]
    inb = (xs >= 0) & (xs < w2)
    if d_true is not None:
        inb = inb & (ks < d_true)[None, :]
    sig2_g = sig2[:, xs.clamp(0, sig2.shape[1] - 1)]         # (h, w, D)
    ham = _popcount(sig1[:, :, None] ^ sig2_g).to(torch.float32)
    cost = torch.where(inb[None], ham, BIG)
    if h1 is not None or w1 is not None:
        pad = _pad_mask(h, w, h if h1 is None else h1,
                        w if w1 is None else w1, dev)[0]
        cost = torch.where(pad[..., None], 0.0, cost)
    return cost


def _aggregate_flow(cost, v: MgmVariant):
    """The classic independent scans (tsgm 1) over an (h, w, D) cost, one
    direction at a time in direction order: (S, votes), S the sum of the
    directions' volumes less the overcount ``(n - 1) * cost``."""
    if v.tsgm != 1:
        raise NotImplementedError('tsgm >= 2 (the TSGM wavefront) is not '
                                  'ported yet (ROADMAP M12)')
    D = cost.shape[2]
    dirs = _DIRS_8[:max(2, min(v.nb_dir, 8))]
    S = torch.zeros_like(cost)
    votes = []
    for dx, dy in dirs:
        if dy == 0:          # along x, the lanes are the rows
            vol, lat, reverse = cost.permute(1, 2, 0), 0, dx < 0
        else:
            vol, lat, reverse = cost.permute(0, 2, 1), dx, dy < 0
        p2 = torch.full((1, vol.shape[0], vol.shape[2]), v.p2,
                        dtype=torch.float32, device=cost.device)
        L, vo = _scan_loop(lambda n: vol[n][None], p2, ((lat,),), v.p1,
                           reverse, 0.0, None, True, D)
        if dy == 0:
            L, vo = L[0].permute(2, 0, 1), vo[0, 0].t()
        else:
            L, vo = L[0].permute(0, 2, 1), vo[0, 0]
        votes.append(vo)
        S = S + L
    if v.overcount_fix:
        S = S - (len(dirs) - 1) * cost
    return S, votes


def _wta_refine(S, disp_min: int, v: MgmVariant):
    """WTA over an (h, w, D) volume with the binary's edge handling:
    (disp, d_int).  No refinement next to an out-of-range neighbour unless
    ``edge_subpix``; with ``subpix_plateau='zero'`` none where the fit's
    denominator is not above 1e-9; NaN where no candidate is in range."""
    D = S.shape[-1]
    dev = S.device
    mn = S.amin(dim=-1, keepdim=True)
    k_ids = torch.arange(D, device=dev)
    d_int = torch.where(S == mn, k_ids, D).amin(dim=-1)

    def at(idx):
        return torch.gather(S, -1, idx.unsqueeze(-1)).squeeze(-1)

    c1 = at(d_int)
    c0 = at((d_int - 1).clamp(min=0))
    c2 = at((d_int + 1).clamp(max=D - 1))
    ok = (d_int > 0) & (d_int < D - 1)
    if not v.edge_subpix:
        ok = ok & (c0 < BIG / 2) & (c2 < BIG / 2)
    eps = torch.tensor(1e-9, dtype=torch.float32, device=dev)
    if v.subpix == 'vfit':
        den = 2.0 * (torch.maximum(c0, c2) - c1)
        off = (c0 - c2) / torch.maximum(den, eps)
    elif v.subpix == 'parabola':
        den = c0 - 2.0 * c1 + c2
        off = 0.5 * (c0 - c2) / torch.maximum(den, eps)
    else:
        den = torch.ones_like(c1)
        off = torch.zeros_like(c1)
    off = off.clamp(-0.5, 0.5)
    if v.subpix_plateau == 'zero':
        off = torch.where(den > eps, off, 0.0)
    disp = (torch.tensor(float(disp_min), dtype=torch.float32, device=dev)
            + d_int.to(torch.float32)) + torch.where(ok, off, 0.0)
    disp = torch.where(c1 < BIG / 2, disp, float('nan'))
    return disp, d_int.to(torch.int32)


def _shift_sig_cols(sig, shift: int, w_true: int, extra: int = 0):
    """shifted[y, x] = sig[y, x + shift] for x in [0, W + extra), with
    ``_VALID_BIT`` set only where the source column lies in [0, w_true):
    the disparity rebase of one (H, W) tile.  A slice of a zero-padded
    row, clamped like a dynamic slice; positions outside the source carry
    zero signatures with the valid bit clear."""
    H, W = sig.shape
    pad = W + extra
    padded = torch.nn.functional.pad(sig, (pad, pad))
    start = min(max(pad + shift, 0), padded.shape[1] - (W + extra))
    g = padded[:, start:start + W + extra]
    xs = torch.arange(W + extra, device=sig.device) + shift
    ok = (xs >= 0) & (xs < w_true)
    return g | (ok.to(torch.int32) << _VALID_BIT)[None, :]


def _median3x3(x, v: MgmVariant):
    """3x3 NaN-discarding median of (B, H, W) maps via an odd-even
    sorting network over the 9 taps."""
    B, h, w = x.shape
    pad = torch.nn.functional.pad(x, (1, 1, 1, 1), value=float('nan'))
    taps = [pad[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    if v.median_shape == 'cross':
        taps = [taps[i] for i in (1, 3, 4, 5, 7)] + [
            torch.full_like(x, float('nan'))] * 4
    n = sum(torch.isfinite(t).to(torch.int32) for t in taps)
    vals = [torch.where(torch.isnan(t), float('inf'), t) for t in taps]
    for r in range(9):
        for i in range(r % 2, 8, 2):
            lo = torch.minimum(vals[i], vals[i + 1])
            hi = torch.maximum(vals[i], vals[i + 1])
            vals[i], vals[i + 1] = lo, hi
    idx = n // 2 if v.median_even == 'upper' else (n - 1).clamp(min=0) // 2
    idx = idx.clamp(0, 8)
    med = vals[0]
    for k in range(1, 9):
        med = torch.where(idx == k, vals[k], med)
    med = torch.where(n > 0, med, float('nan'))
    if not v.median_fill:
        med = torch.where(torch.isfinite(x), med, float('nan'))
    return med


def _lr_kill(dL, dR, v: MgmVariant, w2, k_lo, k_cnt: int):
    """The left-right test of (B, H, W) maps: index the right map at
    x + round(dL); landings outside each tile's true secondary width
    ``w2`` die; |dL + dR| > tau dies; a NaN at the landing survives
    (``lr_nan_survives``).  Landing offsets are read through the window
    [k_lo, k_lo + k_cnt) of each tile, with the JAX package's
    dynamic-slice clamp: an offset outside the window reads NaN."""
    B, h, w = dL.shape
    dev = dL.device
    r = torch.round(torch.nan_to_num(dL)).to(torch.int32)
    xx = torch.arange(w, device=dev)[None, None, :] + r
    inb = (xx >= 0) & (xx < w2[:, None, None])
    pad = w + k_cnt
    start = (pad + k_lo).clamp(0, 2 * pad - k_cnt)
    shift = (start - pad - k_lo)[:, None, None]      # 0 unless clamped
    kk = r - k_lo[:, None, None]
    pos = xx + shift
    ok = (kk >= 0) & (kk < k_cnt) & (pos >= 0) & (pos < w)
    dR_at = torch.gather(dR, 2, pos.clamp(0, w - 1).to(torch.int64))
    dR_at = torch.where(ok, dR_at, float('nan'))
    bad = torch.abs(dL + dR_at) > v.lr_tau
    if v.lr_nan_survives:
        bad = bad & torch.isfinite(dR_at)
    else:
        bad = bad | ~torch.isfinite(dR_at)
    return torch.where(inb & ~bad, dL, float('nan'))


def _flow_post(dL, dR, d_int, votes, v: MgmVariant, w2_true, k_lo, k_cnt):
    """The post chain: median placement, LR test, consensus confidence."""
    if v.median_order == 'before_lr':
        dL = _median3x3(dL, v)
        if dR is not None:
            dR = _median3x3(dR, v)
    if dR is not None:
        dL = _lr_kill(dL, dR, v, w2_true, k_lo, k_cnt)
    if v.median_order == 'after_lr':
        dL = _median3x3(dL, v)
    consensus = sum((torch.abs(w - d_int) <= 1).to(torch.int32)
                    for w in votes)
    # count * f32(1 / n): how the JAX package's jitted division rounds
    recip = float(np.float32(1 / len(votes)))
    return dL, consensus.to(torch.float32) * recip


def _check_variant(v: MgmVariant, single_tile=False):
    """Raise on a variant that the port does not run (no other route)."""
    if v.tsgm != 1:
        raise NotImplementedError('tsgm >= 2 (the TSGM wavefront) is not '
                                  'ported yet (ROADMAP M12)')
    if v.census_win ** 2 - 1 > _VALID_BIT:
        raise NotImplementedError(f'census_win {v.census_win}: the kernels '
                                  'take windows up to 5x5')
    if not single_tile and (v.edge_subpix or v.subpix_plateau != 'clip'):
        raise NotImplementedError('edge_subpix and subpix_plateau belong to '
                                  'the single-tile flow (mgm_binary_match)')


def _side_sigs(sig_ref, sig_sec, base, h_ref, w_ref, w_sec, extra,
               ref_pad=0):
    """Kernel inputs of one side: the reference signatures, widened by
    ``ref_pad`` columns, with the valid bit and the padding bit beyond
    (h_ref, w_ref), and the secondary ones rebased to base 0 with a
    margin of ``extra`` >= D columns (candidate positions reach W - 1 + D
    - 1, and the rebase may shift content right by up to the full range).
    Returns (sr, ss, padding mask)."""
    if ref_pad:
        sig_ref = torch.nn.functional.pad(sig_ref, (0, ref_pad))
    B, H, W = sig_ref.shape
    pad = _pad_mask(H, W, h_ref, w_ref, sig_ref.device)
    sr = sig_ref | (1 << _VALID_BIT) | (pad.to(torch.int32) << _PAD_BIT)
    shifts, widths = base.tolist(), w_sec.tolist()
    ss = torch.stack([_shift_sig_cols(sig_sec[i], shifts[i], widths[i],
                                      extra=extra) for i in range(B)])
    return sr, ss, pad


def _mgm_one_side(im1, im2, disp_min: int, D: int, v: MgmVariant, h1=None,
                  w1=None, w2=None, d_true=None, need_votes=True):
    """One side of the single-tile flow on (H, W) images of equal shape:
    (disp, d_int, votes), NaN beyond ``(h1, w1)``.  CUDA tensors run the
    kernels, CPU tensors the plain reference."""
    H, W = im1.shape
    if im1.device.type == 'cuda':
        ext = None
        if any(x is not None for x in (h1, w1, w2, d_true)):
            ext = (H if h1 is None else h1, W if w1 is None else w1,
                   im2.shape[1] if w2 is None else w2,
                   D if d_true is None else d_true)
        disp, d_int, votes = flow_one_side(im1[None], im2[None], disp_min,
                                           D, v, ext=ext,
                                           emit_votes=need_votes)
        disp, d_int = disp[0], d_int[0]
        votes = [None if vo is None else vo[0] for vo in votes]
    else:
        cost = census_cost_raw(im1, im2, disp_min, D, v.census_win, h1, w1,
                               w2, d_true)
        S, votes = _aggregate_flow(cost, v)
        disp, d_int = _wta_refine(S, disp_min, v)
    if h1 is not None or w1 is not None:
        pad = _pad_mask(H, W, H if h1 is None else h1,
                        W if w1 is None else w1, im1.device)[0]
        disp = torch.where(pad, float('nan'), disp)
    return disp, d_int, votes


def _flow_core(im1, im2, disp_min: int, D: int, v: MgmVariant, h1=None,
               w1=None, w2=None, d_true=None):
    """The single-tile flow on (H, W) tensors: both sides, then the post
    chain.  ``disp_min`` and the true extents are static ints."""
    dev = im1.device
    dL, d_int, votes = _mgm_one_side(im1, im2, disp_min, D, v, h1, w1, w2,
                                     d_true)
    dR = None
    if v.lr_enabled:
        # the mirrored range [-dmax_true, -dmin]
        dt = D if d_true is None else d_true
        w1_true = im1.shape[1] if w1 is None else w1
        dR, _, _ = _mgm_one_side(im2, im1, -(disp_min + dt - 1), D, v, h1,
                                 w2, w1_true, d_true, need_votes=False)
        dR = dR[None]

    def ints(x):
        return torch.tensor([x], dtype=torch.int32, device=dev)

    w2_true = im2.shape[1] if w2 is None else w2
    disp, conf = _flow_post(dL[None], dR, d_int[None],
                            [vo[None] for vo in votes], v, ints(w2_true),
                            k_lo=ints(disp_min - 1), k_cnt=D + 2)
    return disp[0], conf[0]


def mgm_binary_match(im1, im2, disp_min: int, disp_max: int,
                     variant: MgmVariant = MgmVariant(), device=None):
    """Disparity of one rectified pair with the mgm binary's semantics.

    Args:
        im1, im2: (h, w) float32 rectified pair, NaN outside the domain.
        disp_min, disp_max: the disparity range (ints).
        device: None for CUDA (raises without it), or "cpu".
    Returns:
        (disp, confidence), (h1, w1) float32 tensors on the device: the
        disparity (NaN = rejected) and the consensus confidence.  Shapes
        are padded with NaN to multiples of 8 and the true extents passed
        on, so the output is bitwise the unpadded result."""
    _check_variant(variant, single_tile=True)
    dev = resolve(device)
    im1 = np.asarray(im1, np.float32)
    im2 = np.asarray(im2, np.float32)
    D = int(disp_max) - int(disp_min) + 1
    h1, w1 = im1.shape
    h2, w2 = im2.shape
    Hp = -(-max(h1, h2) // 8) * 8
    Wp = -(-max(w1, w2) // 8) * 8
    if (Hp, Wp) == im1.shape == im2.shape:
        return _flow_core(torch.as_tensor(im1, device=dev),
                          torch.as_tensor(im2, device=dev), int(disp_min),
                          D, variant)

    def pad(a):
        out = np.full((Hp, Wp), np.nan, np.float32)
        out[:a.shape[0], :a.shape[1]] = a
        return torch.as_tensor(out, device=dev)

    disp, conf = _flow_core(pad(im1), pad(im2), int(disp_min), D, variant,
                            h1, w1, w2, d_true=D)
    return disp[:h1, :w1], conf[:h1, :w1]


def _flow_batched(a, b, dm, D, h1, w1, w2, dt, v: MgmVariant):
    """The batched flow on one device: L side with votes, R side without
    (their scans at once on the card, :func:`flow_partials_sides`), then
    the post chain.  The per-tile scalars are (B,) int32 tensors on the
    device."""
    dev = a.device
    s1 = census_bits_raw(a, v.census_win)
    s2 = census_bits_raw(b, v.census_win)
    allowed = (torch.arange(D, device=dev)[None, :]
               < dt[:, None]).to(torch.int32)                # (B, D)
    # (reference, secondary, base, reference width, secondary width, votes)
    sides = [(s1, s2, dm, w1, w2, True)]
    if v.lr_enabled:
        sides.append((s2, s1, -(dm + dt - 1), w2, w1, False))
    sigs = [_side_sigs(sr, ss, base, h1, wr, ws, extra=D)
            for sr, ss, base, wr, ws, _ in sides]
    partials = flow_partials_sides(
        [(sr, ss, 0, side[5]) for (sr, ss, _), side in zip(sigs, sides)],
        D, v, allowed=allowed)
    maps = []
    for (parts, votes), (_, _, pad), side in zip(partials, sigs, sides):
        off, d_int = wta(parts, v.subpix, BIG / 2)
        # (base + d_int) + off: the JAX package's float composition
        disp = (side[2].to(torch.float32)[:, None, None]
                + d_int.to(torch.float32)) + off
        maps.append((torch.where(pad, float('nan'), disp), d_int, votes))
    dL, d_int, votes = maps[0]
    dR = maps[1][0] if v.lr_enabled else None
    return _flow_post(dL, dR, d_int, votes, v, w2, k_lo=dm - 1, k_cnt=D + 2)


def lane_fold_plan(W: int, D: int, n_tiles: int):
    """(fold factor, segment width) of a lane-folded batch.

    The fold is ``S2P_TPU_LANE_FOLD`` (default 1: no fold), at most the
    tile count; each tile's segment is W + D columns (its rebased
    candidates' reach) rounded up to a multiple of 8."""
    seg_w = W + D
    seg_w += (-seg_w) % 8
    fold = int(os.environ.get('S2P_TPU_LANE_FOLD', 1))
    return min(fold, n_tiles), seg_w


def _flow_lane_folded(a, b, dm, D, h1, w1, w2, dt, v: MgmVariant, fold,
                      seg_w):
    """The batched flow with groups of ``fold`` tiles side by side on the
    scans' lane axis, each tile a segment of ``seg_w`` columns; the tile
    count is a multiple of ``fold``.  Bitwise the per-tile batch."""
    n, H, W = a.shape
    m = n // fold
    dev = a.device
    s1 = census_bits_raw(a, v.census_win)
    s2 = census_bits_raw(b, v.census_win)
    allowed = (torch.arange(D, device=dev)[None, :]
               < dt[:, None]).to(torch.int32)                # (n, D)

    def side(sig_ref, sig_sec, base, h_ref, w_ref, w_sec, need_votes):
        sr, ss, _ = _side_sigs(sig_ref, sig_sec, base, h_ref, w_ref, w_sec,
                               extra=seg_w - W, ref_pad=seg_w - W)
        parts, votes = flow_partials_folded(
            sr.reshape(m, fold, H, seg_w), ss.reshape(m, fold, H, seg_w), D,
            v, allowed_bt=allowed.reshape(m, fold, D),
            emit_votes=need_votes)
        off, d_int = wta(parts, v.subpix, BIG / 2)

        def unfold(x):
            return unfold_lanes_v(x, fold).reshape(n, H, seg_w)[:, :, :W]

        off, d_int = unfold(off), unfold(d_int)
        votes = [unfold(vo) for vo in votes if vo is not None]
        disp = (base.to(torch.float32)[:, None, None]
                + d_int.to(torch.float32)) + off
        pad = _pad_mask(H, W, h_ref, w_ref, dev)
        return torch.where(pad, float('nan'), disp), d_int, votes

    dL, d_int, votes = side(s1, s2, dm, h1, w1, w2, True)
    dR = None
    if v.lr_enabled:
        dR, _, _ = side(s2, s1, -(dm + dt - 1), h1, w2, w1, False)
    return _flow_post(dL, dR, d_int, votes, v, w2, k_lo=dm - 1, k_cnt=D + 2)


def mgm_binary_match_batch(im1_b, im2_b, disp_min_b, D: int, h_b, w1_b,
                           w2_b, d_b=None, variant: MgmVariant = MgmVariant(),
                           device=None):
    """Batched binary-faithful matcher for one bucket of tiles.

    Args:
        im1_b, im2_b: (B, Hp, Wp) float32 rectified pairs, NaN-padded.
        disp_min_b: (B,) per-tile disparity base.
        D: padded candidate count of the bucket.
        h_b, w1_b, w2_b: (B,) true heights and widths of each tile.
        d_b: (B,) true candidate counts (default D).
        device: None for CUDA (raises without it), or "cpu".
    With ``S2P_TPU_LANE_FOLD`` above 1, groups of that many tiles run
    lane-folded (:func:`lane_fold_plan`) and the rest tile by tile.
    Returns:
        dict of (B, Hp, Wp) tensors on the device: 'disp' (float32, NaN =
        rejected), 'confidence' (float32) and 'confidence_u8' (the
        consensus counts as uint8)."""
    _check_variant(variant)
    dev = resolve(device)

    def ints(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device=dev).reshape(-1)

    a = torch.as_tensor(np.asarray(im1_b, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(im2_b, np.float32), device=dev)
    dm = ints(disp_min_b)
    d_b = ints(np.full(dm.shape, D) if d_b is None else d_b)
    args = (a, b, dm, int(D), ints(h_b), ints(w1_b), ints(w2_b), d_b,
            variant)
    fold, seg_w = lane_fold_plan(a.shape[2], int(D), a.shape[0])
    if fold > 1:
        k = a.shape[0] // fold * fold
        head = [x[:k] if torch.is_tensor(x) else x for x in args]
        disp, conf = _flow_lane_folded(*head, fold, seg_w)
        if k < a.shape[0]:
            tail = [x[k:] if torch.is_tensor(x) else x for x in args]
            d2, c2 = _flow_batched(*tail)
            disp, conf = torch.cat([disp, d2]), torch.cat([conf, c2])
    else:
        disp, conf = _flow_batched(*args)
    nv = max(2, min(variant.nb_dir, 8))
    # consensus counts as uint8: count/n in f32 is rebuilt exactly
    return {'disp': disp, 'confidence': conf,
            'confidence_u8': (conf * nv).to(torch.uint8)}
