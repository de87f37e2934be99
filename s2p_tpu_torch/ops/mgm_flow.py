"""The mgm binary's output flow: one tile, or a batch of tiles (stage 4).

Counterpart of ``s2p_tpu/ops/mgm_flow.py`` for the single-tile entry
:func:`mgm_binary_match`, the batch entry :func:`mgm_binary_match_batch`
(with its lane-folded groups), the mgm_multi cascade
(:func:`mgm_multi_match`, :func:`mgm_multi_match_batch`) and the pieces
they run.  The semantics are
those of the JAX package, to the bit: census on raw values (NaN pixels
give 0 bits), BIG = 1e9 for out-of-range candidates, the classic
8-direction SGM recursion with the overcount fix, vfit subpixel, a 3x3
NaN-discarding median on both maps before the left-right test, and the
consensus confidence of the L side's per-direction votes.

The single tile runs the kernels' route (``sgm_kernels.flow_one_side``:
the pre-pass, the four scans, the WTA) on both devices, the kernels for
CUDA tensors and their plain versions for CPU tensors, so that both sum
the directions in one order, the kernels' (the JAX package's TPU route).
With ``tsgm >= 2`` every entry runs the JAX package's lax route on the
tensors' device: the (h, w, D) cost volume (:func:`census_cost_raw`), the
MGM wavefront (:func:`_aggregate_flow`, ``ops/mgm.py``) and the WTA
(:func:`_wta_refine`), tile by tile.

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
from .census import census_words
from .mgm import mgm_aggregate
from .sgm_kernels import (_PAD_BIT, _VALID_BIT, _fma32, _popcount,
                          flow_one_side, flow_partials_folded,
                          flow_partials_sides, scan, unfold_lanes_v, wta)

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
    """(..., H, W, n_words) int32 census signatures of (..., H, W) images
    with the binary's conventions: raw IEEE comparisons (NaN neighbours
    and centres give 0 bits), outside-image window samples give 0 bits;
    bit ``b`` of the window in word ``b // 32`` (``census.census_words``
    with ``raw``).  The kernels take windows up to 5x5: one word."""
    return census_words(img, win, raw=True)[0].to(torch.int32)


def _cost_dtype(win: int):
    """The integer cost volume of a window and its sentinel for BIG:
    uint8 with 255 while a Hamming count stays below 255 (windows up to
    15x15), else uint16 with 65535 (K2's 16-bit source)."""
    if win * win - 1 < 255:
        return torch.uint8, 255
    return torch.uint16, 65535


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
    sig1 = census_words(im1, win, raw=True)[0]              # (h, w, words)
    sig2 = census_words(im2, win, raw=True)[0]
    h, w = sig1.shape[:2]
    dev = sig1.device
    if w2 is None:
        w2 = sig2.shape[1]
    ks = torch.arange(D, device=dev)
    xs = torch.arange(w, device=dev)[:, None] + disp_min + ks[None, :]
    inb = (xs >= 0) & (xs < w2)
    if d_true is not None:
        inb = inb & (ks < d_true)[None, :]
    sig2_g = sig2[:, xs.clamp(0, sig2.shape[1] - 1)]   # (h, w, D, words)
    ham = _popcount(sig1[:, :, None] ^ sig2_g).sum(dim=-1).to(torch.float32)
    cost = torch.where(inb[None], ham, BIG)
    if h1 is not None or w1 is not None:
        pad = _pad_mask(h, w, h if h1 is None else h1,
                        w if w1 is None else w1, dev)[0]
        cost = torch.where(pad[..., None], 0.0, cost)
    return cost


def _cost_int(cost, win: int):
    """A float32 census cost (Hamming counts, 0 or BIG) as the kernels'
    integer volume (:func:`_cost_dtype`): the sentinel stands for BIG,
    every other value as it is."""
    dtype, sentinel = _cost_dtype(win)
    return torch.where(cost == BIG, sentinel,
                       cost.to(torch.int32)).to(dtype)


def _cost_float(cost):
    """An integer cost volume (:func:`_cost_int`) as float32, BIG at the
    sentinel."""
    sentinel = 255 if cost.dtype == torch.uint8 else 65535
    c = cost.to(torch.int32)
    return torch.where(c == sentinel, BIG, c.to(torch.float32))


def _aggregate_scans(cost, v: MgmVariant, p2_map=None, emit_votes=True):
    """The aggregation of a (B, H, W, D) integer cost (:func:`_cost_int`:
    uint8 or uint16, the sentinel for BIG) and an optional (B, H, W)
    per-pixel P2.

    tsgm 1: the classic independent scans, one :func:`scan` per direction
    in the JAX package's direction order, each adding the sum of the
    directions before it, then the overcount fix ``S - (n - 1) * cost``:
    the JAX package's order of float32 additions, which a per-pixel
    ``p2_map`` makes inexact.  CUDA tensors launch K2 (its 16-bit source
    for uint16), CPU tensors run its plain version.  ``tsgm >= 2``: the
    MGM wavefront (:func:`mgm.mgm_aggregate`) of each tile on its own.

    Returns (S (B, H, D, W) float32, votes: per direction a (B, H, W)
    int32 map, None without ``emit_votes``)."""
    if v.tsgm >= 2:
        S, votes = [], []
        for k in range(cost.shape[0]):
            S_k, votes_k = mgm_aggregate(
                _cost_float(cost[k]), v.p1, v.p2, nb_dir=v.nb_dir,
                tsgm=v.tsgm, p2_map=None if p2_map is None else p2_map[k],
                overcount_fix=v.overcount_fix, fan=v.fan)
            S.append(S_k.permute(0, 2, 1))
            votes.append(votes_k)
        votes = [torch.stack([vo[d] for vo in votes]) if emit_votes
                 else None for d in range(votes[0].shape[0])]
        return torch.stack(S), votes
    B, H, W, D = cost.shape
    dirs = _DIRS_8[:max(2, min(v.nb_dir, 8))]
    vols = {'v': cost.permute(0, 1, 3, 2).contiguous(),     # (B, H, D, W)
            'h': cost.permute(0, 2, 3, 1).contiguous()}     # (B, W, D, H)
    p2 = (torch.full((B, H, W), v.p2, dtype=torch.float32, device=cost.device)
          if p2_map is None else p2_map.to(torch.float32).contiguous())
    p2s = {'v': p2, 'h': p2.transpose(1, 2).contiguous()}
    S, o, votes = None, None, []
    for dx, dy in dirs:
        o_dir = 'h' if dy == 0 else 'v'
        if S is not None and o_dir != o:
            S = S.permute(0, 3, 2, 1).contiguous()
        o = o_dir
        S, vo = scan(vols[o], p2s[o], (0 if dy == 0 else dx,), v.p1, BIG,
                     reverse=(dx if dy == 0 else dy) < 0, accum=S,
                     emit_votes=emit_votes)
        votes.append(None if vo is None else
                     vo[:, 0] if o == 'v' else vo[:, 0].transpose(1, 2))
    if o == 'h':
        S = S.permute(0, 3, 2, 1).contiguous()
    if v.overcount_fix:
        S = S - (len(dirs) - 1) * _cost_float(vols['v'])
    return S, votes


def _aggregate_flow(cost, v: MgmVariant, p2_map=None):
    """The aggregation of one (h, w, D) float32 cost with the JAX
    package's signature: (S (h, w, D), votes, each (h, w)); ``p2_map``
    is an optional (h, w) per-pixel P2.  The classic scans of
    :func:`_aggregate_scans` for tsgm 1, the MGM wavefront
    (:func:`mgm.mgm_aggregate`) for ``tsgm >= 2``."""
    if v.tsgm >= 2:
        S, votes = mgm_aggregate(cost, v.p1, v.p2, nb_dir=v.nb_dir,
                                 tsgm=v.tsgm, p2_map=p2_map,
                                 overcount_fix=v.overcount_fix, fan=v.fan)
        return S, list(votes)
    S, votes = _aggregate_scans(_cost_int(cost, v.census_win)[None], v,
                                None if p2_map is None else p2_map[None])
    return S[0].permute(0, 2, 1), [vo[0] for vo in votes]


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


def _wide(v: MgmVariant):
    """A census window above 5x5: more bits than the kernels' signature
    word holds, so every entry takes the lax route, as the JAX package's
    do."""
    return v.census_win ** 2 - 1 > _VALID_BIT


def _check_variant(v: MgmVariant, single_tile=False):
    """Raise on a variant that the port does not run (no other route)."""
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
    (disp, d_int, votes), NaN beyond ``(h1, w1)``.  The kernels' route
    on both devices (the kernels for CUDA tensors, their plain versions
    for CPU tensors); the lax route (the cost volume, :func:`_aggregate_flow`,
    :func:`_wta_refine`) for ``tsgm >= 2`` or a window above 5x5."""
    H, W = im1.shape
    if v.tsgm == 1 and not _wide(v):
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
        votes = votes if need_votes else [None] * len(votes)
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
    s1 = census_bits_raw(a, v.census_win)[..., 0]
    s2 = census_bits_raw(b, v.census_win)[..., 0]
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
    s1 = census_bits_raw(a, v.census_win)[..., 0]
    s2 = census_bits_raw(b, v.census_win)[..., 0]
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
    lane-folded (:func:`lane_fold_plan`) and the rest tile by tile.  With
    ``tsgm >= 2`` or a census window above 5x5 every tile runs the lax
    route on its own, as the JAX package's batch does.
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
    if variant.tsgm >= 2 or _wide(variant):
        # the lax route of the JAX package's batch, tile by tile
        h_b, w1_b, w2_b = (x.tolist() for x in args[4:7])
        outs = [_flow_core(a[k], b[k], int(dm[k]), int(D), variant, h_b[k],
                           w1_b[k], w2_b[k], d_true=int(d_b[k]))
                for k in range(a.shape[0])]
        disp = torch.stack([o[0] for o in outs])
        conf = torch.stack([o[1] for o in outs])
    elif fold > 1:
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


# --------------------------------------------------------------------- #
# mgm_multi: the -S 6 multiscale cascade
# --------------------------------------------------------------------- #
#
# The reference's production matcher for real scenes (mgm_multi -S 6 -s
# vfit with SUBPIX=2 and no median; the lsd variant with weight maps,
# MEDIAN=1 and P1/P2 12/48).  A gaussian pyramid; each level, coarse to
# fine, runs both sides of the flow over half-pixel candidates restricted
# per pixel to the coarser level's 3x3 range (+-2), then the left-right
# test of both maps.  Every map is (B, H, W) and every per-tile scalar a
# (B,) tensor: the single tile is a batch of one at its full extents.

def _downsample2_img(img):
    """Binomial 5-tap blur of (B, H, W) images with edge padding, then 2x
    decimation; NaN spreads through the blur.  Each axis sums its taps as
    the JAX package's jitted run does: the first product, then four fused
    multiply-adds."""
    k = [float(np.float32(c) / np.float32(16)) for c in (1, 4, 6, 4, 1)]

    def blur(x, axis):
        n = x.shape[axis]
        idx = (torch.arange(-2, n + 2, device=x.device)).clamp(0, n - 1)
        p = x.index_select(axis, idx)
        v = p.narrow(axis, 0, n) * k[0]
        for i in range(1, 5):
            v = _fma32(p.narrow(axis, i, n), k[i], v)
        return v

    return blur(blur(img, 1), 2)[:, ::2, ::2]


def _minmax3_nan(x):
    """NaN-ignoring 3x3 min and max of (B, H, W) maps (all-NaN windows
    give +inf and -inf)."""
    B, h, w = x.shape
    pad = torch.nn.functional.pad(x, (1, 1, 1, 1), value=float('nan'))
    lo = torch.full_like(x, float('inf'))
    hi = torch.full_like(x, float('-inf'))
    for dy in range(3):
        for dx in range(3):
            t = pad[:, dy:dy + h, dx:dx + w]
            fin = torch.isfinite(t)
            lo = torch.minimum(lo, torch.where(fin, t, float('inf')))
            hi = torch.maximum(hi, torch.where(fin, t, float('-inf')))
    return lo, hi


def _upsample2_vals(d, out_h, out_w):
    """Nearest 2x upsample of coarse (B, h, w) maps, cropped to the fine
    shape."""
    up = d.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return up[:, :out_h, :out_w]


def _range_maps_from_coarse(d_coarse, out_h, out_w, lo_glob, hi_glob,
                            margin: float = 2.0):
    """Per-pixel disparity interval of the finer level: 2x the coarse
    disparities, min and max over a 3x3 window, +- ``margin``, within each
    tile's global range (``lo_glob``, ``hi_glob``: (B,) float32); pixels
    with no coarse information take the global range."""
    up = 2.0 * _upsample2_vals(d_coarse, out_h, out_w)
    lo, hi = _minmax3_nan(up)
    lo_g = lo_glob.to(torch.float32)[:, None, None]
    hi_g = hi_glob.to(torch.float32)[:, None, None]
    lo = torch.where(torch.isfinite(lo), torch.maximum(lo - margin, lo_g),
                     lo_g)
    hi = torch.where(torch.isfinite(hi), torch.minimum(hi + margin, hi_g),
                     hi_g)
    return lo, hi


def _ceil_div(a, b: int):
    """Python's ceiling division of int tensors, negative values too."""
    return -torch.div(-a, b, rounding_mode='floor')


def _floor_div(a, b: int):
    return torch.div(a, b, rounding_mode='floor')


_FRAC_CHUNK = 16        # candidates of one phase gathered at a time


def _census_cost_frac(im1, im2, disp_min, D: int, sd: int, win: int, h1,
                      w1, w2, d_true, lo_map=None, hi_map=None):
    """(B, H, W, D) integer census cost (:func:`_cost_int`'s dtype and
    sentinel for BIG) over the fractional candidates ``disp_min + k /
    sd`` of (B, H, W) pairs.

    Phase ``f = k % sd`` matches the secondary shifted by ``f / sd`` px
    (linear interpolation of columns x2 and x2 + 1, so a fractional
    candidate needs both inside the true width ``w2``).  Candidates out of
    range, at or past each tile's ``d_true``, or outside the per-pixel
    window ``[lo_map - 1e-4, hi_map + 1e-4]`` cost BIG; the cost is 0 over
    the reference's padding beyond ``(h1, w1)``.  ``disp_min``, the
    extents and ``d_true`` are (B,) int tensors; the maps (B, H, W)
    float32 or None."""
    B, H, W = im1.shape
    dev = im1.device
    dtype, sentinel = _cost_dtype(win)
    work = torch.uint8 if dtype == torch.uint8 else torch.int32
    sig1 = census_words(im1, win, raw=True)[0]     # (B, H, W, words)
    n_per = -(-D // sd)
    cost = torch.empty((B, H, W, n_per * sd), dtype=work, device=dev)
    x0 = torch.arange(W, device=dev)[None, :, None] + disp_min[:, None, None]
    for f in range(sd):
        src = im2
        if f:
            frac = f / sd
            nxt = torch.cat([im2[:, :, 1:],
                             torch.full_like(im2[:, :, :1], float('nan'))], 2)
            src = (1.0 - frac) * im2 + frac * nxt
        sig2 = census_words(src, win, raw=True)[0]
        last_ok = (w2 - (1 if f else 0))[:, None, None]
        for j0 in range(0, n_per, _FRAC_CHUNK):
            js = torch.arange(j0, min(n_per, j0 + _FRAC_CHUNK), device=dev)
            ks = f + sd * js
            xs = x0 + js                                     # (B, W, c)
            inb = ((xs >= 0) & (xs < last_ok) & (ks < D)
                   & (ks < d_true[:, None, None]))
            idx = xs.clamp(0, W - 1).reshape(B, 1, -1).expand(B, H, -1)
            ham = 0
            for word in range(sig1.shape[-1]):
                g = torch.gather(sig2[..., word], 2, idx)
                ham = ham + _popcount(sig1[..., word, None]
                                      ^ g.reshape(B, H, W, len(js)))
            cost[..., f + sd * j0:f + sd * (j0 + len(js)):sd] = \
                torch.where(inb[:, None], ham.to(work), sentinel)
    cost = cost[..., :D]
    if lo_map is not None:
        eps = torch.tensor(1e-4, dtype=torch.float32, device=dev)
        vals = (disp_min.to(torch.float32)[:, None]
                + torch.arange(D, device=dev).to(torch.float32)[None] / sd)
        vals = vals[:, None, None, :]
        ok = ((vals >= (lo_map - eps)[..., None])
              & (vals <= (hi_map + eps)[..., None]))
        cost = torch.where(ok, cost, sentinel)
    pad = _pad_mask(H, W, h1, w1, dev)
    return torch.where(pad[..., None], 0, cost).to(dtype)


def _one_side_frac(im1, im2, disp_min, D: int, sd: int, v: MgmVariant, h1,
                   w1, w2, d_true, lo_map, hi_map, p2_map=None,
                   emit_votes=True):
    """One side of a cascade level: (disp, d_int, votes) of (B, H, W)
    pairs, disp = disp_min + (WTA index + subpixel offset) / sd, NaN
    beyond ``(h1, w1)``.  The scans are K2 and the WTA K3 on CUDA tensors,
    their plain versions on CPU tensors."""
    cost = _census_cost_frac(im1, im2, disp_min, D, sd, v.census_win, h1,
                             w1, w2, d_true, lo_map, hi_map)
    S, votes = _aggregate_scans(cost, v, p2_map, emit_votes)
    off, d_int = wta([S], v.subpix, BIG / 2, edge_subpix=v.edge_subpix,
                     plateau_zero=v.subpix_plateau == 'zero')
    disp = (disp_min.to(torch.float32)[:, None, None]
            + (d_int.to(torch.float32) + off) / sd)
    pad = _pad_mask(im1.shape[1], im1.shape[2], h1, w1, im1.device)
    return torch.where(pad, float('nan'), disp), d_int, votes


def _multi_core(a, b, dm, D: int, v: MgmVariant, scales: int, sd: int, h1,
                w1, w2, dt, p2_map=None, p2_map_r=None):
    """The -S cascade of (B, H, W) pairs with per-tile bases ``dm``, true
    extents and candidate counts ``dt`` ((B,) int tensors): (disp,
    confidence).  The level count is static: the pyramid stops where a
    level's smaller side halved is below 4 census windows."""
    levels, exts, p2s = [(a, b)], [(h1, w1, w2)], [(p2_map, p2_map_r)]
    for _ in range(1, scales):
        a, b = levels[-1]
        if min(a.shape[1:]) // 2 < 4 * v.census_win:
            break
        levels.append((_downsample2_img(a), _downsample2_img(b)))
        exts.append(tuple(_ceil_div(e, 2) for e in exts[-1]))
        p2s.append(tuple(None if p is None else p[:, ::2, ::2]
                         for p in p2s[-1]))
    dmax_val = dm + dt - 1
    dL = dR = None
    for s in range(len(levels) - 1, -1, -1):
        a, b = levels[s]
        eh, ew1, ew2 = exts[s]
        pa, pb = p2s[s]
        dmin_s = _floor_div(dm, 2 ** s)
        dmax_s = _ceil_div(dmax_val, 2 ** s)
        # the level's candidate capacity covers any tile's base
        D_s = (D - 1) // (2 ** s) + 2
        d_true_s = (dmax_s - dmin_s) * sd + 1
        D_cost = (D_s - 1) * sd + 1
        lo_g, hi_g = dmin_s.to(torch.float32), dmax_s.to(torch.float32)
        if dL is None:
            loL = hiL = loR = hiR = None
        else:
            h_s, w_s = a.shape[1:]
            loL, hiL = _range_maps_from_coarse(dL, h_s, w_s, lo_g, hi_g)
            loR, hiR = _range_maps_from_coarse(dR, h_s, w_s, -hi_g, -lo_g)
        dL, d_int, votes = _one_side_frac(a, b, dmin_s, D_cost, sd, v, eh,
                                          ew1, ew2, d_true_s, loL, hiL, pa)
        dR, _, _ = _one_side_frac(b, a, -dmax_s, D_cost, sd, v, eh, ew2, ew1,
                                  d_true_s, loR, hiR, pb, emit_votes=False)
        if v.median_order == 'before_lr' and v.lr_enabled:
            dL, dR = _median3x3(dL, v), _median3x3(dR, v)
        if v.lr_enabled:
            # landing windows: dL lies in [dmin_s, dmax_s], dR in
            # [-dmax_s, -dmin_s], and dmax_s - dmin_s <= D_s + 1
            dL, dR = (_lr_kill(dL, dR, v, ew2, dmin_s - 1, D_s + 4),
                      _lr_kill(dR, dL, v, ew1, -dmax_s - 1, D_s + 4))
        if v.median_order == 'after_lr':
            dL, dR = _median3x3(dL, v), _median3x3(dR, v)
    consensus = sum((torch.abs(w - d_int) <= 1).to(torch.int32)
                    for w in votes)
    # count * f32(1 / n): the JAX package's jitted division rounds so here
    # too (a true division differs at nb_dir 6 and 7)
    recip = float(np.float32(1 / len(votes)))
    return dL, consensus.to(torch.float32) * recip


def mgm_multi_match(im1, im2, disp_min: int, disp_max: int,
                    variant: MgmVariant, scales: int = 6, subpix: int = 2,
                    p2_map=None, p2_map_r=None, device=None):
    """Disparity of one rectified pair with the mgm_multi binary's
    semantics: the -S ``scales`` cascade with 1/``subpix`` candidate steps.

    Args:
        im1, im2: (h, w) float32 rectified pair of one shape, NaN outside
            the domain.
        disp_min, disp_max: the disparity range (ints).
        p2_map, p2_map_r: optional (h, w) per-pixel P2 of the left and the
            right scans (the lsd variant's weight maps times P2).
        device: None for CUDA (raises without it), or "cpu".
    Returns:
        (disp, confidence), (h, w) float32 tensors on the device.  The
        caller applies the speckle filter (``core/matching.py``)."""
    _check_variant(variant, single_tile=True)
    dev = resolve(device)
    im1 = np.asarray(im1, np.float32)
    im2 = np.asarray(im2, np.float32)
    if im1.shape != im2.shape:
        raise ValueError(f'the pair must share one shape: {im1.shape} and '
                         f'{im2.shape}')
    h, w = im1.shape
    D = int(disp_max) - int(disp_min) + 1

    def ints(x):
        return torch.tensor([x], dtype=torch.int64, device=dev)

    def maps(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float32), device=dev)[None]

    disp, conf = _multi_core(
        torch.as_tensor(im1, device=dev)[None],
        torch.as_tensor(im2, device=dev)[None], ints(int(disp_min)), D,
        variant, scales, subpix, ints(h), ints(w), ints(w), ints(D),
        maps(p2_map), maps(p2_map_r))
    return disp[0], conf[0]


def mgm_multi_match_batch(im1_b, im2_b, disp_min_b, D: int, h_b, w1_b, w2_b,
                          d_b, variant: MgmVariant = MgmVariant(),
                          scales: int = 6, subpix: int = 2, device=None):
    """The mgm_multi cascade over one bucket of tiles (cf.
    :func:`mgm_binary_match_batch`): (B, Hp, Wp) NaN-padded pairs, per-tile
    bases ``disp_min_b``, true extents and candidate counts ``d_b``, the
    bucket's padded candidate count ``D``.  Returns a dict of (B, Hp, Wp)
    float32 tensors on the device: 'disp' (NaN = rejected) and
    'confidence'."""
    _check_variant(variant, single_tile=True)
    dev = resolve(device)

    def ints(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int64,
                               device=dev).reshape(-1)

    disp, conf = _multi_core(
        torch.as_tensor(np.asarray(im1_b, np.float32), device=dev),
        torch.as_tensor(np.asarray(im2_b, np.float32), device=dev),
        ints(disp_min_b), int(D), variant, scales, subpix, ints(h_b),
        ints(w1_b), ints(w2_b), ints(d_b))
    return {'disp': disp, 'confidence': conf}
