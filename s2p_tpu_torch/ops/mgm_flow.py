"""The mgm binary's output flow, batched over tiles (stage 4).

Counterpart of ``s2p_tpu/ops/mgm_flow.py`` for the batch entry
:func:`mgm_binary_match_batch` and the pieces it runs.  The semantics are
those of the JAX package, to the bit: census on raw values (NaN pixels
give 0 bits), BIG = 1e9 for out-of-range candidates, the classic
8-direction SGM recursion with the overcount fix, vfit subpixel, a 3x3
NaN-discarding median on both maps before the left-right test, and the
consensus confidence of the L side's per-direction votes.

Batched tiles share a padded (B, H, W) shape.  Every tile is rebased to
disparity base 0: its base rides a column shift of the secondary
signatures (:func:`_shift_sig_cols`), its true extents ride signature bits
(``_VALID_BIT`` clear -> BIG cost, ``_PAD_BIT`` set -> zero cost over
reference padding), and its true candidate count is a (D,) mask.  Each
tile's output is bitwise the output of its unpadded run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from .sgm_kernels import (_PAD_BIT, _VALID_BIT, flow_partials_from_sigs,
                          wta)

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
    """(B, h, w) bool: True beyond each tile's true extents."""
    ys = torch.arange(h, device=device)[None, :, None] >= h_true[:, None, None]
    xs = torch.arange(w, device=device)[None, None, :] >= w_true[:, None, None]
    return ys | xs


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
    confidence = consensus.to(torch.float32) / len(votes)
    return dL, confidence


def _check_variant(v: MgmVariant):
    if v.tsgm != 1:
        raise NotImplementedError('tsgm >= 2 (the TSGM wavefront) is not '
                                  'ported yet (ROADMAP M12)')
    if v.census_win ** 2 - 1 > _VALID_BIT:
        raise NotImplementedError(f'census_win {v.census_win}: the kernels '
                                  'take windows up to 5x5')
    if v.edge_subpix or v.subpix_plateau != 'clip':
        raise NotImplementedError('edge_subpix and subpix_plateau belong to '
                                  'the lax single-tile flow, not ported')


def _side_sigs(sig_ref, sig_sec, base, h_ref, w_ref, w_sec, D):
    """Kernel inputs of one side: the reference signatures with the valid
    bit and the padding bit beyond (h_ref, w_ref), and the secondary ones
    rebased to base 0 with a margin of D columns (candidate positions
    reach W - 1 + D - 1, and the rebase may shift content right by up to
    the full range).  Returns (sr, ss, padding mask)."""
    B, H, W = sig_ref.shape
    pad = _pad_mask(H, W, h_ref, w_ref, sig_ref.device)
    sr = sig_ref | (1 << _VALID_BIT) | (pad.to(torch.int32) << _PAD_BIT)
    shifts, widths = base.tolist(), w_sec.tolist()
    ss = torch.stack([_shift_sig_cols(sig_sec[i], shifts[i], widths[i],
                                      extra=D) for i in range(B)])
    return sr, ss, pad


def _flow_batched(a, b, dm, D, h1, w1, w2, dt, v: MgmVariant):
    """The batched flow on one device: L side with votes, R side without,
    then the post chain.  The per-tile scalars are (B,) int32 tensors on
    the device."""
    dev = a.device
    s1 = census_bits_raw(a, v.census_win)
    s2 = census_bits_raw(b, v.census_win)
    allowed = (torch.arange(D, device=dev)[None, :]
               < dt[:, None]).to(torch.int32)                # (B, D)

    def side(sig_ref, sig_sec, base, h_ref, w_ref, w_sec, need_votes):
        sr, ss, pad = _side_sigs(sig_ref, sig_sec, base, h_ref, w_ref,
                                 w_sec, D)
        parts, votes = flow_partials_from_sigs(sr, ss, D, v, allowed=allowed,
                                               emit_votes=need_votes)
        off, d_int = wta(parts, v.subpix, BIG / 2)
        # (base + d_int) + off: the JAX package's float composition
        disp = (base.to(torch.float32)[:, None, None]
                + d_int.to(torch.float32)) + off
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
    disp, conf = _flow_batched(a, b, dm, int(D), ints(h_b), ints(w1_b),
                               ints(w2_b), d_b, variant)
    nv = max(2, min(variant.nb_dir, 8))
    # consensus counts as uint8: count/n in f32 is rebuilt exactly
    return {'disp': disp, 'confidence': conf,
            'confidence_u8': (conf * nv).to(torch.uint8)}
