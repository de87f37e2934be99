"""The mgm flow's three GPU kernels, their plain versions and their glue.

Counterpart of ``s2p_tpu/ops/sgm_pallas.py`` for the batched flow:

  * :func:`cost_prepass` -- K1, the uint8 census cost volume
    (``csrc/cost_prepass.cu``; TPU kernel ``_cost_prepass_kernel``);
  * :func:`scan` -- K2, one SGM scan pass over that volume, all
    same-orientation directions at once (``csrc/scan.cu``; TPU kernel
    ``_scan_kernel`` in cost mode);
  * :func:`wta` -- K3, winner-take-all with subpixel offset
    (``csrc/wta.cu``; TPU kernel ``_wta_kernel``, emit_offset mode
    without the right-reference map);
  * :func:`flow_partials_from_sigs` -- the pre-pass and the four scans of
    one side.

Every wrapper takes its ``*_plain`` version for CPU tensors and launches
its CUDA kernel for CUDA tensors; there is no other route.  Each launch
adds one to its count in :func:`launch_counts`.  Tensors carry a leading
batch axis of tiles.  Census signatures travel as int32 bit patterns (the
kernels read them as uint32): torch on the CPU has no uint32 shift and no
popcount, so the plain versions widen to int64 and use a SWAR popcount.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_VALID_BIT = 24          # census uses bits [0, 24) for win <= 5
_PAD_BIT = 25            # reference-side padding marker

# direction -> (pass, lateral carry offsets), as in the JAX package:
#   vertical fwd  (dy=+1): (0,1)->(0,+1)  (1,1)->(+1,0)  (-1,1)->(-1,0)
#   vertical bwd  (dy=-1): (0,-1)->(0,-1) (-1,-1)->(-1,0) (1,-1)->(+1,0)
#   horizontal fwd (dx=+1, transposed): (1,0)->(0,+1)
#   horizontal bwd (dx=-1, transposed): (-1,0)->(0,-1)
_PASS_OF_DIR = {
    (0, 1): ('vf', (0, 1)), (1, 1): ('vf', (1, 0)), (-1, 1): ('vf', (-1, 0)),
    (0, -1): ('vb', (0, -1)), (-1, -1): ('vb', (-1, 0)),
    (1, -1): ('vb', (1, 0)),
    (1, 0): ('hf', (0, 1)), (-1, 0): ('hb', (0, -1)),
}

_SUBPIX = {'vfit': 1, 'parabola': 2}
_SCAN_MAX_D = 512         # 16 groups of 32 candidates per chain (scan.cu)

_launches = {'cost_prepass': 0, 'scan': 0, 'wta': 0}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return dict(_launches)


def reset_launch_counts():
    for k in _launches:
        _launches[k] = 0


# --------------------------------------------------------------------- #
# launching
# --------------------------------------------------------------------- #

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = {
    's2p_cost_prepass': [_P, _P, _P, _P] + [_I] * 8 + [ctypes.c_uint, _P],
    's2p_scan': [_P, _LL, _LL, _LL, _LL, _P, _P, _P, _P]
                + [_I] * 8 + [_F, _F, _F, _I, _P],
    's2p_wta': [_P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL, _LL, _I, _P, _P]
               + [_I] * 5 + [_F, _P],
}


def _launch(lib_name, fn_name, *args, kernels=1):
    """Call one C launcher on the current stream; ``kernels`` is the
    number of kernel launches it makes."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        err = getattr(lib, fn_name + '_error')
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f'{fn_name} launch failed: CUDA error {rc} '
                           f'({err(rc).decode()})')
    _launches[lib_name] += kernels


def _route(*tensors):
    """'cpu' for the plain version, 'cuda' for the kernel; raises on a
    mix of devices or any other device."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f'tensors on several devices: {devs}')
    dev = devs.pop()
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {dev}')
    return dev.type


def _check(t, name, dtype, ndim, contiguous=True):
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if t.dim() != ndim:
        raise ValueError(f'{name}: expected {ndim} dims, got {tuple(t.shape)}')
    if contiguous and not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def _popcount(v):
    """SWAR popcount of the low 32 bits of non-negative int64 values."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


# --------------------------------------------------------------------- #
# K1: cost pre-pass
# --------------------------------------------------------------------- #

def cost_prepass_plain(s1t, s2tp, D, disp_min, nbits, pad, sec_len,
                       allowed=None):
    """Plain version of :func:`cost_prepass`, one candidate at a time."""
    B, N, L = s1t.shape
    N2 = s2tp.shape[1]
    s1 = s1t.long() & 0xFFFFFFFF
    s2 = s2tp.long() & 0xFFFFFFFF
    mask = (1 << nbits) - 1
    v1 = ((s1 >> _VALID_BIT) & 1) == 1
    in_pad = ((s1 >> _PAD_BIT) & 1) == 1
    n = torch.arange(N, device=s1t.device)
    out = torch.empty((B, N, D, L), dtype=torch.uint8, device=s1t.device)
    for k in range(D):
        ix = n + disp_min + k
        row = ix + pad
        inb = (ix >= 0) & (ix < sec_len) & (row >= 0) & (row < N2)
        s2k = s2[:, row.clamp(0, N2 - 1), :]                 # (B, N, L)
        v2 = ((s2k >> _VALID_BIT) & 1) == 1
        ham = _popcount((s1 ^ s2k) & mask)
        ok = v1 & v2 & inb[None, :, None]
        if allowed is not None:
            ok = ok & (allowed[:, k] == 1)[:, None, None]
        c = torch.where(ok, ham, 255)
        out[:, :, k, :] = torch.where(in_pad, 0, c).to(torch.uint8)
    return out


def cost_prepass(s1t, s2tp, D, disp_min, nbits, pad, sec_len, allowed=None):
    """(B, N, D, L) uint8 census cost volume in the transposed layout.

    Args:
        s1t: (B, N, L) int32 reference signatures, scan axis first.
        s2tp: (B, N2, L) int32 secondary signatures; scan row
            ``n + disp_min + pad + k`` is candidate k of position n.
        allowed: optional (B, D) int32, 1 where candidate k is searched.
    Entries: hamming distance, 255 for a candidate out of ``[0,
    sec_len)``, invalid or not allowed, 0 over reference padding."""
    _check(s1t, 's1t', torch.int32, 3)
    _check(s2tp, 's2tp', torch.int32, 3)
    B, N, L = s1t.shape
    N2 = s2tp.shape[1]
    if s2tp.shape[0] != B or s2tp.shape[2] != L:
        raise ValueError(f's2tp {tuple(s2tp.shape)} vs s1t {tuple(s1t.shape)}')
    if allowed is not None:
        _check(allowed, 'allowed', torch.int32, 2)
        if tuple(allowed.shape) != (B, D):
            raise ValueError(f'allowed must be ({B}, {D})')
    if not 0 < nbits <= _VALID_BIT:
        raise ValueError(f'nbits {nbits} outside (0, {_VALID_BIT}]')
    if _route(s1t, s2tp, allowed) == 'cpu':
        return cost_prepass_plain(s1t, s2tp, D, disp_min, nbits, pad,
                                  sec_len, allowed)
    out = torch.empty((B, N, D, L), dtype=torch.uint8, device=s1t.device)
    _launch('cost_prepass', 's2p_cost_prepass', s1t.data_ptr(),
            s2tp.data_ptr(), None if allowed is None else allowed.data_ptr(),
            out.data_ptr(), B, N, N2, L, D, disp_min, pad, sec_len,
            (1 << nbits) - 1)
    return out


# --------------------------------------------------------------------- #
# K2: scan pass
# --------------------------------------------------------------------- #

def _minconv(L, p1, p2):
    """SGM penalty update on (B, D, lanes) slabs, disparity on dim 1."""
    inf = torch.full_like(L[:, :1], float('inf'))
    lm = torch.cat([inf, L[:, :-1]], dim=1)
    lp = torch.cat([L[:, 1:], inf], dim=1)
    m = L.amin(dim=1, keepdim=True)
    return torch.minimum(torch.minimum(L, torch.minimum(lm, lp) + p1),
                         m + p2) - m


def scan_plain(cost, p2, lats, p1, invalid_cost, reverse, sub_cost_mult=0.0,
               accum=None, emit_votes=True):
    """Plain version of :func:`scan`: a Python loop over the scan rows."""
    B, N, D, lanes = cost.shape
    dev = cost.device
    S = torch.empty((B, N, D, lanes), dtype=torch.float32, device=dev)
    votes = (torch.empty((B, len(lats), N, lanes), dtype=torch.int32,
                         device=dev) if emit_votes else None)
    x = torch.arange(lanes, device=dev)
    k_ids = torch.arange(D, dtype=torch.int32, device=dev)[None, :, None]
    inv = torch.tensor(invalid_cost, dtype=torch.float32, device=dev)
    sub = torch.tensor(sub_cost_mult, dtype=torch.float32, device=dev)
    carries = [None] * len(lats)
    for s in range(N):
        n = N - 1 - s if reverse else s
        ci = cost[:, n].to(torch.int32)                      # (B, D, lanes)
        c = torch.where(ci == 255, inv, ci.to(torch.float32))
        p2r = p2[:, n].unsqueeze(1)                          # (B, 1, lanes)
        ssum = None
        for d, lat in enumerate(lats):
            if s == 0:
                contrib = torch.zeros_like(c)                # first row
            else:
                Lp = (torch.roll(carries[d], lat, dims=2) if lat
                      else carries[d])
                contrib = _minconv(Lp, p1, p2r)
                if lat > 0:
                    contrib = torch.where(x < lat, 0.0, contrib)
                elif lat < 0:
                    contrib = torch.where(x >= lanes + lat, 0.0, contrib)
            L = c + contrib
            carries[d] = L
            ssum = L if ssum is None else ssum + L
            if emit_votes:
                mn = L.amin(dim=1, keepdim=True)
                votes[:, d, n] = torch.where(L == mn, k_ids, D).amin(dim=1)
        if sub_cost_mult:
            ssum = ssum - sub * c
        if accum is not None:
            ssum = ssum + accum[:, n]
        S[:, n] = ssum
    return S, votes


def scan(cost, p2, lats, p1, invalid_cost, reverse, sub_cost_mult=0.0,
         accum=None, emit_votes=True):
    """One SGM scan pass over a uint8 cost volume.

    Args:
        cost: (B, N, D, lanes) uint8, any strides (255 = invalid_cost).
        p2: (B, N, lanes) float32 per-pixel P2.
        lats: lateral carry offset of each direction (1 to 3 of them).
        sub_cost_mult: the overcount fix ``S -= sub * cost`` (one pass).
        accum: optional (B, N, D, lanes) float32 added to S.
    Returns:
        (S (B, N, D, lanes) float32, votes (B, len(lats), N, lanes) int32
        or None)."""
    _check(cost, 'cost', torch.uint8, 4, contiguous=False)
    B, N, D, lanes = cost.shape
    _check(p2, 'p2', torch.float32, 3)
    if tuple(p2.shape) != (B, N, lanes):
        raise ValueError(f'p2 must be {(B, N, lanes)}, got {tuple(p2.shape)}')
    if accum is not None:
        _check(accum, 'accum', torch.float32, 4)
        if accum.shape != cost.shape:
            raise ValueError('accum must have the shape of cost')
    lats = tuple(int(v) for v in lats)
    if not 1 <= len(lats) <= 3:
        raise ValueError(f'1 to 3 directions per pass, got {lats}')
    if _route(cost, p2, accum) == 'cpu':
        return scan_plain(cost, p2, lats, p1, invalid_cost, reverse,
                          sub_cost_mult, accum, emit_votes)
    if D > _SCAN_MAX_D:
        raise ValueError(f'the scan kernel takes at most {_SCAN_MAX_D} '
                         f'candidates, got {D}')
    dev = cost.device
    S = torch.empty((B, N, D, lanes), dtype=torch.float32, device=dev)
    votes = (torch.empty((B, len(lats), N, lanes), dtype=torch.int32,
                         device=dev) if emit_votes else None)
    lat3 = lats + (0,) * (3 - len(lats))
    _launch('scan', 's2p_scan', cost.data_ptr(), *cost.stride(),
            p2.data_ptr(), None if accum is None else accum.data_ptr(),
            S.data_ptr(), None if votes is None else votes.data_ptr(),
            B, N, D, lanes, len(lats), *lat3, float(p1),
            float(invalid_cost), float(sub_cost_mult), int(bool(reverse)),
            kernels=len(lats))
    return S, votes


# --------------------------------------------------------------------- #
# K3: winner-take-all
# --------------------------------------------------------------------- #

def wta_plain(parts, subpix, big_guard):
    """Plain version of :func:`wta`."""
    S = parts[0]
    for p in parts[1:]:
        S = S + p
    B, H, D, W = S.shape
    dev = S.device
    mn = S.amin(dim=2)
    k_ids = torch.arange(D, device=dev)[None, None, :, None]
    d = torch.where(S == mn.unsqueeze(2), k_ids, D).amin(dim=2)
    inf = torch.tensor(float('inf'), dtype=torch.float32, device=dev)

    def at(idx):
        return torch.gather(S, 2, idx.clamp(0, D - 1).unsqueeze(2)).squeeze(2)

    c0 = torch.where(d > 0, at(d - 1), inf)
    c2 = torch.where(d < D - 1, at(d + 1), inf)
    guard = mn + 1e6
    c0 = torch.where(torch.isfinite(c0), c0, guard)
    c2 = torch.where(torch.isfinite(c2), c2, guard)
    interior = (d > 0) & (d < D - 1) & (c0 < big_guard) & (c2 < big_guard)
    eps = torch.tensor(1e-9, dtype=torch.float32, device=dev)
    if subpix == 'vfit':
        den = 2.0 * (torch.maximum(c0, c2) - mn)
        off = ((c0 - c2) / torch.maximum(den, eps)).clamp(-0.5, 0.5)
    elif subpix == 'parabola':
        den = c0 - 2.0 * mn + c2
        off = (0.5 * (c0 - c2) / torch.maximum(den, eps)).clamp(-0.5, 0.5)
    else:
        off = torch.zeros_like(mn)
    off = torch.where(interior, off, 0.0)
    off = torch.where(mn < big_guard, off, float('nan'))
    return off, d.to(torch.int32)


def wta(parts, subpix, big_guard):
    """Winner-take-all over the summed partials.

    Args:
        parts: one or two (B, H, D, W) float32 volumes, any strides,
            summed in order.
        subpix: 'vfit', 'parabola' or anything else for no refinement.
        big_guard: costs at or above it count as out of range.
    Returns:
        (off (B, H, W) float32, NaN where no candidate is in range;
        d_int (B, H, W) int32)."""
    if not 1 <= len(parts) <= 2:
        raise ValueError('wta sums one or two partial volumes')
    for i, p in enumerate(parts):
        _check(p, f'parts[{i}]', torch.float32, 4, contiguous=False)
        if p.shape != parts[0].shape:
            raise ValueError('partials must share one shape')
    if _route(*parts) == 'cpu':
        return wta_plain(parts, subpix, big_guard)
    B, H, D, W = parts[0].shape
    dev = parts[0].device
    off = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    d_int = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    p1 = parts[-1]
    _launch('wta', 's2p_wta', parts[0].data_ptr(), *parts[0].stride(),
            p1.data_ptr(), *p1.stride(), len(parts), off.data_ptr(),
            d_int.data_ptr(), B, H, D, W, _SUBPIX.get(subpix, 0),
            float(big_guard))
    return off, d_int


# --------------------------------------------------------------------- #
# one side of the flow
# --------------------------------------------------------------------- #

def scan_passes(variant):
    """The flow's scan passes in launch order: [(key, direction indices,
    lateral offsets)], key 'hf', 'hb', 'vf' or 'vb'.  The first pass
    applies the overcount fix; a later pass of one orientation adds the
    earlier one."""
    from .mgm_flow import _DIRS_8

    dirs = _DIRS_8[:max(2, min(variant.nb_dir, 8))]
    passes = {}
    for i, d in enumerate(dirs):
        key, (main, _) = _PASS_OF_DIR[d]
        passes.setdefault(key, ([], []))
        passes[key][0].append(i)
        passes[key][1].append(main)
    return [(key, tuple(idx), tuple(lats))
            for key, (idx, lats) in passes.items()]


def flow_partials_from_sigs(s1, s2, D, variant, allowed=None,
                            emit_votes=True):
    """Aggregation partials of one side of the batched flow.

    ``s1`` (B, H, W) are the bit-annotated reference signatures, ``s2``
    (B, H, W + margin) the rebased secondary ones (base disparity 0).  The
    uint8 cost volume is built once in the (W, D, H) layout; the
    horizontal passes scan it along W, the vertical ones a transposed copy
    along H.  Classic independent scans (tsgm=1), BIG out-of-range costs,
    the overcount fix on the first pass, every later pass of an
    orientation accumulating into the previous one.

    Returns ([S_v (B, H, D, W), S_h viewed as (B, H, D, W)], votes list
    of (B, H, W) int32 in direction order, None where not emitted)."""
    from .mgm_flow import BIG

    B, H, W = s1.shape
    if s2.shape[2] <= W:
        raise ValueError('the rebased secondary must be wider than the '
                         'reference')
    nbits = variant.census_win ** 2 - 1
    s1t = s1.transpose(1, 2).contiguous()                    # (B, W, H)
    s2t = s2.transpose(1, 2).contiguous()                    # (B, W2, H)
    cost_h = cost_prepass(s1t, s2t, D, 0, nbits, 0, s2.shape[2],
                          allowed=allowed)                   # (B, W, D, H)
    # the vertical passes read (B, H, D, W): one transposed copy lets
    # every scan load coalesce along its lanes
    cost = {'v': cost_h.permute(0, 3, 2, 1).contiguous(), 'h': cost_h}
    p2 = {'v': torch.full((B, H, W), variant.p2, dtype=torch.float32,
                          device=s1.device),
          'h': torch.full((B, W, H), variant.p2, dtype=torch.float32,
                          device=s1.device)}

    S = {'v': None, 'h': None}
    passes = scan_passes(variant)
    votes = [None] * sum(len(idx) for _, idx, _ in passes)
    sub = float(len(votes) - 1) if variant.overcount_fix else 0.0
    for key, dir_idx, lats in passes:
        o = key[0]
        S[o], v = scan(cost[o], p2[o], lats, variant.p1, BIG,
                       reverse=key[1] == 'b', sub_cost_mult=sub,
                       accum=S[o], emit_votes=emit_votes)
        sub = 0.0                # exactly one pass applies the fix
        if v is not None:
            for j, i in enumerate(dir_idx):
                votes[i] = v[:, j] if o == 'v' else v[:, j].transpose(1, 2)
    parts = [S['v']] if S['v'] is not None else []
    if S['h'] is not None:
        parts.append(S['h'].permute(0, 3, 2, 1))
    return parts, votes
