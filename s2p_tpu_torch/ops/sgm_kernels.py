"""The GPU kernels of the SGM matchers, their plain versions and their glue.

Counterpart of ``s2p_tpu/ops/sgm_pallas.py``:

  * :func:`cost_prepass` -- K1, the uint8 census cost volume
    (``csrc/cost_prepass.cu``; TPU kernel ``_cost_prepass_kernel``);
  * :func:`scan` -- K2, one SGM scan pass over that volume, all
    same-orientation directions at once (``csrc/scan.cu``; TPU kernel
    ``_scan_kernel`` in cost mode), or over a uint16 volume (its 16-bit
    source, for the flow's lax route at census windows from 16x16 up);
  * :func:`scan_sig` -- one SGM scan pass with the census cost built in
    the kernel from bit-packed signatures: K4a with one lateral per
    direction (``csrc/scan.cu``), also over tiles side by side on the
    lane axis (``seg_w``, the lane-fold mode), K4b with averaged MGM
    laterals (``csrc/scan_mgm.cu``); TPU kernel ``_scan_kernel`` in its
    signature modes;
  * :func:`wta` -- K3, winner-take-all with subpixel offset
    (``csrc/wta.cu``; TPU kernel ``_wta_kernel``, emit_offset mode
    without the right-reference map), with the single-tile flow's
    ``edge_subpix`` and ``plateau_zero`` modes;
  * :func:`wta_dr` -- K5, winner-take-all with the disparity composed in
    the kernel and the right-reference disparity (``csrc/wta.cu``; TPU
    kernel ``_wta_kernel`` with ``with_dr``);
  * :func:`flow_partials_sides` -- the pre-pass and the four scans of
    each side of the mgm flow, at the batch's rebased base 0 or the single
    tile's signed base, the independent chains of scan launches on side
    streams at once (:func:`flow_chains`); :func:`flow_partials_from_sigs`
    -- one side; :func:`flow_one_side` -- one side of the single
    tile (``flow_one_side_pallas``); :func:`flow_partials_folded` -- one
    side of lane-folded tile groups;
  * :func:`aggregate` and :func:`match_kernels` -- the classic SGM
    census matcher's aggregation and its fused WTA (``sgm_pallas.aggregate``
    and ``match_pallas``).

Every wrapper takes its ``*_plain`` version for CPU tensors and launches
its CUDA kernel for CUDA tensors; there is no other route.  Each launch
adds one to its count in :func:`launch_counts`.  Tensors carry a leading
batch axis of tiles.  Census signatures travel as int32 bit patterns (the
kernels read them as uint32): torch on the CPU has no uint32 shift and no
popcount, so the plain versions widen to int64 and use a SWAR popcount.
"""

from __future__ import annotations

import contextlib
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

_launches = {'cost_prepass': 0, 'scan': 0, 'scan16': 0, 'wta': 0,
             'wta_edge': 0,
             'scan_sig': 0, 'scan_sig_seg': 0, 'scan_mgm': 0,
             'scan_mgm_global': 0, 'wta_dr': 0}

# K4b: the shared memory a block may take on the H100 (227 KB); a pass
# whose carry needs more runs the global instantiation
_MAX_SHARED = 232448


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return dict(_launches)


def reset_launch_counts():
    for k in _launches:
        _launches[k] = 0


# --------------------------------------------------------------------- #
# launching
# --------------------------------------------------------------------- #

_P, _I, _LL, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float, ctypes.c_uint
_IP = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    's2p_cost_prepass': [_P, _P, _P, _P] + [_I] * 8 + [_U, _P],
    's2p_scan': [_P, _LL, _LL, _LL, _LL, _P, _P, _P, _P]
                + [_I] * 8 + [_F, _F, _F, _I, _P],
    's2p_scan16': [_P, _LL, _LL, _LL, _LL, _P, _P, _P, _P]
                  + [_I] * 8 + [_F, _F, _F, _I, _P],
    's2p_scan_sig': [_P] * 7 + [_I] * 9 + [_U] + [_I] * 5
                    + [_F, _F, _F, _I, _P],
    's2p_scan_mgm': [_P] * 10 + [_I] * 9 + [_U, _I, _IP, _IP]
                    + [_F, _F, _F, _I, _P],
    's2p_cluster_sync_loop': [_I, _I, _P],
    's2p_wta': [_P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL, _LL, _I, _P, _P]
               + [_I] * 7 + [_F, _P],
    's2p_wta_dr': [_P, _LL, _LL, _LL, _LL, _P, _LL, _LL, _LL, _LL, _I, _P,
                   _P, _P] + [_I] * 6 + [_P],
}


def _launch(lib_name, fn_name, *args, key=None, kernels=1):
    """Call one C launcher on the current stream; ``kernels`` is the
    number of kernel launches it makes, counted under ``key`` (default
    the library's name)."""
    _build.call(lib_name, fn_name, _ARGTYPES[fn_name], *args)
    _launches[key or lib_name] += kernels


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


def _fma32(a, b, c):
    """float32 ``a * f32(b) + c`` rounded once, as a fused multiply-add;
    ``b`` is a number or a float32 tensor.

    The averaged MGM laterals compute ``cost + c * f32(1 / n)``; the JAX
    package's CPU run contracts that multiply-add into one fused operation
    (XLA), and the CUDA kernel uses ``__fmaf_rn``.  torch has no fused
    multiply-add, so: the product is exact in float64, TwoSum gives the
    exact error of the float64 sum, and rounding that sum to odd before
    the float32 rounding makes the result the correctly rounded one."""
    if torch.is_tensor(b):
        p = a.double() * b.double()                          # exact
    else:
        p = a.double() * torch.tensor(b, dtype=torch.float32).item()
    c64 = c.double()
    s = c64 + p
    bp = s - c64
    e = (c64 - (s - bp)) + (p - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, float('inf'), float('-inf')).double()
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _scan_loop(cost_row, p2, dirs, p1, reverse, sub_cost_mult, accum,
               emit_votes, D, seg_w=None):
    """The plain SGM recursion of one pass: a Python loop over the scan
    rows.  ``cost_row(n)`` gives row n's (B, D, lanes) float32 cost;
    ``dirs`` holds the lateral offsets of each direction, averaged where a
    direction has several (MGM).  With ``seg_w`` the lanes are segments
    of that width and no lateral carry crosses a segment edge."""
    B, N, lanes = p2.shape
    dev = p2.device
    S = torch.empty((B, N, D, lanes), dtype=torch.float32, device=dev)
    votes = (torch.empty((B, len(dirs), N, lanes), dtype=torch.int32,
                         device=dev) if emit_votes else None)
    seg_w = seg_w or lanes
    x = torch.arange(lanes, device=dev) % seg_w
    k_ids = torch.arange(D, dtype=torch.int32, device=dev)[None, :, None]
    sub = torch.tensor(sub_cost_mult, dtype=torch.float32, device=dev)
    carries = [None] * len(dirs)
    for s in range(N):
        n = N - 1 - s if reverse else s
        c = cost_row(n)                                      # (B, D, lanes)
        p2r = p2[:, n].unsqueeze(1)                          # (B, 1, lanes)
        ssum = None
        for d, lats in enumerate(dirs):
            contrib = None
            for lat in lats:
                if s == 0:
                    t = torch.zeros_like(c)                  # first row
                else:
                    Lp = (torch.roll(carries[d], lat, dims=2) if lat
                          else carries[d])
                    t = _minconv(Lp, p1, p2r)
                    if lat > 0:
                        t = torch.where(x < lat, 0.0, t)
                    elif lat < 0:
                        t = torch.where(x >= seg_w + lat, 0.0, t)
                contrib = t if contrib is None else contrib + t
            if len(lats) > 1:
                L = _fma32(contrib, 1.0 / len(lats), c)
            else:
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


def scan_plain(cost, p2, lats, p1, invalid_cost, reverse, sub_cost_mult=0.0,
               accum=None, emit_votes=True):
    """Plain version of :func:`scan`: a Python loop over the scan rows."""
    inv = torch.tensor(invalid_cost, dtype=torch.float32, device=cost.device)
    sentinel = 255 if cost.dtype == torch.uint8 else 65535

    def cost_row(n):
        ci = cost[:, n].to(torch.int32)                      # (B, D, lanes)
        return torch.where(ci == sentinel, inv, ci.to(torch.float32))

    return _scan_loop(cost_row, p2, tuple((lat,) for lat in lats), p1,
                      reverse, sub_cost_mult, accum, emit_votes,
                      cost.shape[2])


def scan(cost, p2, lats, p1, invalid_cost, reverse, sub_cost_mult=0.0,
         accum=None, emit_votes=True):
    """One SGM scan pass over an integer cost volume.

    Args:
        cost: (B, N, D, lanes) uint8 (255 = invalid_cost) or uint16
            (65535 = invalid_cost: K2's 16-bit source), any strides.
        p2: (B, N, lanes) float32 per-pixel P2.
        lats: lateral carry offset of each direction (1 to 3 of them).
        sub_cost_mult: the overcount fix ``S -= sub * cost`` (one pass).
        accum: optional (B, N, D, lanes) float32 added to S.
    Returns:
        (S (B, N, D, lanes) float32, votes (B, len(lats), N, lanes) int32
        or None)."""
    wide = cost.dtype == torch.uint16
    _check(cost, 'cost', torch.uint16 if wide else torch.uint8, 4,
           contiguous=False)
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
    dev = cost.device
    S = torch.empty((B, N, D, lanes), dtype=torch.float32, device=dev)
    votes = (torch.empty((B, len(lats), N, lanes), dtype=torch.int32,
                         device=dev) if emit_votes else None)
    lat3 = lats + (0,) * (3 - len(lats))
    _launch('scan', 's2p_scan16' if wide else 's2p_scan', cost.data_ptr(),
            *cost.stride(),
            p2.data_ptr(), None if accum is None else accum.data_ptr(),
            S.data_ptr(), None if votes is None else votes.data_ptr(),
            B, N, D, lanes, len(lats), *lat3, float(p1),
            float(invalid_cost), float(sub_cost_mult), int(bool(reverse)),
            key='scan16' if wide else 'scan', kernels=len(lats))
    return S, votes


# --------------------------------------------------------------------- #
# K4: scan pass with the census cost built from signatures
# --------------------------------------------------------------------- #

def _sig_cost_row(s1, s2, D, disp_min, nbits, horizontal, pad, sec_len,
                  invalid_cost, allowed):
    """``cost_row(n)`` of the signature modes: (B, D, lanes) float32.
    ``allowed`` is (B, D), or (B, segments, D) for lanes in segments."""
    dev = s1.device
    s1l = s1.long() & 0xFFFFFFFF
    s2l = s2.long() & 0xFFFFFFFF
    mask = (1 << nbits) - 1
    k = torch.arange(D, device=dev)
    inv = torch.tensor(invalid_cost, dtype=torch.float32, device=dev)
    al = None
    if allowed is not None and allowed.dim() == 2:
        al = (allowed == 1)[:, :, None]
    elif allowed is not None:
        seg_w = s1.shape[2] // allowed.shape[1]
        al = (allowed == 1).repeat_interleave(seg_w, dim=1).transpose(1, 2)

    def cost_row(n):
        a = s1l[:, n][:, None, :]                            # (B, 1, lanes)
        if horizontal:
            ix = n + disp_min + k                            # (D,)
            row = (ix + pad).clamp(0, s2l.shape[1] - 1)
            s = s2l[:, row, :]                               # (B, D, lanes)
            inb = ((ix >= 0) & (ix < sec_len))[None, :, None]
        else:
            ix = (torch.arange(s1.shape[2], device=dev)[None, :]
                  + disp_min + k[:, None])                   # (D, lanes)
            s = s2l[:, n][:, ix.clamp(0, s2l.shape[2] - 1)]  # (B, D, lanes)
            inb = ((ix >= 0) & (ix < sec_len))[None]
        ok = ((((a >> _VALID_BIT) & 1) == 1) & (((s >> _VALID_BIT) & 1) == 1)
              & inb)
        if al is not None:
            ok = ok & al
        ham = _popcount((a ^ s) & mask).to(torch.float32)
        c = torch.where(ok, ham, inv)
        return torch.where(((a >> _PAD_BIT) & 1) == 1, 0.0, c)

    return cost_row


def scan_sig_plain(s1, s2, p2, dirs, p1, invalid_cost, nbits, D, disp_min,
                   sec_len, reverse, horizontal, pad=0, sub_cost_mult=0.0,
                   allowed=None, accum=None, emit_votes=True, seg_w=None):
    """Plain version of :func:`scan_sig` (both kernels, K4a and K4b)."""
    cost_row = _sig_cost_row(s1, s2, D, disp_min, nbits, horizontal, pad,
                             sec_len, invalid_cost, allowed)
    return _scan_loop(cost_row, p2, dirs, p1, reverse, sub_cost_mult, accum,
                      emit_votes, D, seg_w)


def scan_mgm_variant(D, lanes, horizontal):
    """K4b's instantiation for a pass on the card: 'shared' where a
    direction's carry fits a block's shared memory (a cluster of 16
    blocks, ``ceil(lanes / 16)`` lanes each), else 'global'."""
    lib = _build.load('scan_mgm')
    fn = lib.s2p_scan_mgm_shared_bytes
    fn.argtypes, fn.restype = [_I] * 3, ctypes.c_longlong
    need = fn(D, lanes, int(bool(horizontal)))
    return 'shared' if need <= _MAX_SHARED else 'global'


def _mgm_part_volumes(n_dirs, sub_cost_mult):
    """The (B, N, D, lanes) scratch volumes K4b takes for a pass."""
    fn = _build.load('scan_mgm').s2p_scan_mgm_part_volumes
    fn.argtypes, fn.restype = [_I, _F], ctypes.c_int
    return fn(n_dirs, float(sub_cost_mult))


def cluster_sync_loop(B, steps):
    """``steps`` cluster barriers in B clusters of K4b's launch shape and
    no other work, on the current stream: K4b's step floor."""
    _launch('scan_mgm', 's2p_cluster_sync_loop', int(B), int(steps),
            key='scan_mgm', kernels=0)


def scan_sig(s1, s2, p2, dirs, p1, invalid_cost, nbits, D, disp_min,
             sec_len, reverse, horizontal, pad=0, sub_cost_mult=0.0,
             allowed=None, accum=None, emit_votes=True, seg_w=None,
             mgm_variant=None):
    """One SGM scan pass with the census cost built from signatures.

    Args:
        s1: (B, N, lanes) int32 packed reference signatures, scan axis
            first (transposed for a horizontal pass); ``_VALID_BIT`` marks
            valid pixels, ``_PAD_BIT`` reference padding (cost 0).
        s2: vertical: (B, N, W2) secondary signatures, candidate k of lane
            x at column ``x + disp_min + k``; horizontal: (B, N2, lanes),
            candidate k of step n at row ``n + disp_min + pad + k``.
        p2: (B, N, lanes) float32 per-pixel P2.
        dirs: per direction (1 to 3 of them) its lateral carry offsets:
            one each runs K4a (``csrc/scan.cu``), several (averaged, MGM)
            K4b (``csrc/scan_mgm.cu``), whose offsets must be -1, 0 or +1.
        sec_len: candidate positions ``[0, sec_len)`` are in range.
        allowed: optional (B, D) int32, 1 where candidate k is searched;
            (B, lanes // seg_w, D) with ``seg_w``, one row per segment.
        sub_cost_mult, accum: as in :func:`scan`.
        seg_w: the lanes are segments of this width (tiles side by side,
            the lane-fold mode): a lateral carry never crosses a segment
            edge.  One lateral per direction (K4a) only.
        mgm_variant: K4b's instantiation on the card, None to choose by
            shape (:func:`scan_mgm_variant`); 'shared' or 'global' forces
            one (a 'shared' that does not fit raises).
    Returns:
        (S (B, N, D, lanes) float32, votes (B, len(dirs), N, lanes) int32
        or None)."""
    _check(s1, 's1', torch.int32, 3)
    _check(s2, 's2', torch.int32, 3)
    B, N, lanes = s1.shape
    _check(p2, 'p2', torch.float32, 3)
    if tuple(p2.shape) != (B, N, lanes):
        raise ValueError(f'p2 must be {(B, N, lanes)}, got {tuple(p2.shape)}')
    if horizontal:
        len2 = s2.shape[1]
        if s2.shape[0] != B or s2.shape[2] != lanes:
            raise ValueError(f's2 {tuple(s2.shape)} vs s1 {tuple(s1.shape)}')
        if pad < 0 or sec_len + pad > len2:
            raise ValueError(f'rows [pad, sec_len + pad) = [{pad}, '
                             f'{sec_len + pad}) must lie in s2 ({len2} rows)')
    else:
        len2 = s2.shape[2]
        if tuple(s2.shape[:2]) != (B, N):
            raise ValueError(f's2 {tuple(s2.shape)} vs s1 {tuple(s1.shape)}')
        if sec_len > len2:
            raise ValueError(f'sec_len {sec_len} exceeds the secondary '
                             f'width {len2}')
    dirs = tuple(tuple(int(v) for v in lats) for lats in dirs)
    if not 1 <= len(dirs) <= 3 or not all(1 <= len(l) <= 3 for l in dirs):
        raise ValueError(f'1 to 3 directions of 1 to 3 laterals, got {dirs}')
    mgm = any(len(l) > 1 for l in dirs)
    if mgm and any(v not in (-1, 0, 1) for l in dirs for v in l):
        raise ValueError(f'MGM laterals must be -1, 0 or +1, got {dirs}')
    if mgm_variant not in (None, 'shared', 'global'):
        raise ValueError(f'mgm_variant {mgm_variant!r}')
    if seg_w is not None:
        if not 0 < seg_w <= lanes or lanes % seg_w:
            raise ValueError(f'seg_w {seg_w} must divide the {lanes} lanes')
        if any(len(l) > 1 for l in dirs):
            raise ValueError('seg_w takes one lateral per direction')
    if allowed is not None:
        want = (B, D) if seg_w is None else (B, lanes // seg_w, D)
        _check(allowed, 'allowed', torch.int32, len(want))
        if tuple(allowed.shape) != want:
            raise ValueError(f'allowed must be {want}')
    if accum is not None:
        _check(accum, 'accum', torch.float32, 4)
        if tuple(accum.shape) != (B, N, D, lanes):
            raise ValueError(f'accum must be {(B, N, D, lanes)}')
    if not 0 < nbits <= _VALID_BIT:
        raise ValueError(f'nbits {nbits} outside (0, {_VALID_BIT}]')
    if _route(s1, s2, p2, allowed, accum) == 'cpu':
        return scan_sig_plain(s1, s2, p2, dirs, p1, invalid_cost, nbits, D,
                              disp_min, sec_len, reverse, horizontal, pad,
                              sub_cost_mult, allowed, accum, emit_votes,
                              seg_w)
    dev = s1.device
    S = torch.empty((B, N, D, lanes), dtype=torch.float32, device=dev)
    votes = (torch.empty((B, len(dirs), N, lanes), dtype=torch.int32,
                         device=dev) if emit_votes else None)
    ptrs = (s1.data_ptr(), s2.data_ptr(),
            None if allowed is None else allowed.data_ptr(), p2.data_ptr(),
            None if accum is None else accum.data_ptr(), S.data_ptr(),
            None if votes is None else votes.data_ptr())
    geom = (B, N, D, lanes, len2, int(bool(horizontal)), int(disp_min),
            int(pad), int(sec_len), (1 << nbits) - 1, len(dirs))
    tail = (float(p1), float(invalid_cost), float(sub_cost_mult),
            int(bool(reverse)))
    if not mgm:
        lat3 = tuple(l[0] for l in dirs) + (0,) * (3 - len(dirs))
        _launch('scan', 's2p_scan_sig', *ptrs, *geom, *lat3,
                seg_w or lanes, *tail,
                key='scan_sig' if seg_w is None else 'scan_sig_seg',
                kernels=len(dirs))
    else:
        # one launch of a cluster per direction and tile, and one of the
        # directions' sum where there are several (their L and the cost
        # in ``part``); the global instantiation's carry and minima live
        # in scratch, the shared one's in the clusters
        nd = len(dirs)
        variant = mgm_variant or scan_mgm_variant(D, lanes, horizontal)
        carry = mins = None
        if variant == 'global':
            carry = torch.empty((B, nd, 2, D + 2, lanes), dtype=torch.float32,
                                device=dev)
            mins = torch.empty((B, nd, 2, lanes), dtype=torch.float32,
                               device=dev)
        n_part = _mgm_part_volumes(nd, sub_cost_mult)
        part = (torch.empty((n_part, B, N, D, lanes), dtype=torch.float32,
                            device=dev) if n_part else None)
        n_lats = (ctypes.c_int * 3)(*[len(l) for l in dirs])
        lats = (ctypes.c_int * 9)(*[v for l in dirs
                                    for v in l + (0,) * (3 - len(l))])
        _launch('scan_mgm', 's2p_scan_mgm', *ptrs,
                *(None if t is None else t.data_ptr()
                  for t in (carry, mins, part)), *geom, n_lats, lats, *tail,
                key='scan_mgm' if variant == 'shared' else 'scan_mgm_global',
                kernels=1 if nd == 1 else 2)
    return S, votes


# --------------------------------------------------------------------- #
# K3: winner-take-all
# --------------------------------------------------------------------- #

def _argmin(S):
    """(min over dim 2, its lowest index) of a (B, H, D, W) volume."""
    D = S.shape[2]
    mn = S.amin(dim=2)
    k_ids = torch.arange(D, device=S.device)[None, None, :, None]
    return mn, torch.where(S == mn.unsqueeze(2), k_ids, D).amin(dim=2)


def _refine(S, d, c1, subpix, big_guard=None, edge_subpix=False,
            plateau_zero=False):
    """Subpixel offset of the (B, H, W) WTA index ``d`` along dim 2 of
    ``S``; ``c1`` is the minimum.  With ``big_guard``, no refinement
    against out-of-range (BIG-cost) neighbours unless ``edge_subpix``;
    ``plateau_zero`` gives no refinement where the fit's denominator is
    not above 1e-9."""
    D = S.shape[2]
    dev = S.device
    inf = torch.tensor(float('inf'), dtype=torch.float32, device=dev)

    def at(idx):
        return torch.gather(S, 2, idx.clamp(0, D - 1).unsqueeze(2)).squeeze(2)

    c0 = torch.where(d > 0, at(d - 1), inf)
    c2 = torch.where(d < D - 1, at(d + 1), inf)
    guard = c1 + 1e6
    c0 = torch.where(torch.isfinite(c0), c0, guard)
    c2 = torch.where(torch.isfinite(c2), c2, guard)
    interior = (d > 0) & (d < D - 1)
    if big_guard is not None and not edge_subpix:
        interior = interior & (c0 < big_guard) & (c2 < big_guard)
    eps = torch.tensor(1e-9, dtype=torch.float32, device=dev)
    if subpix == 'vfit':
        den = 2.0 * (torch.maximum(c0, c2) - c1)
        off = ((c0 - c2) / torch.maximum(den, eps)).clamp(-0.5, 0.5)
    elif subpix == 'parabola':
        den = c0 - 2.0 * c1 + c2
        off = (0.5 * (c0 - c2) / torch.maximum(den, eps)).clamp(-0.5, 0.5)
    else:
        return torch.zeros_like(c1)
    if plateau_zero:
        off = torch.where(den > eps, off, 0.0)
    return torch.where(interior, off, 0.0)


def _sum_parts(parts):
    S = parts[0]
    for p in parts[1:]:
        S = S + p
    return S


def wta_plain(parts, subpix, big_guard, edge_subpix=False,
              plateau_zero=False):
    """Plain version of :func:`wta`."""
    S = _sum_parts(parts)
    mn, d = _argmin(S)
    off = _refine(S, d, mn, subpix, big_guard, edge_subpix, plateau_zero)
    off = torch.where(mn < big_guard, off, float('nan'))
    return off, d.to(torch.int32)


def wta(parts, subpix, big_guard, edge_subpix=False, plateau_zero=False):
    """Winner-take-all over the summed partials.

    Args:
        parts: one or two (B, H, D, W) float32 volumes, any strides,
            summed in order.
        subpix: 'vfit', 'parabola' or anything else for no refinement.
        big_guard: costs at or above it count as out of range: no
            refinement against such a neighbour (unless ``edge_subpix``),
            and NaN where the minimum itself is one.
        edge_subpix: refine next to out-of-range neighbours too.
        plateau_zero: no refinement where the fit's denominator is not
            above 1e-9 (instead of the clipped quotient).
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
        return wta_plain(parts, subpix, big_guard, edge_subpix, plateau_zero)
    B, H, D, W = parts[0].shape
    dev = parts[0].device
    off = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    d_int = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    p1 = parts[-1]
    _launch('wta', 's2p_wta', parts[0].data_ptr(), *parts[0].stride(),
            p1.data_ptr(), *p1.stride(), len(parts), off.data_ptr(),
            d_int.data_ptr(), B, H, D, W, _SUBPIX.get(subpix, 0),
            int(bool(edge_subpix)), int(bool(plateau_zero)),
            float(big_guard),
            key='wta_edge' if edge_subpix or plateau_zero else 'wta')
    return off, d_int


# --------------------------------------------------------------------- #
# K5: winner-take-all with the right-reference disparity
# --------------------------------------------------------------------- #

def wta_dr_plain(parts, disp_min, subpix):
    """Plain version of :func:`wta_dr`."""
    S = _sum_parts(parts)
    B, H, D, W = S.shape
    dev = S.device
    dmf = torch.tensor(float(disp_min), dtype=torch.float32, device=dev)
    mn, d = _argmin(S)
    disp = (dmf + d.to(torch.float32)) + _refine(S, d, mn, subpix)
    # S_R[k, x] = S[k, x - disp_min - k], inf outside [0, W)
    xs = (torch.arange(W, device=dev)[None, :] - disp_min
          - torch.arange(D, device=dev)[:, None])            # (D, W)
    S_R = torch.gather(S, 3, xs.clamp(0, W - 1).expand(B, H, D, W))
    S_R = torch.where(((xs >= 0) & (xs < W))[None, None], S_R, float('inf'))
    mnr, kR = _argmin(S_R)
    dR = -((dmf + kR.to(torch.float32)) + _refine(S_R, kR, mnr, subpix))
    return disp, d.to(torch.int32), dR


def wta_dr(parts, disp_min, subpix):
    """Winner-take-all over the summed partials, with the disparity
    composed in the kernel and the right-reference disparity.

    Args:
        parts: one or two (B, H, D, W) float32 volumes, any strides,
            summed in order.
        disp_min: the disparity of candidate 0.
        subpix: 'vfit', 'parabola' or anything else for no refinement.
    Returns:
        (disp (B, H, W) float32 = (disp_min + d) + offset, d (B, H, W)
        int32, dR (B, H, W) float32 = -((disp_min + kR) + offset_R), the
        WTA of S_R[k, x] = S[k, x - disp_min - k])."""
    if not 1 <= len(parts) <= 2:
        raise ValueError('wta_dr sums one or two partial volumes')
    for i, p in enumerate(parts):
        _check(p, f'parts[{i}]', torch.float32, 4, contiguous=False)
        if p.shape != parts[0].shape:
            raise ValueError('partials must share one shape')
    if _route(*parts) == 'cpu':
        return wta_dr_plain(parts, disp_min, subpix)
    B, H, D, W = parts[0].shape
    dev = parts[0].device
    disp = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    d_int = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    dR = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    p1 = parts[-1]
    _launch('wta', 's2p_wta_dr', parts[0].data_ptr(), *parts[0].stride(),
            p1.data_ptr(), *p1.stride(), len(parts), disp.data_ptr(),
            d_int.data_ptr(), dR.data_ptr(), B, H, D, W, int(disp_min),
            _SUBPIX.get(subpix, 0), key='wta_dr')
    return disp, d_int, dR


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


def flow_sigs(im1, im2, win, h1=None, w1=None, w2=None):
    """Bit-annotated census signatures of the single-tile flow: (s1, s2)
    int32 (B, H, W) from (B, H, W) images of equal shape.

    ``_VALID_BIT`` is set on every reference pixel and on the secondary's
    columns below ``w2`` (beyond it a candidate costs BIG); ``_PAD_BIT``
    marks the reference beyond ``(h1, w1)`` (zero cost, the scan carry
    stays fresh).  The extents are static ints, None for the full shape."""
    from .mgm_flow import census_bits_raw

    s1 = census_bits_raw(im1, win)[..., 0]
    s2 = census_bits_raw(im2, win)[..., 0]
    B, H, W = s1.shape
    xs = torch.arange(W, device=s1.device)
    ys = torch.arange(H, device=s1.device)
    v2 = (xs < (W if w2 is None else w2)).to(torch.int32)
    s2 = s2 | (v2 << _VALID_BIT)[None, None, :]
    s1 = s1 | (1 << _VALID_BIT)
    if h1 is not None or w1 is not None:
        pad = ((ys[:, None] >= (H if h1 is None else h1))
               | (xs[None, :] >= (W if w1 is None else w1)))
        s1 = s1 | (pad.to(torch.int32) << _PAD_BIT)[None]
    return s1, s2


def prepass_secondary(s2, W, disp_min, D):
    """The pre-pass's secondary: (s2t (B, N2, H), pad, sec_len) from the
    (B, H, W2) signatures of a reference W wide.  The batch's rebased,
    wider secondary at base 0 goes as it is; the single tile's, as wide as
    the reference, is padded by ``pad`` rows on each side of its scan
    axis, ``pad`` covering the signed range with ``disp_min + pad`` a
    multiple of 8 (the TPU kernel's aligned layout)."""
    s2t = s2.transpose(1, 2).contiguous()                    # (B, W2, H)
    if s2.shape[2] > W:
        if disp_min != 0:
            raise ValueError('the rebased secondary is at base 0')
        return s2t, 0, s2.shape[2]
    if s2.shape[2] < W:
        raise ValueError('the secondary is narrower than the reference')
    pad = max(0, -disp_min, disp_min + D)
    pad += (-(disp_min + pad)) % 8
    return torch.nn.functional.pad(s2t, (0, 0, pad, pad)), pad, W


def flow_chains(variant):
    """The flow's scan passes as its chains of dependent launches, one per
    orientation: {'h' or 'v': [(key, direction indices, lateral offsets,
    sub_cost_mult)]} in launch order.  A later pass of an orientation
    accumulates into the earlier one; the overcount fix goes to the first
    pass of :func:`scan_passes` and to no other.  The chains share no
    sum and no carry, so they may run at once."""
    passes = scan_passes(variant)
    n_dirs = sum(len(idx) for _, idx, _ in passes)
    sub = float(n_dirs - 1) if variant.overcount_fix else 0.0
    chains = {}
    for j, (key, idx, lats) in enumerate(passes):
        chains.setdefault(key[0], []).append(
            (key, idx, lats, sub if j == 0 else 0.0))
    return chains


_streams = {}


def _side_streams(dev, n):
    """``n`` side streams of a CUDA device, made once and reused."""
    got = _streams.setdefault(dev.index, [])
    while len(got) < n:
        got.append(torch.cuda.Stream(dev))
    return got[:n]


def flow_volumes(s1, s2, D, variant, allowed=None, disp_min=0):
    """One side's inputs to the scans, {orientation: (uint8 cost, p2)}:
    'h' (B, W, D, H) and (B, W, H), 'v' (B, H, D, W) and (B, H, W), for
    the orientations that :func:`flow_chains` scans.

    ``s1`` (B, H, W) are the bit-annotated reference signatures.  ``s2`` is
    either the rebased secondary of the batch, (B, H, W + margin) at base
    ``disp_min`` 0, or the single tile's, (B, H, W) at a signed
    ``disp_min``, read through a transposed copy padded by ``pad`` rows
    on each side (``disp_min + pad`` a multiple of 8, as the TPU kernel
    lays it out).  The uint8 cost volume is built once in the (W, D, H)
    layout; the vertical passes read a transposed copy, so that every
    scan load coalesces along its lanes."""
    B, H, W = s1.shape
    s1t = s1.transpose(1, 2).contiguous()                    # (B, W, H)
    s2t, pad, sec_len = prepass_secondary(s2, W, disp_min, D)
    cost_h = cost_prepass(s1t, s2t, D, disp_min, variant.census_win ** 2 - 1,
                          pad, sec_len, allowed=allowed)     # (B, W, D, H)
    vols = {}
    for o in flow_chains(variant):
        cost = cost_h if o == 'h' else cost_h.permute(0, 3, 2, 1).contiguous()
        vols[o] = (cost, torch.full(cost[:, :, 0].shape, variant.p2,
                                    dtype=torch.float32, device=s1.device))
    return vols


def flow_scans(sides, variant):
    """The flow's scan passes over the volumes of :func:`flow_volumes`.

    ``sides`` yields ({orientation: (cost, p2)}, emit_votes) per side.
    Classic independent scans (tsgm=1), BIG out-of-range costs, the chains
    of :func:`flow_chains`.  On CUDA every chain (each side's horizontal
    and vertical passes) runs on a side stream of its own, forked from the
    caller's stream as soon as its side's volumes are enqueued, all at
    once; the caller's stream waits for them all before this returns.  On
    the CPU the passes run one after another.

    Returns, per side, ([S_v (B, H, D, W), S_h viewed as (B, H, D, W)],
    votes list of (B, H, W) int32 in direction order, None where not
    emitted)."""
    from .mgm_flow import BIG

    chains = flow_chains(variant)
    n_dirs = sum(len(c[1]) for chain in chains.values() for c in chain)
    keep, forked, out = [], [], []
    for vols, emit_votes in sides:
        # the caller's stream frees the volumes only after it has waited
        # for the chains that read them
        keep.append(vols)
        S, votes = {}, [None] * n_dirs
        for o, (cost, p2) in vols.items():
            ctx = contextlib.nullcontext()
            if cost.is_cuda:
                main = torch.cuda.current_stream(cost.device)
                st = _side_streams(cost.device, len(forked) + 1)[-1]
                st.wait_stream(main)
                forked.append(st)
                ctx = torch.cuda.stream(st)
            with ctx:
                for key, idx, lats, sub in chains[o]:
                    S[o], v = scan(cost, p2, lats, variant.p1, BIG,
                                   reverse=key[1] == 'b', sub_cost_mult=sub,
                                   accum=S.get(o), emit_votes=emit_votes)
                    for j, i in enumerate(idx if v is not None else ()):
                        votes[i] = (v[:, j] if o == 'v'
                                    else v[:, j].transpose(1, 2))
        parts = [S['v']] if 'v' in S else []
        if 'h' in S:
            parts.append(S['h'].permute(0, 3, 2, 1))
        out.append((parts, votes))
    for st in forked:
        main.wait_stream(st)
    # made on the side streams, used on the caller's: not to be reused
    # before the caller's stream is done with them
    for parts, votes in out if forked else ():
        for t in parts + [vo for vo in votes if vo is not None]:
            t.record_stream(main)
    return out


def flow_partials_sides(sides, D, variant, allowed=None):
    """Aggregation partials of one or both sides of the flow: ``sides``
    holds (s1, s2, disp_min, emit_votes) per side (:func:`flow_volumes`);
    returns :func:`flow_scans` of them, each side's volumes enqueued on
    the caller's stream while the chains of the sides before it run."""
    return flow_scans(((flow_volumes(s1, s2, D, variant, allowed, dm), ev)
                       for s1, s2, dm, ev in sides), variant)


def flow_partials_from_sigs(s1, s2, D, variant, allowed=None,
                            emit_votes=True, disp_min=0):
    """Aggregation partials of one side of the flow: ([S_v, S_h viewed as
    (B, H, D, W)], votes) of :func:`flow_partials_sides`."""
    return flow_partials_sides([(s1, s2, disp_min, emit_votes)], D,
                               variant, allowed)[0]


def flow_one_side(im1, im2, disp_min, D, variant, ext=None,
                  emit_votes=True):
    """One side of the single-tile flow on the kernels: (disp, d_int,
    votes) from (B, H, W) images of equal shape, ``disp = (disp_min +
    d_int) + offset``, NaN where no candidate is in range.  ``ext`` is
    None or the static true extents (h1, w1, w2, d_true) of a padded
    tile; the caller masks the padding."""
    from .mgm_flow import BIG

    h1 = w1 = w2 = None
    allowed = None
    if ext is not None:
        h1, w1, w2, d_true = ext
        if d_true != D:
            allowed = (torch.arange(D, device=im1.device) < d_true) \
                .to(torch.int32)[None].expand(im1.shape[0], D).contiguous()
    s1, s2 = flow_sigs(im1, im2, variant.census_win, h1, w1, w2)
    parts, votes = flow_partials_from_sigs(s1, s2, D, variant,
                                           allowed=allowed,
                                           emit_votes=emit_votes,
                                           disp_min=disp_min)
    off, d_int = wta(parts, variant.subpix, BIG / 2,
                     edge_subpix=variant.edge_subpix,
                     plateau_zero=variant.subpix_plateau == 'zero')
    disp = (torch.tensor(float(disp_min), dtype=torch.float32,
                         device=im1.device) + d_int.to(torch.float32)) + off
    return disp, d_int, votes


# --------------------------------------------------------------------- #
# the lane-folded batch: B tiles side by side on the lane axis
# --------------------------------------------------------------------- #

def fold_lanes_v(a):
    """(G, B, H, Wseg) -> (G, H, B * Wseg): each group's tiles side by
    side on the lane axis of the vertical passes."""
    G, B, H, Wseg = a.shape
    return a.transpose(1, 2).reshape(G, H, B * Wseg)


def unfold_lanes_v(a, B):
    """(G, H, B * Wseg) -> (G, B, H, Wseg)."""
    G, H, L = a.shape
    return a.reshape(G, H, B, L // B).transpose(1, 2)


def _fold_lanes_h(a):
    """(G, B, H, Wseg) -> (G, Wseg, B * H): the horizontal passes'
    transposed layout, the tiles side by side on their lane axis (y)."""
    G, B, H, Wseg = a.shape
    return a.permute(0, 3, 1, 2).reshape(G, Wseg, B * H)


def fold_inputs(s1_bt, s2_bt, D, p2):
    """The folded scans' inputs from (G, B, H, Wseg) signatures: per
    orientation ('v', 'h') the tuple (s1, s2, p2, sec_len, seg_w) that
    :func:`scan_sig` takes."""
    G, B, H, Wseg = s1_bt.shape
    dev = s1_bt.device
    # the candidates of the horizontal passes' last positions reach D
    # rows past Wseg
    s2h = torch.nn.functional.pad(_fold_lanes_h(s2_bt), (0, 0, 0, D))
    return {
        'v': (fold_lanes_v(s1_bt).contiguous(),
              fold_lanes_v(s2_bt).contiguous(),
              torch.full((G, H, B * Wseg), p2, dtype=torch.float32,
                         device=dev), B * Wseg, Wseg),
        'h': (_fold_lanes_h(s1_bt).contiguous(), s2h,
              torch.full((G, Wseg, B * H), p2, dtype=torch.float32,
                         device=dev), Wseg + D, H)}


def flow_partials_folded(s1_bt, s2_bt, D, variant, allowed_bt=None,
                         emit_votes=True):
    """Aggregation partials of one side for groups of lane-folded tiles.

    Args:
        s1_bt: (G, B, H, Wseg) bit-annotated reference signatures
            (``_PAD_BIT`` over each tile's padding, the segment margin
            ``[w1, Wseg)`` included).
        s2_bt: (G, B, H, Wseg) rebased secondary signatures at base 0.
        allowed_bt: optional (G, B, D) int32 per-tile candidate masks.
    Every pass is a signature-mode scan (K4a with ``seg_w``): vertical
    over (H, B * Wseg) lanes in segments of Wseg, horizontal over
    (Wseg, B * H) in segments of H with the secondary padded by D
    invalid rows.  Later passes of an orientation are plain adds.

    Returns ([S_v, S_h] as (G, H, D, B * Wseg) float32, votes list of
    (G, H, B * Wseg) int32 in direction order, None where not emitted),
    bitwise equal per segment to the single-tile passes."""
    from .mgm_flow import BIG

    G, B, H, Wseg = s1_bt.shape
    nbits = variant.census_win ** 2 - 1
    passes = scan_passes(variant)
    ins = fold_inputs(s1_bt, s2_bt, D, variant.p2)
    S = {'v': None, 'h': None}
    votes = [None] * sum(len(idx) for _, idx, _ in passes)
    sub = float(len(votes) - 1) if variant.overcount_fix else 0.0
    for key, dir_idx, lats in passes:
        o = key[0]
        a, b, p2, sec_len, seg_w = ins[o]
        Sp, v = scan_sig(a, b, p2, tuple((lat,) for lat in lats),
                         variant.p1, BIG, nbits, D, 0, sec_len,
                         reverse=key[1] == 'b', horizontal=o == 'h',
                         sub_cost_mult=sub, allowed=allowed_bt,
                         emit_votes=emit_votes, seg_w=seg_w)
        sub = 0.0                # exactly one pass applies the fix
        S[o] = Sp if S[o] is None else S[o] + Sp
        if v is None:
            continue
        for j, i in enumerate(dir_idx):
            votes[i] = v[:, j] if o == 'v' else (
                v[:, j].reshape(G, Wseg, B, H).permute(0, 3, 2, 1)
                .reshape(G, H, B * Wseg))
    parts = [S['v']] if S['v'] is not None else []
    if S['h'] is not None:
        # (G, Wseg, D, B * H) -> (G, H, D, B * Wseg)
        parts.append(S['h'].reshape(G, Wseg, D, B, H)
                     .permute(0, 4, 2, 3, 1).reshape(G, H, D, B * Wseg))
    return parts, votes


# --------------------------------------------------------------------- #
# the classic SGM census matcher (sgm_pallas.aggregate / match_pallas)
# --------------------------------------------------------------------- #

def _pack(sig, valid):
    """Census signatures with the validity at ``_VALID_BIT``."""
    return sig | (valid.to(torch.int32) << _VALID_BIT)


def _any_valid_candidate(val2, disp_min, D):
    """any_k val2[y, x + disp_min + k] via a windowed sum of the 0/1 mask."""
    H, W2 = val2.shape
    dev = val2.device
    cs = torch.cat([torch.zeros((H, 1), dtype=torch.int64, device=dev),
                    torch.cumsum(val2.to(torch.int64), dim=1)], dim=1)
    x = torch.arange(W2, device=dev)
    lo = (x + disp_min).clamp(0, W2)
    hi = (x + disp_min + D).clamp(0, W2)
    return (cs[:, hi] - cs[:, lo]) > 0


def sgm_scan_passes(params):
    """The classic matcher's scan passes in launch order: [(key,
    direction indices, laterals of each direction)], key 'hf', 'hb', 'vf'
    or 'vb' in the order the directions first name them.  Each direction
    has one lateral, or with ``params.mgm`` its MGM partners."""
    from .sgm import _DIRS_8

    dirs = _DIRS_8[:max(2, min(params.nb_dir, 8))]
    passes = {}
    for i, d in enumerate(dirs):
        key, (main, partner) = _PASS_OF_DIR[d]
        if not params.mgm:
            lats = (main,)
        elif params.mgm_neighbors >= 3:
            lats = (main, partner, -(main + partner))
        else:
            lats = (main, partner)
        passes.setdefault(key, ([], []))
        passes[key][0].append(i)
        passes[key][1].append(lats)
    return [(key, tuple(idx), tuple(lats))
            for key, (idx, lats) in passes.items()]


def aggregate_partials(im1, im2, disp_min, disp_max, params, p2map=None):
    """The scan passes of the classic matcher on one (H, W) pair of equal
    shape: returns (parts, valid1 (H, W) bool, votes list of (H, W) int32
    in direction order).  ``parts`` are (1, H, D, W) float32 volumes:
    ``S_v = vf + vb`` and ``S_h = hf + hb`` viewed in that layout, the
    sums taken outside the kernels; ``nb_dir = 2`` gives only ``S_h``.

    With ``params.mgm`` each direction averages its MGM lateral
    predecessors (K4b), otherwise it has one (K4a)."""
    from .census import census_transform

    if im1.shape != im2.shape:
        raise ValueError('the kernels need a pair of equal shape')
    H, W = im1.shape
    D = disp_max - disp_min + 1
    win = params.census_win
    nbits = win * win - 1
    if nbits > _VALID_BIT:
        raise NotImplementedError(f'census_win {win}: the kernels take '
                                  'windows up to 5x5 (wider windows take '
                                  'the lax route)')
    invalid_cost = float(nbits)

    sig1, val1 = census_transform(im1, win)
    sig2, val2 = census_transform(im2, win)
    s1 = _pack(sig1[..., 0], val1)[None]
    s2 = _pack(sig2[..., 0], val2)[None]
    if p2map is None:
        p2map = torch.full((H, W), params.p2, dtype=torch.float32,
                           device=im1.device)
    p2map = p2map.to(torch.float32)

    passes = sgm_scan_passes(params)
    # the horizontal passes scan the transposed pair along x; the TPU
    # kernel's sublane-aligned padding of the secondary is not needed
    t = {}
    if any(key[0] == 'h' for key, _, _ in passes):
        t = {'s1': s1.transpose(1, 2).contiguous(),
             's2': s2.transpose(1, 2).contiguous(),
             'p2': p2map.t().contiguous()[None]}
    S_v = S_h = None
    votes = [None] * sum(len(idx) for _, idx, _ in passes)
    for key, dir_idx, lats in passes:
        horizontal = key[0] == 'h'
        a, b, p2 = ((t['s1'], t['s2'], t['p2']) if horizontal
                    else (s1, s2, p2map[None].contiguous()))
        Sp, v = scan_sig(a, b, p2, lats, params.p1, invalid_cost, nbits, D,
                         disp_min, W, reverse=key[1] == 'b',
                         horizontal=horizontal)
        if horizontal:
            S_h = Sp if S_h is None else S_h + Sp
        else:
            S_v = Sp if S_v is None else S_v + Sp
        for j, i in enumerate(dir_idx):
            votes[i] = v[0, j].t() if horizontal else v[0, j]

    valid1 = val1 & _any_valid_candidate(val2, disp_min, D)
    parts = []
    if S_v is not None:
        parts.append(S_v)
    if S_h is not None:
        parts.append(S_h.permute(0, 3, 2, 1))        # (W,D,H) -> (H,D,W)
    return parts, valid1, votes


def aggregate(im1, im2, disp_min, disp_max, params, p2map=None):
    """Census cost + multi-direction SGM/MGM aggregation on the kernels.

    Counterpart of ``sgm_pallas.aggregate``: returns (S (H, W, D)
    float32, valid1 (H, W) bool, votes list of (H, W) int32 in direction
    order)."""
    parts, valid1, votes = aggregate_partials(im1, im2, disp_min, disp_max,
                                              params, p2map)
    S = _sum_parts(parts)[0].permute(0, 2, 1)
    return S, valid1, votes


def match_kernels(im1, im2, disp_min, disp_max, params, p2map=None):
    """Aggregation + fused WTA/subpixel/right-disparity on the kernels.

    Counterpart of ``sgm_pallas.match_pallas``: returns a dict with
    'disp_raw' (float32, disp_min + WTA + subpixel, no validity applied),
    'd_int' (int32 WTA index), 'dR' (float32 right-reference disparity
    for the LR test), 'valid1' (bool) and 'votes' (list of int32
    per-direction WTA maps)."""
    parts, valid1, votes = aggregate_partials(im1, im2, disp_min, disp_max,
                                              params, p2map)
    disp_raw, d_int, dR = wta_dr(parts, disp_min, params.subpix)
    return {'disp_raw': disp_raw[0], 'd_int': d_int[0], 'dR': dR[0],
            'valid1': valid1, 'votes': votes}
