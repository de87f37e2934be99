"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package's Pallas kernels in interpret mode, bitwise and NaN-aware.

The CUDA kernels themselves run only on a GPU: ``chip_smoke.py`` holds
each of them against the same plain versions there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2p_tpu.ops import sgm_pallas as sp
from s2p_tpu_torch.ops import sgm_kernels as sk

BIG = 1e9


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _sigs(rng, shape, p_valid=0.85, p_pad=0.0):
    s = rng.randint(0, 1 << 24, size=shape).astype(np.uint32)
    s |= (rng.rand(*shape) < p_valid).astype(np.uint32) << sp._VALID_BIT
    s |= (rng.rand(*shape) < p_pad).astype(np.uint32) << sp._PAD_BIT
    return s


def _t(a):
    """uint32 numpy -> int32 torch with a batch axis of 1."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))[None]


# (N, lanes, D, base: 'wide' (0, the rebased secondary, the last window
# ends at its last row) or the signed disp_min of a padded secondary)
_PREPASS_SHAPES = {
    'wide_lanes61_d17': (48, 61, 17, 'wide'),
    'wide_lanes36_d1': (16, 36, 1, 'wide'),
    'narrow_neg_d1': (24, 40, 1, -3),
    'narrow_neg_lanes61_d17_allowed_pad': (32, 61, 17, -9),
    'narrow_neg_allowed_zeros_pad': (48, 40, 16, -5),
}


@pytest.mark.parametrize('case', ['wide_allowed_pad', 'wide', 'narrow_neg',
                                  'narrow_pos_allowed'] + list(_PREPASS_SHAPES))
def test_cost_prepass_matches_pallas(case):
    """K1's plain version, also at the new kernel's edges: lane counts
    that no 4- or 16-lane vector divides, D 1 and 17, a signed base with
    reference padding and candidates that ``allowed`` leaves out (every
    one, in some tiles' rows), and a window that reaches the secondary's
    last row."""
    rng = np.random.RandomState(hash(case) % 2 ** 31)
    N, L, D, base = _PREPASS_SHAPES.get(case, (48, 40, 16, None))
    if base is None:
        base = 'wide' if case.startswith('wide') else (
            -5 if case == 'narrow_neg' else 3)
    nbits = 24
    s1t = _sigs(rng, (N, L), p_pad=0.2 if 'pad' in case else 0.0)
    if 'pad' in case and case in _PREPASS_SHAPES:
        s1t[:8] |= np.uint32(1 << sp._PAD_BIT)          # all-pad rows
        s1t[8:11] &= ~np.uint32(1 << sp._VALID_BIT)     # all-invalid rows
    allowed = None
    if 'allowed' in case:
        allowed = (np.arange(D) < 11).astype(np.int32)
        if 'zeros' in case:
            allowed = np.zeros(D, np.int32)
            allowed[[1, 4, 5, 9]] = 1
    if base == 'wide':
        dmin, pad, sec_len = 0, 0, N + D
        s2tp = _sigs(rng, (N + D, L))
    else:
        dmin = base
        G = 8
        pad = max(0, -dmin, dmin + D)
        pad += (-(dmin + pad)) % G
        sec_len = N
        s2tp = np.pad(_sigs(rng, (N, L)), ((pad, pad), (0, 0)))
    ref = sp._cost_prepass(
        jnp.asarray(s1t), jnp.asarray(s2tp), D, dmin, nbits, pad, sec_len,
        allowed=None if allowed is None else jnp.asarray(allowed).reshape(D, 1),
        interpret=True)
    out = sk.cost_prepass(
        _t(s1t), _t(s2tp), D, dmin, nbits, pad, sec_len,
        allowed=None if allowed is None else torch.from_numpy(allowed)[None])
    _same(out[0].numpy(), ref)
    assert (np.asarray(ref) == 255).any() and (np.asarray(ref) < 255).any()
    if 'pad' in case and case in _PREPASS_SHAPES:
        assert (np.asarray(ref)[:8] == 0).all()


# (pass, lateral offsets, reverse, overcount multiplier, accum, votes)
_SCAN_CASES = {
    'hf_sub_votes': ((0,), False, 7.0, False, True),
    'hb_accum_votes': ((0,), True, 0.0, True, True),
    'vf_3dirs_votes': ((0, 1, -1), False, 0.0, False, True),
    'vb_3dirs_accum': ((0, -1, 1), True, 0.0, True, False),
    'vf_3dirs_sub_accum': ((0, 1, -1), False, 7.0, True, False),
    'hb_plain': ((0,), True, 0.0, False, False),
}


@pytest.mark.parametrize('case', sorted(_SCAN_CASES))
def test_scan_pass_matches_pallas(case):
    lats, reverse, sub, with_accum, votes = _SCAN_CASES[case]
    rng = np.random.RandomState(len(case) * 7 + int(reverse))
    N, D, W = 40, 16, 48
    cost = rng.randint(0, 25, size=(N, D, W)).astype(np.uint8)
    cost[rng.rand(N, D, W) < 0.15] = 255
    cost[:, -3:, rng.rand(W) < 0.3] = 255          # out-of-range tails
    p2 = rng.choice([16.0, 32.0, 48.0], size=(N, W)).astype(np.float32)
    accum = (rng.randint(0, 3000, size=(N, D, W)).astype(np.float32)
             if with_accum else None)
    S_ref, v_ref = sp._scan_pass_pallas(
        None, None, jnp.asarray(p2), D, 0, [(lat,) for lat in lats], 8.0,
        BIG, 24, reverse, False, interpret=True, sub_cost_mult=sub,
        emit_votes=votes,
        accum=None if accum is None else jnp.asarray(accum),
        cost=jnp.asarray(cost))
    S, v = sk.scan(torch.from_numpy(cost)[None], torch.from_numpy(p2)[None],
                   lats, 8.0, BIG, reverse, sub_cost_mult=sub,
                   accum=None if accum is None else torch.from_numpy(accum)[None],
                   emit_votes=votes)
    _same(S[0].numpy(), S_ref)
    assert (v is None) == (v_ref is None)
    if votes:
        _same(v[0].numpy(), v_ref)


def test_scan_reads_strided_cost():
    """The vertical passes read the (W, D, H) pre-pass volume in place:
    a permuted view gives the result of its contiguous copy."""
    rng = np.random.RandomState(3)
    cost_h = torch.from_numpy(rng.randint(0, 25, size=(2, 24, 16, 32))
                              .astype(np.uint8))
    view = cost_h.permute(0, 3, 2, 1)
    p2 = torch.full((2, 32, 24), 32.0)
    a = sk.scan(view, p2, (0, 1, -1), 8.0, BIG, False)
    b = sk.scan(view.contiguous(), p2, (0, 1, -1), 8.0, BIG, False)
    _same(a[0].numpy(), b[0].numpy())
    _same(a[1].numpy(), b[1].numpy())


@pytest.mark.parametrize('subpix,n_parts', [('vfit', 2), ('vfit', 1),
                                            ('parabola', 2)])
def test_wta_matches_pallas(subpix, n_parts):
    rng = np.random.RandomState(11 + n_parts)
    H, D, W = 24, 16, 40
    S = (rng.randint(0, 60, size=(H, D, W)) * 10).astype(np.float32)  # ties
    oor = rng.rand(H, D, W) < 0.1
    S[oor] = np.float32(8e9) + S[oor]
    S[:, :, :5] = np.float32(8e9) + S[:, :, :5]       # every candidate BIG
    S[3, :2, 7] = np.float32(2e9)                     # BIG-side neighbours
    parts = [S] if n_parts == 1 else [S - 200.0, np.full_like(S, 200.0)]
    off_ref, d_ref, _ = sp._wta_pallas(
        [jnp.asarray(p) for p in parts], 0, subpix, interpret=True,
        big_guard=BIG / 2, with_dr=False, emit_offset=True)
    off, d = sk.wta([torch.from_numpy(p)[None] for p in parts], subpix,
                    BIG / 2)
    _same(off[0].numpy(), off_ref)
    _same(d[0].numpy(), d_ref)
    assert np.isnan(np.asarray(off_ref)[:, :5]).all()
    assert (np.asarray(off_ref) != 0).any()


def test_wrappers_reject_bad_inputs():
    s = torch.zeros((1, 8, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        sk.cost_prepass(s.float(), s, 4, 0, 24, 0, 8)
    with pytest.raises(ValueError):
        sk.cost_prepass(s, s[:, :, :2].contiguous(), 4, 0, 24, 0, 8)
    cost = torch.zeros((1, 8, 4, 6), dtype=torch.uint8)
    with pytest.raises(ValueError):
        sk.scan(cost, torch.zeros((1, 8, 5)), (0,), 8.0, BIG, False)
    with pytest.raises(ValueError):
        sk.scan(cost, torch.zeros((1, 8, 6)), (0, 1, -1, 2), 8.0, BIG, False)
    with pytest.raises(ValueError):
        sk.wta([torch.zeros((1, 2, 3, 4))] * 3, 'vfit', BIG / 2)


def test_scan_passes_follow_the_pallas_flow():
    """Launch order and laterals of the flow's passes: hf, hb, vf, vb."""
    from s2p_tpu_torch.ops.mgm_flow import MgmVariant
    passes = sk.scan_passes(MgmVariant())
    assert passes == [('hf', (0,), (0,)), ('hb', (1,), (0,)),
                      ('vf', (2, 4, 7), (0, 1, -1)),
                      ('vb', (3, 5, 6), (0, -1, 1))]
    assert [p[0] for p in sk.scan_passes(MgmVariant(nb_dir=2))] == ['hf',
                                                                    'hb']


# ------------------------------------------------------------------ #
# K4: the scan pass in signature mode, K5: the WTA with dR
# ------------------------------------------------------------------ #

def _h_pad(dmin, D, G=8):
    """The horizontal secondary's padding of ``sgm_pallas``."""
    pad = max(0, -dmin, dmin + D)
    return pad + (-(dmin + pad)) % G


# (horizontal, reverse, disp_min, allowed, sub, accum, wide, laterals)
_SIG_CASES = {
    'v_fwd_neg': (False, False, -8, False, 0.0, False, False,
                  ((0,), (1,), (-1,))),
    'v_rev_pos_allowed_sub': (False, True, 3, True, 7.0, False, False,
                              ((0,), (-1,), (1,))),
    'v_wide_accum_pad': (False, False, 0, False, 0.0, True, True,
                         ((0,), (1,), (-1,))),
    'h_fwd_neg': (True, False, -8, False, 0.0, False, False, ((0,),)),
    'h_rev_pos_allowed_sub_accum': (True, True, 3, True, 7.0, True, False,
                                    ((0,),)),
    'h_wide_pad': (True, False, 0, False, 0.0, False, True, ((0,),)),
}


def _sig_inputs(case, N, W, D, wide, horizontal, dmin, rng):
    """Reference signatures (N, W), the secondary in the layout each
    implementation reads, and its padding and range: (s1, s2_jax,
    s2_port, pad, sec_len, sec_len_jax)."""
    s1 = _sigs(rng, (N, W), p_pad=0.1 if 'pad' in case else 0.0)
    if not horizontal:
        s2 = _sigs(rng, (N, W + D if wide else W))
        return s1, s2, s2, 0, s2.shape[1], None
    if wide:
        s2 = _sigs(rng, (N + D, W))
        return s1, s2, s2, 0, N + D, N + D
    pad = _h_pad(dmin, D)
    s2 = np.pad(_sigs(rng, (N, W)), ((pad, pad), (0, 0)))
    return s1, s2, s2, pad, N, None


@pytest.mark.parametrize('case', sorted(_SIG_CASES))
def test_scan_sig_matches_pallas(case):
    horizontal, reverse, dmin, with_allowed, sub, with_accum, wide, dirs = \
        _SIG_CASES[case]
    rng = np.random.RandomState(len(case) * 13 + int(reverse))
    N, W, D = 32, 24, 16
    s1, s2j, s2p, pad, sec_len, sec_len_j = _sig_inputs(
        case, N, W, D, wide, horizontal, dmin, rng)
    p2 = rng.choice([16.0, 32.0, 48.0], size=(N, W)).astype(np.float32)
    allowed = (np.arange(D) < 11).astype(np.int32) if with_allowed else None
    accum = (rng.randint(0, 3000, size=(N, D, W)).astype(np.float32)
             if with_accum else None)
    inv = 24.0 if dmin else BIG
    S_ref, v_ref = sp._scan_pass_pallas(
        jnp.asarray(s1), jnp.asarray(s2j), jnp.asarray(p2), D, dmin,
        list(dirs), 8.0, inv, 24, reverse, horizontal, interpret=True,
        sub_cost_mult=sub, sec_len=sec_len_j,
        allowed=None if allowed is None else jnp.asarray(allowed)[:, None],
        accum=None if accum is None else jnp.asarray(accum))
    S, v = sk.scan_sig(
        _t(s1), _t(s2p), torch.from_numpy(p2)[None], dirs, 8.0, inv, 24, D,
        dmin, sec_len, reverse, horizontal, pad=pad, sub_cost_mult=sub,
        allowed=None if allowed is None else torch.from_numpy(allowed)[None],
        accum=None if accum is None else torch.from_numpy(accum)[None])
    _same(S[0].numpy(), S_ref)
    _same(v[0].numpy(), v_ref)
    assert (np.asarray(S_ref) >= inv).any()


# (horizontal, reverse, laterals of each direction): the MGM passes of
# sgm_pallas.aggregate with mgm_neighbors 2 and 3, and the new kernel's
# edges (lanes that the cluster's 16 blocks do not divide, 1 to 3
# directions, D 1, sub and accum together)
_MGM_CASES = {
    'v_2lat': (False, False, ((0, 1), (1, 0), (-1, 0))),
    'v_3lat_rev': (False, True, ((0, -1, 1), (-1, 0, 1), (1, 0, -1))),
    'h_2lat_rev': (True, True, ((0, -1),)),
    'h_3lat': (True, False, ((0, 1, -1),)),
    'v_1dir_3lat_d1_lanes30': (False, False, ((0, 1, -1),)),
    'v_2dirs_2lat_lanes61_sub_accum': (False, True, ((0, -1), (-1, 0))),
    'v_3dirs_3lat_lanes61_sub_accum': (False, False,
                                       ((0, 1, -1), (1, 0, -1), (-1, 0, 1))),
    'h_2lat_lanes30_sub_accum': (True, False, ((0, 1),)),
}


@pytest.mark.parametrize('case', sorted(_MGM_CASES))
def test_scan_mgm_matches_pallas(case):
    """K4b's plain version.  Two laterals are held bitwise.  With three,
    ``cost + c * f32(1/3)`` is one fused multiply-add in the JAX
    package's CPU run except at a few lanes of the first row of each
    8-row grid block, where XLA rounds twice; the port fuses everywhere,
    so three laterals are held to rtol 1e-6 (a few ulp) and equal
    votes."""
    horizontal, reverse, dirs = _MGM_CASES[case]
    rng = np.random.RandomState(len(case) * 5 + int(reverse))
    N, W, D, dmin = 24, 32, 16, -8
    if 'lanes30' in case:
        W = 30
    elif 'lanes61' in case:
        W = 61
    if 'd1' in case:
        D = 1
    s1, s2j, s2p, pad, sec_len, sec_len_j = _sig_inputs(
        case, N, W, D, False, horizontal, dmin, rng)
    p2 = np.full((N, W), 32.0, np.float32)
    sub, accum = 0.0, None
    if 'sub_accum' in case:
        sub = float(len(dirs) + 1)
        accum = rng.randint(0, 3000, size=(N, D, W)).astype(np.float32)
    S_ref, v_ref = sp._scan_pass_pallas(
        jnp.asarray(s1), jnp.asarray(s2j), jnp.asarray(p2), D, dmin,
        list(dirs), 8.0, 24.0, 24, reverse, horizontal, interpret=True,
        sub_cost_mult=sub,
        accum=None if accum is None else jnp.asarray(accum))
    S, v = sk.scan_sig(_t(s1), _t(s2p), torch.from_numpy(p2)[None], dirs,
                       8.0, 24.0, 24, D, dmin, sec_len, reverse, horizontal,
                       pad=pad, sub_cost_mult=sub,
                       accum=None if accum is None
                       else torch.from_numpy(accum)[None])
    _same(v[0].numpy(), v_ref)
    if len(dirs[0]) == 2:
        _same(S[0].numpy(), S_ref)
    else:
        np.testing.assert_allclose(S[0].numpy(), np.asarray(S_ref),
                                   rtol=1e-6, atol=0)
    if D > 1:
        assert not np.array_equal(np.asarray(S_ref), np.round(S_ref))


def test_fma32_is_one_rounding():
    """The plain versions' fused multiply-add rounds once: it equals the
    float64 evaluation (exact here: the inputs make the float64 sum
    exact) and differs from two roundings somewhere."""
    rng = np.random.RandomState(4)
    a = (rng.rand(20000) * 300).astype(np.float32)
    c = (rng.rand(20000) * 100).astype(np.float32)
    third = np.float32(1 / 3)
    got = sk._fma32(torch.from_numpy(a), 1 / 3, torch.from_numpy(c)).numpy()
    exact = (c.astype(np.float64) + a.astype(np.float64) * float(third))
    _same(got, exact.astype(np.float32))
    assert (got != c + a * third).any()


# (subpix, parts, disp_min, W): W 40 takes K5's 4-row band, 600 its
# 2-row band and 1100 the windowed instantiation; |disp_min| past W puts
# every column of S_R off the image
_WTA_DR_CASES = [pytest.param(s, n, d, 40, id=f'{s}-{n}-{d}') for s, n, d in (
    ('vfit', 2, -8), ('vfit', 1, 3), ('parabola', 2, 3), ('parabola', 1, -8),
    ('none', 2, -8))] + [
    pytest.param(s, n, d, W, id=f'{s}-{n}-{d}-W{W}') for s, n, d, W in (
        ('vfit', 2, -300, 600), ('parabola', 1, 605, 600),
        ('vfit', 2, -8, 1100), ('vfit', 1, -1116, 1100),
        ('none', 2, 1103, 1100), ('parabola', 2, 530, 1100))]


@pytest.mark.parametrize('subpix,n_parts,dmin,W', _WTA_DR_CASES)
def test_wta_dr_matches_pallas(subpix, n_parts, dmin, W):
    rng = np.random.RandomState((17 + n_parts + dmin) % 2**31)
    H, D = (16, 16) if W == 40 else (8, 16)
    S = (rng.randint(0, 60, size=(H, D, W)) * 10).astype(np.float32)  # ties
    S[2, :, 9] = S[2, 0, 9]                           # a flat column
    S += rng.randint(0, 3, size=(H, D, W)).astype(np.float32) * 0.25
    parts = [S] if n_parts == 1 else [S - 200.0, np.full_like(S, 200.0)]
    disp_ref, d_ref, dR_ref = sp._wta_pallas(
        [jnp.asarray(p) for p in parts], dmin, subpix, interpret=True)
    disp, d, dR = sk.wta_dr([torch.from_numpy(p)[None] for p in parts],
                            dmin, subpix)
    _same(disp[0].numpy(), disp_ref)
    _same(d[0].numpy(), d_ref)
    _same(dR[0].numpy(), dR_ref)
    if dmin > 0:
        # columns x < dmin see no S_R candidate: kR = 0, dR = -dmin
        assert (np.asarray(dR_ref)[:, :dmin] == -dmin).all()
    if dmin < -(W + D - 2) or dmin >= W:
        assert (np.asarray(dR_ref) == -dmin).all()
    if subpix != 'none':
        assert (np.asarray(disp_ref) % 1 != 0).any()


# (D, kind, parts, subpix, W, disp_min): every combination at W 24 and
# disp_min -3, then K5's wider instantiations with S_R off the image
_WTA_DR_NONFINITE = [
    pytest.param(D, k, n, s, 24, -3, id=f'{D}-{k}-{n}-{s}')
    for D in (1, 2, 17) for k in ('nan', 'inf', 'all_big') for n in (1, 2)
    for s in ('vfit', 'none')] + [
    pytest.param(D, k, n, s, W, dmin, id=f'{D}-{k}-{n}-{s}-W{W}-{dmin}')
    for D, k, n, s, W, dmin in (
        (17, 'nan', 2, 'vfit', 600, -610), (2, 'inf', 1, 'vfit', 600, 300),
        (17, 'all_big', 2, 'none', 1100, -550),
        (17, 'nan', 1, 'vfit', 1100, 1099),
        (1, 'inf', 2, 'vfit', 1100, -1200))]


@pytest.mark.parametrize('D,kind,n_parts,subpix,W,dmin', _WTA_DR_NONFINITE)
def test_wta_dr_nonfinite_matches_pallas(D, kind, n_parts, subpix, W, dmin):
    """K5's plain version on non-finite partials, the target that the
    kernel's NaN rule is held to on the card (chip_smoke.py): a NaN in
    S[.] (or S_R[.]) gives d = D and offset 0, +-inf minima give NaN
    fits, all-BIG columns a plateau."""
    rng = np.random.RandomState(D * 7 + n_parts + (W != 24) * abs(W + dmin))
    H = 8
    S = (rng.randint(0, 60, size=(H, D, W)) * 10).astype(np.float32)
    if kind == 'nan':
        S[rng.rand(H, D, W) < 0.05] = np.nan
        S[2, :, 5] = np.nan                          # a column of NaN
    elif kind == 'inf':
        S[rng.rand(H, D, W) < 0.1] = np.inf
        S[rng.rand(H, D, W) < 0.05] = -np.inf
    else:
        S[:, :, :7] = np.float32(BIG)
    parts = [S] if n_parts == 1 else [S - 200.0, np.full_like(S, 200.0)]
    disp_ref, d_ref, dR_ref = sp._wta_pallas(
        [jnp.asarray(p) for p in parts], dmin, subpix, interpret=True)
    disp, d, dR = sk.wta_dr([torch.from_numpy(p)[None] for p in parts],
                            dmin, subpix)
    _same(disp[0].numpy(), disp_ref)
    _same(d[0].numpy(), d_ref)
    _same(dR[0].numpy(), dR_ref)
    if kind == 'nan':
        assert (np.asarray(d_ref) == D).any()


def test_scan_mgm_rejects_far_laterals():
    """K4b's laterals are -1, 0 or +1 (a lane needs only its two
    neighbours); the wrapper refuses any other on every device."""
    s = torch.zeros((1, 8, 6), dtype=torch.int32)
    p2 = torch.zeros((1, 8, 6))
    with pytest.raises(ValueError):
        sk.scan_sig(s, s, p2, ((0, 2),), 8.0, 24.0, 24, 4, 0, 6, False,
                    False)
    with pytest.raises(ValueError):
        sk.scan_sig(s, s, p2, ((0, 1),), 8.0, 24.0, 24, 4, 0, 6, False,
                    False, mgm_variant='smem')


def test_wta_dr_reads_strided_parts():
    """The horizontal partial is read in its (W, D, H) layout."""
    rng = np.random.RandomState(8)
    a = torch.from_numpy(rng.rand(2, 8, 16, 24).astype(np.float32))
    h = torch.from_numpy(rng.rand(2, 24, 16, 8).astype(np.float32))
    view = h.permute(0, 3, 2, 1)
    for x, y in zip(sk.wta_dr([a, view], -3, 'vfit'),
                    sk.wta_dr([a, view.contiguous()], -3, 'vfit')):
        _same(x.numpy(), y.numpy())


def test_scan_sig_rejects_bad_inputs():
    s = torch.zeros((1, 8, 6), dtype=torch.int32)
    p2 = torch.zeros((1, 8, 6))
    with pytest.raises(ValueError):        # sec_len beyond the secondary
        sk.scan_sig(s, s, p2, ((0,),), 8.0, 24.0, 24, 4, 0, 7, False, False)
    with pytest.raises(ValueError):        # rows past the padded secondary
        sk.scan_sig(s, s, p2, ((0,),), 8.0, 24.0, 24, 4, 0, 8, False, True,
                    pad=2)
    with pytest.raises(ValueError):        # four laterals
        sk.scan_sig(s, s, p2, ((0, 1, -1, 2),), 8.0, 24.0, 24, 4, 0, 6,
                    False, False)
    with pytest.raises(TypeError):
        sk.scan_sig(s.float(), s, p2, ((0,),), 8.0, 24.0, 24, 4, 0, 6,
                    False, False)
    with pytest.raises(ValueError):
        sk.wta_dr([torch.zeros((1, 2, 3, 4))] * 3, 0, 'vfit')
