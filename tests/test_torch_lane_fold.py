"""The port's lane-folded batch (device="cpu") against the JAX package,
bitwise and NaN-aware: the fold layouts, the signature-mode scan with
segments (``seg_w``) against ``_scan_pass_pallas`` in interpret mode, one
side's folded partials against ``flow_partials_folded``, and the whole
batch entry with ``S2P_TPU_LANE_FOLD`` against the JAX package's folded
run and its lax batch."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2p_tpu.ops import mgm_flow as mf
from s2p_tpu.ops import sgm_pallas as sp
from s2p_tpu_torch.ops import mgm_flow as tf
from s2p_tpu_torch.ops import sgm_kernels as sk

BIG = 1e9


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _pair(H, W, d, seed=0):
    rng = np.random.RandomState(seed)
    im2 = rng.rand(H, W).astype(np.float32) * 200
    im2 = (im2 + np.roll(im2, 1, 0) + np.roll(im2, 1, 1)) / 3
    xs = np.arange(W, dtype=np.float32)
    im1 = np.stack([np.interp(xs + d, xs, row) for row in im2])
    return im1.astype(np.float32), im2


def _bucket():
    """The inputs of tests/test_mgm_flow.py's lane-fold test: 5 tiles
    padded to 72 x 104 with 32 candidates, mixed bases, extents and
    candidate counts."""
    Hp, Wp, Dp, n = 72, 104, 32, 5
    b1 = np.full((n, Hp, Wp), np.nan, np.float32)
    b2 = np.full((n, Hp, Wp), np.nan, np.float32)
    hs, w1s, w2s = [], [], []
    for k in range(n):
        im1, im2 = _pair(64 - 2 * k, 96 - 8 * k, 2.0 + k, seed=k)
        im1[:5] = np.nan
        im2[:, -7:] = np.nan
        b1[k, :im1.shape[0], :im1.shape[1]] = im1
        b2[k, :im2.shape[0], :im2.shape[1]] = im2
        hs.append(im1.shape[0])
        w1s.append(im1.shape[1])
        w2s.append(im2.shape[1])
    return b1, b2, [-2, -4, 0, -9, 3], Dp, hs, w1s, w2s, [10, 24, 32, 17, 8]


def _sigs(rng, shape, p_valid=0.85, p_pad=0.1):
    s = rng.randint(0, 1 << 24, size=shape).astype(np.uint32)
    s |= (rng.rand(*shape) < p_valid).astype(np.uint32) << sp._VALID_BIT
    s |= (rng.rand(*shape) < p_pad).astype(np.uint32) << sp._PAD_BIT
    return s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_fold_layouts_match():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 1000, size=(3, 5, 8)).astype(np.int32)
    ta = torch.from_numpy(a)[None]
    fv = sk.fold_lanes_v(ta)
    _same(fv[0].numpy(), sp.fold_lanes_v(jnp.asarray(a)))
    _same(sk.unfold_lanes_v(fv, 3)[0].numpy(), a)
    _same(sk._fold_lanes_h(ta)[0].numpy(), sp._fold_lanes_h(jnp.asarray(a)))


# (horizontal, reverse, laterals, overcount multiplier, votes)
_SEG_CASES = {
    'v_fwd_votes': (False, False, (0, 1, -1), 0.0, True),
    'v_rev_sub': (False, True, (0, -1, 1), 7.0, False),
    'h_fwd_sub_votes': (True, False, (0,), 7.0, True),
    'h_rev': (True, True, (0,), 0.0, True),
}


@pytest.mark.parametrize('case', sorted(_SEG_CASES))
def test_scan_sig_segments_match_pallas(case):
    """K4a in the lane-fold mode (plain version): 3 segments, per-segment
    candidate masks, the secondary reaching into the next segment
    (vertical) or past the scan axis into invalid rows (horizontal)."""
    horizontal, reverse, lats, sub, votes = _SEG_CASES[case]
    rng = np.random.RandomState(len(case))
    B, D = 3, 16
    if horizontal:
        seg, N = 24, 40                   # lanes = B * H, scan = Wseg
        s2 = np.pad(_sigs(rng, (N, B * seg), p_pad=0.0), ((0, D), (0, 0)))
        sec_len = N + D
    else:
        seg, N = 40, 24                   # lanes = B * Wseg, scan = H
        s2 = _sigs(rng, (N, B * seg), p_pad=0.0)
        sec_len = B * seg
    s1 = _sigs(rng, (N, B * seg))
    p2 = rng.choice([16.0, 32.0], size=(N, B * seg)).astype(np.float32)
    allowed = (np.arange(D)[None, :]
               < np.array([16, 11, 7])[:, None]).astype(np.int32)  # (B, D)
    al_j = np.broadcast_to(allowed.T[:, :, None], (D, B, seg)) \
        .reshape(D, B * seg)
    S_ref, v_ref = sp._scan_pass_pallas(
        jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(p2), D, 0,
        [(lat,) for lat in lats], 8.0, BIG, 24, reverse, horizontal,
        interpret=True, sub_cost_mult=sub, allowed=jnp.asarray(al_j),
        sec_len=sec_len, seg_w=seg, emit_votes=votes)
    S, v = sk.scan_sig(
        _t(s1)[None], _t(s2)[None], torch.from_numpy(p2)[None],
        tuple((lat,) for lat in lats), 8.0, BIG, 24, D, 0, sec_len, reverse,
        horizontal, sub_cost_mult=sub,
        allowed=torch.from_numpy(allowed)[None], emit_votes=votes,
        seg_w=seg)
    _same(S[0].numpy(), S_ref)
    assert (v is None) == (v_ref is None)
    if votes:
        _same(v[0].numpy(), v_ref)
    if any(lats):
        # the segments matter: without them the lateral carries cross
        S_one, _ = sk.scan_sig_plain(
            _t(s1)[None], _t(s2)[None], torch.from_numpy(p2)[None],
            tuple((lat,) for lat in lats), 8.0, BIG, 24, D, 0, sec_len,
            reverse, horizontal, sub_cost_mult=sub,
            allowed=torch.from_numpy(allowed)[None], emit_votes=False)
        assert not np.array_equal(S_one[0].numpy(), np.asarray(S_ref))


def test_flow_partials_folded_match_pallas():
    """One side of a folded group of 2 tiles: partials and votes."""
    b1, b2, dmins, D, hs, w1s, w2s, dts = _bucket()
    v = tf.MgmVariant()
    n, H, W = 2, b1.shape[1], b1.shape[2]
    fold, seg_w = tf.lane_fold_plan(W, D, n)
    assert seg_w == 136
    s1 = tf.census_bits_raw(torch.from_numpy(b1[:n]), 5)[..., 0]
    s2 = tf.census_bits_raw(torch.from_numpy(b2[:n]), 5)[..., 0]
    sr, ss, _ = tf._side_sigs(s1, s2, torch.tensor(dmins[:n]),
                              torch.tensor(hs[:n]), torch.tensor(w1s[:n]),
                              torch.tensor(w2s[:n]), extra=seg_w - W,
                              ref_pad=seg_w - W)
    allowed = (np.arange(D)[None, :]
               < np.array(dts[:n])[:, None]).astype(np.int32)
    parts, votes = sk.flow_partials_folded(
        sr[None], ss[None], D, v, allowed_bt=torch.from_numpy(allowed)[None])
    ref_parts, ref_votes = sp.flow_partials_folded(
        jnp.asarray(sr.numpy().view(np.uint32)),
        jnp.asarray(ss.numpy().view(np.uint32)), D,
        mf.MgmVariant(backend='interpret'), allowed_bt=jnp.asarray(allowed),
        interpret=True)
    assert len(parts) == len(ref_parts) == 2
    for p, r in zip(parts, ref_parts):
        _same(p[0].numpy(), r)
    for o, r in zip(votes, ref_votes):
        _same(o[0].numpy(), r)


@pytest.mark.parametrize('backend', ['interpret', 'lax'])
def test_lane_folded_batch_matches_jax(backend, monkeypatch):
    """5 tiles with fold 2: two folded groups and a 1-tile tail, against
    the JAX package's folded run (interpret) and its lax batch, per tile,
    disparity and confidence both."""
    b1, b2, dmins, D, hs, w1s, w2s, dts = _bucket()
    monkeypatch.setenv('S2P_TPU_LANE_FOLD', '2')
    assert tf.lane_fold_plan(b1.shape[2], D, 5) == (2, 136)
    ref = mf.mgm_binary_match_batch(
        jnp.asarray(b1), jnp.asarray(b2), dmins, D, hs, w1s, w2s, dts,
        variant=mf.MgmVariant(backend=backend))
    sk.reset_launch_counts()
    ours = tf.mgm_binary_match_batch(b1, b2, dmins, D, hs, w1s, w2s, dts,
                                     tf.MgmVariant(), device='cpu')
    for key in ('disp', 'confidence', 'confidence_u8'):
        for k in range(5):
            _same(ours[key][k].numpy(), np.asarray(ref[key])[k])
    assert sum(sk.launch_counts().values()) == 0      # CPU: no kernel


@pytest.mark.parametrize('fold', ['3', '8'])
def test_lane_folded_equals_unfolded(fold, monkeypatch):
    """Folding changes no bit: 5 tiles with fold 3 (one group and a
    2-tile tail) and fold 8 (capped at one group of 5), without the LR
    test and with 4 directions."""
    b1, b2, dmins, D, hs, w1s, w2s, dts = _bucket()
    v = tf.MgmVariant(nb_dir=4, lr_enabled=False)
    args = (b1, b2, dmins, D, hs, w1s, w2s, dts, v)
    monkeypatch.setenv('S2P_TPU_LANE_FOLD', fold)
    assert tf.lane_fold_plan(b1.shape[2], D, 5)[0] == min(int(fold), 5)
    folded = tf.mgm_binary_match_batch(*args, device='cpu')
    monkeypatch.delenv('S2P_TPU_LANE_FOLD')
    assert tf.lane_fold_plan(b1.shape[2], D, 5)[0] == 1
    plain = tf.mgm_binary_match_batch(*args, device='cpu')
    for key in ('disp', 'confidence'):
        _same(folded[key].numpy(), plain[key].numpy())


def test_scan_sig_segments_reject_bad_inputs():
    s = torch.zeros((1, 8, 12), dtype=torch.int32)
    p2 = torch.zeros((1, 8, 12))
    with pytest.raises(ValueError):          # segments do not tile lanes
        sk.scan_sig(s, s, p2, ((0,),), 8.0, BIG, 24, 4, 0, 12, False,
                    False, seg_w=5)
    with pytest.raises(ValueError):          # averaged laterals
        sk.scan_sig(s, s, p2, ((0, 1),), 8.0, BIG, 24, 4, 0, 12, False,
                    False, seg_w=6)
    with pytest.raises(ValueError):          # allowed is per segment
        sk.scan_sig(s, s, p2, ((0,),), 8.0, BIG, 24, 4, 0, 12, False,
                    False, seg_w=6,
                    allowed=torch.ones((1, 4), dtype=torch.int32))
