"""The port's batched mgm flow (device="cpu") against the JAX package,
bitwise and NaN-aware: the pieces one by one, then the whole batch entry
against both the Pallas route in interpret mode and the lax route."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2p_tpu.ops import mgm_flow as mf
from s2p_tpu.ops import sgm_pallas as sp
from s2p_tpu_torch import state
from s2p_tpu_torch.ops import mgm_flow as tf
from s2p_tpu_torch.ops import sgm_kernels as sk


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _pair(H, W, d, seed):
    rng = np.random.RandomState(seed)
    im2 = rng.rand(H, W).astype(np.float32) * 200
    im2 = (im2 + np.roll(im2, 1, 0) + np.roll(im2, 1, 1)) / 3
    xs = np.arange(W, dtype=np.float32)
    im1 = np.stack([np.interp(xs + d, xs, row) for row in im2])
    return im1.astype(np.float32), im2


def _bucket(Hp=64, Wp=96, n=3):
    """n tiles below the padded shape, NaN borders, different ranges."""
    b1 = np.full((n, Hp, Wp), np.nan, np.float32)
    b2 = np.full((n, Hp, Wp), np.nan, np.float32)
    hs, w1s, w2s = [], [], []
    for k in range(n):
        im1, im2 = _pair(Hp - 4 - 6 * k, Wp - 6 - 9 * k, 2.0 + k, seed=k)
        im1[:5] = np.nan
        im2[:, -7:] = np.nan
        im2 = im2[:, :im2.shape[1] - 2 * k]
        b1[k, :im1.shape[0], :im1.shape[1]] = im1
        b2[k, :im2.shape[0], :im2.shape[1]] = im2
        hs.append(im1.shape[0])
        w1s.append(im1.shape[1])
        w2s.append(im2.shape[1])
    return b1, b2, hs, w1s, w2s


def test_census_bits_raw_matches():
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 30, 41) * 100).astype(np.float32)
    img[0, 3:6, 7:9] = np.nan
    img[1, :, -2:] = np.nan
    for win in (5, 7):
        ours = tf.census_bits_raw(torch.from_numpy(img), win).numpy()
        for b in range(2):
            ref = np.asarray(mf.census_bits_raw(img[b], win))
            _same(ours[b].view(np.uint32), ref)


@pytest.mark.parametrize('shift', [-130, -40, -3, 0, 5, 37, 90])
def test_shift_sig_cols_matches(shift):
    rng = np.random.RandomState(abs(shift))
    sig = rng.randint(0, 1 << 24, size=(12, 50)).astype(np.uint32)
    ref = np.asarray(mf._shift_sig_cols(jnp.asarray(sig), shift, 44,
                                        extra=16))
    ours = tf._shift_sig_cols(torch.from_numpy(sig.view(np.int32)), shift,
                              44, extra=16).numpy()
    _same(ours.view(np.uint32), ref)


@pytest.mark.parametrize('kw', [{}, {'median_shape': 'cross'},
                                {'median_even': 'lower'},
                                {'median_fill': True}])
def test_median3x3_matches(kw):
    rng = np.random.RandomState(1)
    x = (rng.rand(2, 17, 23) * 10).astype(np.float32)
    x[rng.rand(*x.shape) < 0.3] = np.nan
    ours = tf._median3x3(torch.from_numpy(x), tf.MgmVariant(**kw)).numpy()
    for b in range(2):
        ref = mf._median3x3(jnp.asarray(x[b]), mf.MgmVariant(**kw))
        _same(ours[b], ref)


@pytest.mark.parametrize('k_lo', [-70, -8, -1, 3, 30])
def test_lr_kill_matches_windowed_form(k_lo):
    rng = np.random.RandomState(abs(k_lo) + 2)
    h, w, k_cnt = 9, 40, 18
    dL = (rng.rand(h, w) * 30 - 10).astype(np.float32)
    dR = (rng.rand(h, w) * 30 - 20).astype(np.float32)
    dL[rng.rand(h, w) < 0.2] = np.nan
    dR[rng.rand(h, w) < 0.2] = np.nan
    dR[:, :5] = -dL[:, :5]                       # some landings agree
    for nan_survives in (True, False):
        v_ref = mf.MgmVariant(lr_nan_survives=nan_survives)
        v = tf.MgmVariant(lr_nan_survives=nan_survives)
        ref = mf._lr_kill(jnp.asarray(dL), jnp.asarray(dR), v_ref, 35,
                          k_lo=k_lo, k_cnt=k_cnt)
        ours = tf._lr_kill(torch.from_numpy(dL)[None],
                           torch.from_numpy(dR)[None], v,
                           torch.tensor([35]), torch.tensor([k_lo]), k_cnt)
        _same(ours[0].numpy(), ref)


def test_flow_partials_match_pallas():
    """One side's partials and votes against sgm_pallas in interpret mode
    on rebased, bit-annotated signatures."""
    b1, b2, hs, w1s, w2s = _bucket(n=1)
    D = 16
    v = tf.MgmVariant()
    s1 = tf.census_bits_raw(torch.from_numpy(b1), 5)[..., 0]
    s2 = tf.census_bits_raw(torch.from_numpy(b2), 5)[..., 0]
    sr, ss, _ = tf._side_sigs(s1, s2, torch.tensor([-3]),
                              torch.tensor(hs), torch.tensor(w1s),
                              torch.tensor(w2s), D)
    allowed = (np.arange(D) < 13).astype(np.int32)
    parts, votes = sk.flow_partials_from_sigs(
        sr, ss, D, v, allowed=torch.from_numpy(allowed)[None])
    ref_parts, ref_votes = sp.flow_partials_from_sigs(
        jnp.asarray(sr[0].numpy().view(np.uint32)),
        jnp.asarray(ss[0].numpy().view(np.uint32)), 0, D,
        mf.MgmVariant(backend='interpret'), allowed=jnp.asarray(allowed),
        interpret=True)
    assert len(parts) == len(ref_parts) == 2
    for p, r in zip(parts, ref_parts):
        _same(p[0].numpy(), r)
    for o, r in zip(votes, ref_votes):
        _same(o[0].numpy(), r)


@pytest.mark.parametrize('backend', ['interpret', 'lax'])
def test_batch_matches_jax(backend):
    b1, b2, hs, w1s, w2s = _bucket()
    dmins, dts, Dp = [-2, -5, 1], [10, 16, 13], 16
    ref = mf.mgm_binary_match_batch(
        jnp.asarray(b1), jnp.asarray(b2), dmins, Dp, hs, w1s, w2s, dts,
        variant=mf.MgmVariant(backend=backend))
    ours = tf.mgm_binary_match_batch(b1, b2, dmins, Dp, hs, w1s, w2s, dts,
                                     tf.MgmVariant(), device='cpu')
    _same(ours['disp'].numpy(), ref['disp'])
    _same(ours['confidence'].numpy(), ref['confidence'])
    _same(ours['confidence_u8'].numpy(), ref['confidence_u8'])
    assert np.isfinite(ref['disp']).mean() > 0.5


@pytest.mark.parametrize('kw', [{'nb_dir': 4, 'lr_enabled': False},
                                {'median_order': 'after_lr', 'p1': 12.0,
                                 'p2': 48.0, 'subpix': 'parabola'},
                                {'nb_dir': 6}, {'nb_dir': 7}])
def test_batch_variants_match_lax(kw):
    b1, b2, hs, w1s, w2s = _bucket(n=2)
    dmins, dts, Dp = [-3, 0], [12, 16], 16
    ref = mf.mgm_binary_match_batch(
        jnp.asarray(b1), jnp.asarray(b2), dmins, Dp, hs, w1s, w2s, dts,
        variant=mf.MgmVariant(backend='lax', **kw))
    ours = tf.mgm_binary_match_batch(b1, b2, dmins, Dp, hs, w1s, w2s, dts,
                                     tf.MgmVariant(**kw), device='cpu')
    _same(ours['disp'].numpy(), ref['disp'])
    _same(ours['confidence'].numpy(), ref['confidence'])
    _same(ours['confidence_u8'].numpy(), ref['confidence_u8'])


@pytest.mark.parametrize('entry', ['single', 'batch'])
def test_census_17_on_the_16_bit_scan(entry):
    """A 17 x 17 census window: Hamming costs up to 288, so the lax
    route's scans take K2's 16-bit source (its plain version here); the
    single tile and the batch equal the JAX package's lax route."""
    assert tf._cost_dtype(17) == (torch.uint16, 65535)
    assert tf._cost_dtype(15) == (torch.uint8, 255)
    b1, b2, hs, w1s, w2s = _bucket(Hp=40, Wp=48, n=2)
    kw = dict(census_win=17)
    if entry == 'single':
        im1, im2 = b1[0, :hs[0], :w1s[0]], b2[0, :hs[0], :w2s[0]]
        ref = mf.mgm_binary_match(im1, im2, -2, 9,
                                  mf.MgmVariant(backend='lax', **kw))
        out = tf.mgm_binary_match(im1, im2, -2, 9, tf.MgmVariant(**kw),
                                  device='cpu')
        pairs = zip(out, ref)
    else:
        dmins, dts, Dp = [-2, -4], [10, 12], 16
        ref = mf.mgm_binary_match_batch(
            jnp.asarray(b1), jnp.asarray(b2), dmins, Dp, hs, w1s, w2s, dts,
            variant=mf.MgmVariant(backend='lax', **kw))
        out = tf.mgm_binary_match_batch(b1, b2, dmins, Dp, hs, w1s, w2s,
                                        dts, tf.MgmVariant(**kw),
                                        device='cpu')
        pairs = ((out[k], ref[k]) for k in ('disp', 'confidence'))
    for o, r in pairs:
        _same(o.numpy(), r)
    assert np.isfinite(np.asarray(ref[0] if entry == 'single'
                                  else ref['disp'])).mean() > 0.3


def test_variant_state_carries_across():
    jv = mf.MgmVariant(p1=10.0, nb_dir=4, lr_tau=2.0, backend='lax')
    ours = state.variant_from_state(dataclasses.asdict(jv))
    assert ours == tf.MgmVariant(p1=10.0, nb_dir=4, lr_tau=2.0)
    with pytest.raises(ValueError):
        state.variant_from_state({'no_such_knob': 1})


@pytest.mark.parametrize('kw', [dict(census_win=7), dict(tsgm=2)],
                         ids=['win7', 'tsgm2'])
def test_lax_batch_variants(kw):
    """A census window above 5x5 and ``tsgm=2``, which raised before they
    were ported, run each tile on the lax route and equal the JAX
    package's batch there."""
    b1, b2, hs, w1s, w2s = _bucket(Hp=40, Wp=48, n=2)
    dmins, dts, Dp = [-2, -4], [10, 12], 16
    ref = mf.mgm_binary_match_batch(
        jnp.asarray(b1), jnp.asarray(b2), dmins, Dp, hs, w1s, w2s, dts,
        variant=mf.MgmVariant(backend='lax', **kw))
    out = tf.mgm_binary_match_batch(b1, b2, dmins, Dp, hs, w1s, w2s, dts,
                                    tf.MgmVariant(**kw), device='cpu')
    assert np.isfinite(ref['disp']).mean() > 0.5
    for k in ('disp', 'confidence', 'confidence_u8'):
        _same(out[k].numpy(), ref[k])
