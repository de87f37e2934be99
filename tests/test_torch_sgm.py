"""The port's classic SGM census matcher (device="cpu") against the JAX
package's: ``sgm_match`` bitwise against its Pallas route in interpret
mode, the edge-aware penalty and ``match_pair`` (against the lax route)
at the tolerances the JAX package holds its own two routes to."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2p_tpu.ops import sgm as js
from s2p_tpu.ops import sgm_pallas as sp
from s2p_tpu_torch import state
from s2p_tpu_torch.ops import census as tc
from s2p_tpu_torch.ops import sgm as ts
from s2p_tpu_torch.ops import sgm_kernels as sk


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _pair(h=32, w=32, seed=0, shift=3):
    """Like tests/test_sgm_pallas.py: a shifted noisy copy, NaN borders."""
    rng = np.random.RandomState(seed)
    im1 = (rng.rand(h, w) * 255).astype(np.float32)
    im2 = np.roll(im1, -shift, axis=1) + rng.rand(h, w).astype(np.float32)
    im1[:2], im2[-3:] = np.nan, np.nan
    im1[:, :2], im2[:, -2:] = np.nan, np.nan
    return im1, im2


def _params(**kw):
    """(JAX params on the interpret route, the port's params)."""
    kw = dict(mgm=False, **kw)
    return js.SgmParams(backend='interpret', **kw), ts.SgmParams(**kw)


_CASES = {
    'nb8_vfit_volume': dict(nb_dir=8, subpix='vfit', lr_mode='volume'),
    'nb4_parabola_full': dict(nb_dir=4, subpix='parabola', lr_mode='full'),
    'nb2_none': dict(nb_dir=2, subpix='none'),
    'nb6': dict(nb_dir=6),
    'nb7': dict(nb_dir=7),
    'median_first_fill_lr_int_conf': dict(
        median_first=True, median_fill=True, fill_coh_tau=1.0, lr_int=True,
        min_confidence=0.5),
    'uniqueness_skipped': dict(uniqueness_ratio=10.0),
}


@pytest.mark.parametrize('case', sorted(_CASES))
def test_sgm_match_matches_pallas(case):
    im1, im2 = _pair(w=40, seed=len(case))
    jp, tp = _params(**_CASES[case])
    ref = js.sgm_match(jnp.asarray(im1), jnp.asarray(im2), -8, 7, jp)
    out = ts.sgm_match(im1, im2, -8, 7, tp, device='cpu')
    for k in ('disp', 'valid', 'confidence'):
        _same(out[k].numpy(), ref[k])
    d = np.asarray(ref['disp'])
    assert 0.3 < np.isfinite(d).mean() < 1.0
    if case == 'uniqueness_skipped':
        # the kernel route keeps no volume, so the ratio is not applied
        plain = ts.sgm_match(im1, im2, -8, 7, dataclasses.replace(
            tp, uniqueness_ratio=0.0), device='cpu')
        _same(out['disp'].numpy(), plain['disp'].numpy())


def test_edge_aware_p2_with_scale_map():
    """The edge threshold is mean + 2 std, whose reduction order may
    differ: held to the JAX package's own route-to-route tolerances
    (tests/test_sgm_pallas.py: disp atol 1e-3, equal NaN pattern,
    confidence atol 1e-6)."""
    im1, im2 = _pair(seed=3)
    rng = np.random.RandomState(9)
    scale = (0.5 + rng.rand(32, 32)).astype(np.float32)
    jp, tp = _params(p2_edge_scale=0.5)
    ref = js.sgm_match(jnp.asarray(im1), jnp.asarray(im2), -8, 7, jp,
                       p2_scale=jnp.asarray(scale))
    out = ts.sgm_match(im1, im2, -8, 7, tp, p2_scale=scale, device='cpu')
    d, dr = out['disp'].numpy(), np.asarray(ref['disp'])
    np.testing.assert_array_equal(np.isnan(d), np.isnan(dr))
    m = ~np.isnan(dr)
    np.testing.assert_allclose(d[m], dr[m], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out['confidence'].numpy(),
                               np.asarray(ref['confidence']), rtol=0,
                               atol=1e-6)


def test_edge_p2_map_matches():
    im1, _ = _pair(seed=5)
    ref = np.asarray(js._edge_p2_map(jnp.asarray(im1), 32.0, 0.5))
    got = ts._edge_p2_map(torch.from_numpy(im1), 32.0, 0.5).numpy()
    _same(got, ref)
    assert (ref == 16.0).any() and (ref == 32.0).any()


def test_match_pair_matches_lax():
    """70 x 90 padded to 128 x 128, the range to 16 candidates: against
    the JAX package's lax route, at its route-to-route tolerances."""
    rng = np.random.RandomState(2)
    im2 = (rng.rand(70, 96) * 200).astype(np.float32)
    im2 = (im2 + np.roll(im2, 1, 0) + np.roll(im2, 1, 1)) / 3
    im1 = np.roll(im2, 4, axis=1)[:, :90].copy()
    im2 = im2[:, :90].copy()
    im1[:3], im2[:, -4:] = np.nan, np.nan
    kw = dict(mgm=False, lr_mode='full')
    d_ref, v_ref, c_ref = js.match_pair(im1, im2, -9, 4,
                                        js.SgmParams(backend='lax', **kw))
    d, v, c = ts.match_pair(im1, im2, -9, 4, ts.SgmParams(**kw),
                            device='cpu')
    assert d.shape == (70, 90) and d.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(d), np.isnan(d_ref))
    np.testing.assert_array_equal(v, v_ref)
    m = ~np.isnan(d_ref)
    np.testing.assert_allclose(d[m], d_ref[m], rtol=0, atol=1e-3)
    np.testing.assert_allclose(c, c_ref, rtol=0, atol=1e-6)
    inner = d[8:-8, 8:-12]
    assert (np.abs(inner[np.isfinite(inner)] + 4) < 1).mean() > 0.9


def test_aggregate_mgm_matches_pallas():
    """A direct aggregate call with MGM laterals (mgm_neighbors 2: the
    averages are exact, so bitwise)."""
    im1, im2 = _pair(seed=6)
    kw = dict(mgm=True, mgm_neighbors=2, nb_dir=8)
    S_ref, val_ref, votes_ref = sp.aggregate(
        jnp.asarray(im1), jnp.asarray(im2), -8, 7,
        js.SgmParams(**kw), interpret=True)
    S, val, votes = sk.aggregate(torch.from_numpy(im1),
                                 torch.from_numpy(im2), -8, 7,
                                 ts.SgmParams(**kw))
    _same(S.numpy(), S_ref)
    _same(val.numpy(), val_ref)
    assert len(votes) == len(votes_ref) == 8
    for a, b in zip(votes, votes_ref):
        _same(a.numpy(), b)


def test_census_and_candidates_match():
    rng = np.random.RandomState(1)
    img = (rng.rand(21, 30) * 100).astype(np.float32)
    img[3:5, 7:9] = np.nan
    img[10, 12] = np.inf
    for win in (3, 5):
        sig_ref, val_ref = js.census_cost_volume.__globals__[
            'census_transform'](jnp.asarray(img), win)
        sig, val = tc.census_transform(torch.from_numpy(img), win)
        _same(sig.numpy().view(np.uint32), np.asarray(sig_ref))
        _same(val.numpy(), val_ref)
    for dmin, D in ((-8, 16), (5, 8), (-40, 8)):
        ref = sp._any_valid_candidate(jnp.asarray(val_ref), dmin, D)
        _same(sk._any_valid_candidate(val, dmin, D).numpy(), ref)


@pytest.mark.parametrize('w', [16, 31])
def test_median_helpers_match(w):
    rng = np.random.RandomState(w)
    x = rng.rand(12, w).astype(np.float32) * 10
    x[rng.rand(12, w) < 0.3] = np.nan
    valid = np.isfinite(x) & (rng.rand(12, w) < 0.9)
    t = torch.from_numpy(x)
    _same(ts._nan_median3(t).numpy(), js._nan_median3(jnp.asarray(x)))
    _same(ts._nan_spread3(t).numpy(), js._nan_spread3(jnp.asarray(x)))
    for tau in (0.0, 1.0):
        m, v = ts._median_fill(t, torch.from_numpy(valid), tau)
        mr, vr = js._median_fill(jnp.asarray(x), jnp.asarray(valid), tau)
        _same(m.numpy(), mr)
        _same(v.numpy(), vr)


def test_sgm_params_from_state():
    """Every field of the JAX SgmParams carries over; backend is dropped."""
    jp = js.SgmParams(census_win=3, p1=4.0, p2=20.0, nb_dir=4,
                      subpix='parabola', median=False, lr_tau=0.5,
                      mgm=False, mgm_neighbors=2, min_confidence=0.25,
                      uniqueness_ratio=5.0, lr_mode='full',
                      p2_edge_scale=0.5, lr_int=True, median_first=True,
                      median_fill=True, fill_coh_tau=2.0,
                      overcount_fix=False, backend='interpret')
    d = dataclasses.asdict(jp)
    tp = state.sgm_params_from_state(d)
    d.pop('backend')
    assert dataclasses.asdict(tp) == d
    assert state.sgm_params_from_state(
        dataclasses.asdict(js.SgmParams())) == ts.SgmParams()
    with pytest.raises(ValueError):
        state.sgm_params_from_state(dict(d, bogus=1))


_LAX = {
    'mgm': dict(mgm=True),
    'bt': dict(mgm=False, cost='bt'),
    'census_win7': dict(mgm=False, census_win=7),
}


@pytest.mark.parametrize('route', sorted(_LAX) + ['unequal_widths',
                                                  'height_30', 'd_4',
                                                  'match_pair_mgm'])
def test_lax_only_routes_raise(route):
    """The routes the JAX package sends to its lax path (they raised
    before the port had it) equal its jitted lax route bitwise: the MGM
    wavefront, the Birchfield-Tomasi cost, a 7x7 census, and the classic
    scans off the kernels' shapes."""
    im1, im2 = _pair()
    kw, a, b, dmax = _LAX.get(route, dict(mgm=False)), im1, im2, 7
    if route == 'unequal_widths':
        b = im2[:, :24]
    elif route == 'height_30':
        a, b = im1[:30], im2[:30]
    elif route == 'd_4':
        dmax = -5
    jp = js.SgmParams(backend='lax', **kw)
    if route == 'match_pair_mgm':
        ref = js.match_pair(a, b, -8, dmax, jp)
        ours = ts.match_pair(a, b, -8, dmax, ts.SgmParams(**kw),
                             device='cpu')
        for o, r in zip(ours, ref):
            _same(o, r)
        return
    ref = js.sgm_match(jnp.asarray(a), jnp.asarray(b), -8, dmax, jp)
    out = ts.sgm_match(a, b, -8, dmax, ts.SgmParams(**kw), device='cpu')
    for k in ('disp', 'valid', 'confidence'):
        _same(out[k].numpy(), ref[k])
    assert 0.2 < np.isfinite(np.asarray(ref['disp'])).mean() < 1.0


def test_match_pair_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    im1, im2 = _pair()
    with pytest.raises(RuntimeError, match='CUDA'):
        ts.match_pair(im1, im2, -8, 7, ts.SgmParams(mgm=False))
    with pytest.raises(RuntimeError, match='CUDA'):
        ts.sgm_match(im1, im2, -8, 7, ts.SgmParams(mgm=False))
