"""The lax routes of the port's matchers (device="cpu") against the JAX
package's: the MGM wavefront (``ops/mgm.py``), the cost volumes
(``ops/census.py``), ``sgm_match`` off the kernels and
``compute_disparity_map`` for ``sgbm`` and the ``hirschmuller08``
variants.  Every comparison is bitwise and NaN-aware.

The JAX package's ``sgm_match`` is jitted, and XLA's CPU run rounds two
steps of the Birchfield-Tomasi route its own way: the box mean's division
by the constant win**2 becomes a multiplication by f32(1 / win**2), and
the overcount fix ``S - (n - 1) * cost`` folds the constants into one
product of the box sum, fused with the subtraction.  The port computes
both so (``census.bt_cost_sum``, ``sgm._aggregate``); the unjitted JAX
cost volume is the division's and differs from the jitted one in the
last bit, so the volume is held to the jitted function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2p_tpu.config import Config as JConfig
from s2p_tpu.core import matching as jm
from s2p_tpu.ops import census as jc
from s2p_tpu.ops import mgm as jmgm
from s2p_tpu.ops import sgm as js
from s2p_tpu_torch import state
from s2p_tpu_torch.core import matching as tm
from s2p_tpu_torch.ops import census as tc
from s2p_tpu_torch.ops import mgm as tmgm
from s2p_tpu_torch.ops import sgm as ts

from test_torch_sift import one_thread  # noqa: F401 (autouse fixture)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _pair(h, w, d=2.5, seed=0, w2=None):
    """A smoothed random texture and its copy shifted by ``d``, with NaN
    rows and columns; the secondary ``w2`` wide."""
    rng = np.random.RandomState(seed)
    w2 = w if w2 is None else w2
    tex = rng.rand(h, max(w, w2) + 8).astype(np.float32) * 200
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3
    xs = np.arange(tex.shape[1], dtype=np.float32)
    im1 = np.stack([np.interp(xs + d, xs, r) for r in tex])[:, :w]
    im1 = im1.astype(np.float32)
    im2 = tex[:, :w2].copy()
    im1[:3] = np.nan
    im2[:, -4:] = np.nan
    im1[h // 2, w // 3] = np.nan
    return im1, im2


# --------------------------------------------------------------------- #
# the MGM wavefront
# --------------------------------------------------------------------- #

@pytest.mark.parametrize('fan', sorted(jmgm._FANS))
@pytest.mark.parametrize('p2_map', [False, True])
@pytest.mark.parametrize('nb_dir', [4, 8])
@pytest.mark.parametrize('tsgm', [2, 3, 4])
def test_mgm_aggregate_matches(tsgm, nb_dir, p2_map, fan):
    """Float costs and non-integer penalties (P1 2.4, P2 9.6 or a map), so
    every sum is inexact: S and the votes equal the JAX package's."""
    rng = np.random.RandomState(tsgm * 10 + nb_dir)
    H, W, D = 11, 14, 6
    cost = (rng.rand(H, W, D) * 20).astype(np.float32)
    pm = (rng.rand(H, W) * 20 + 4).astype(np.float32) if p2_map else None
    S_ref, v_ref = jmgm.mgm_aggregate(
        jnp.asarray(cost), 2.4, 9.6, nb_dir, tsgm,
        None if pm is None else jnp.asarray(pm), True, fan)
    S, v = tmgm.mgm_aggregate(torch.from_numpy(cost), 2.4, 9.6, nb_dir,
                              tsgm, None if pm is None else
                              torch.from_numpy(pm), True, fan)
    _same(S.numpy(), S_ref)
    _same(v.numpy(), np.asarray(v_ref).astype(np.int32))


def test_skew_round_trips():
    vol = torch.arange(5 * 7 * 2, dtype=torch.float32).reshape(5, 7, 2)
    sk = tmgm._skew(vol, 7, 5)
    _same(sk.numpy(), jmgm._skew(jnp.asarray(vol.numpy()), 7, 5))
    _same(tmgm._unskew(sk, 7, 5).numpy(), vol.numpy())


# --------------------------------------------------------------------- #
# the cost volumes
# --------------------------------------------------------------------- #

@pytest.mark.parametrize('win', [3, 5, 7, 9])
def test_census_cost_volume_matches(win):
    im1, im2 = _pair(21, 30, seed=win, w2=34)
    ref = jax.jit(jc.census_cost_volume, static_argnums=(2, 3, 4))(
        jnp.asarray(im1), jnp.asarray(im2), -3, 8, win)
    out = tc.census_cost_volume(torch.from_numpy(im1), torch.from_numpy(im2),
                                -3, 8, win)
    _same(out[0].numpy(), ref[0])
    _same(out[1].numpy(), ref[1])
    assert (np.asarray(ref[0]) == win * win - 1).any()


@pytest.mark.parametrize('dmin', [-40, -2, 5])
def test_census_cost_volume_dyn_matches(dmin):
    im1, im2 = _pair(16, 24, seed=1)
    ref = jc.census_cost_volume_dyn(jnp.asarray(im1), jnp.asarray(im2),
                                    jnp.int32(dmin), 12, 5, 30.0)
    out = tc.census_cost_volume_dyn(torch.from_numpy(im1),
                                    torch.from_numpy(im2), dmin, 12, 5,
                                    30.0)
    _same(out[0].numpy(), ref[0])
    _same(out[1].numpy(), ref[1])


@pytest.mark.parametrize('win', [1, 3, 5])
def test_birchfield_tomasi_cost_volume_matches(win):
    im1, im2 = _pair(21, 30, seed=win, w2=27)
    ref = jax.jit(jc.birchfield_tomasi_cost_volume,
                  static_argnums=(2, 3, 4))(jnp.asarray(im1),
                                            jnp.asarray(im2), -3, 8, win)
    out = tc.birchfield_tomasi_cost_volume(
        torch.from_numpy(im1), torch.from_numpy(im2), -3, 8, win)
    _same(out[0].numpy(), ref[0])
    _same(out[1].numpy(), ref[1])


def test_census_transform_keeps_one_word():
    """One word up to 5x5; at 7x7, which raised before, the JAX package's
    two words (its contract: int32 bit patterns, a word axis)."""
    im1, _ = _pair(12, 16)
    sig, valid = tc.census_transform(torch.from_numpy(im1), 5)
    words, v2 = tc.census_words(torch.from_numpy(im1), 5)
    assert sig.dtype == torch.int32 and words.shape[-1] == 1
    _same(sig.numpy(), words.to(torch.int32).numpy())
    _same(valid.numpy(), v2.numpy())
    sig, valid = tc.census_transform(torch.from_numpy(im1), 7)
    ref, ref_valid = jc.census_transform(jnp.asarray(im1), 7)
    assert sig.shape[-1] == 2
    _same(sig.numpy().view(np.uint32), ref)
    _same(valid.numpy(), ref_valid)


def test_sgm_match_batch_matches_jax():
    """Two tiles of a bucket with different disparity bases, each on the
    lax route (the JAX package's ``allow_pallas=False``), at non-integer
    penalties with the edge-aware P2 and the filling median: bitwise
    (``tests/test_batch_matching.py``'s parameters); the BT cost raises,
    as there."""
    kw = dict(mgm=False, p1=12.0, p2=48.0, p2_edge_scale=0.5, lr_tau=1.0,
              median_first=True, median_fill=True)
    rng = np.random.RandomState(0)
    im1 = rng.rand(64, 64).astype(np.float32) * 100
    im2 = np.roll(im1, 3, axis=1) + 0.5 * rng.rand(64, 64).astype(np.float32)
    b1, b2 = np.stack([im1, im1]), np.stack([im2, im2])
    ref = js.sgm_match_batch(jnp.asarray(b1), jnp.asarray(b2),
                             jnp.array([-16, -24]), 32,
                             js.SgmParams(backend='lax', **kw))
    out = ts.sgm_match_batch(b1, b2, [-16, -24], 32, ts.SgmParams(**kw),
                             device='cpu')
    for k in ('disp', 'valid', 'confidence'):
        _same(out[k].numpy(), ref[k])
    assert np.isfinite(np.asarray(ref['disp'])).mean() > 0.5
    with pytest.raises(NotImplementedError, match='static'):
        ts.sgm_match_batch(b1, b2, [0, 0], 8, ts.SgmParams(cost='bt'),
                           device='cpu')


# --------------------------------------------------------------------- #
# sgm_match on the lax route
# --------------------------------------------------------------------- #

_M = 0.3
_CASES = {
    # (params, image shape, secondary width, range)
    'mgm_m03': (dict(p1=8 * _M, p2=32 * _M), (30, 40), None, (-3, 8)),
    'mgm_tsgm2_nb4_edge_p2': (dict(mgm_neighbors=2, nb_dir=4,
                                   p2_edge_scale=0.5, p1=13.6, p2=54.4),
                              (28, 36), None, (-3, 8)),
    'sgbm_full_lr': (dict(census_win=3, cost='bt', p1=72.0, p2=288.0,
                          subpix='parabola', median=False,
                          uniqueness_ratio=10.0, lr_mode='full'),
                     (30, 40), None, (-3, 8)),
    'bt_win5_m17_nb6': (dict(census_win=5, cost='bt', p1=8 * 1.7,
                             p2=32 * 1.7, nb_dir=6), (26, 35), 38, (-4, 6)),
    'classic_off_shape_m03': (dict(mgm=False, p1=8 * _M, p2=32 * _M,
                                   uniqueness_ratio=5.0, median_first=True),
                              (27, 37), 33, (-3, 8)),
    'classic_census9': (dict(mgm=False, census_win=9, nb_dir=4,
                             lr_mode='full'), (32, 40), None, (-2, 5)),
}


@pytest.mark.parametrize('case', sorted(_CASES))
def test_sgm_match_lax_route_matches(case):
    kw, (h, w), w2, (dmin, dmax) = _CASES[case]
    im1, im2 = _pair(h, w, seed=len(case), w2=w2)
    ref = js.sgm_match(jnp.asarray(im1), jnp.asarray(im2), dmin, dmax,
                       js.SgmParams(backend='lax', **kw))
    out = ts.sgm_match(im1, im2, dmin, dmax, ts.SgmParams(**kw),
                       device='cpu')
    assert not ts._use_kernels(im1.shape, im2.shape, dmax - dmin + 1,
                               ts.SgmParams(**kw))
    for k in ('disp', 'valid', 'confidence'):
        _same(out[k].numpy(), ref[k])
    assert 0.2 < np.isfinite(np.asarray(ref['disp'])).mean() < 1.0


def test_sgm_match_lax_route_with_weight_maps():
    """The mgm wavefront under per-pixel P2 weight maps of both images
    (``p2_scale``, ``p2_scale_r``) and the full LR pass."""
    im1, im2 = _pair(24, 32, seed=9)
    rng = np.random.RandomState(9)
    s1 = (rng.rand(24, 32) * 0.8 + 0.2).astype(np.float32)
    s2 = (rng.rand(24, 32) * 0.8 + 0.2).astype(np.float32)
    kw = dict(lr_mode='full', p1=2.4, p2=9.6)
    ref = js.sgm_match(jnp.asarray(im1), jnp.asarray(im2), -3, 8,
                       js.SgmParams(**kw), jnp.asarray(s1), jnp.asarray(s2))
    out = ts.sgm_match(im1, im2, -3, 8, ts.SgmParams(**kw), s1, s2,
                       device='cpu')
    for k in ('disp', 'valid', 'confidence'):
        _same(out[k].numpy(), ref[k])


# --------------------------------------------------------------------- #
# the SGBM matchers
# --------------------------------------------------------------------- #

@pytest.mark.parametrize('algo', tm.SGBM_MATCHERS)
def test_compute_disparity_map_sgbm_matchers(algo):
    im1, im2 = _pair(34, 45, d=3.0, seed=2, w2=47)
    ref = jm.compute_disparity_map(JConfig(matching_algorithm=algo), im1,
                                   im2, -4.3, 8.6)
    ours = tm.compute_disparity_map(
        state.config_from_state({'matching_algorithm': algo}), im1, im2,
        -4.3, 8.6, device='cpu')
    _same(ours[0], ref[0])
    _same(ours[1], ref[1])
    assert ours[2] is None and ref[2] is None
    assert ours[1].mean() > 0.3
