"""The port's single-tile mgm flow (device="cpu") against the JAX package,
bitwise and NaN-aware: ``mgm_binary_match`` against both of its routes
(lax, and Pallas in interpret mode), its pieces one by one, the kernel
route's plain versions (``sgm_kernels.flow_one_side``) against
``flow_one_side_pallas``, and ``compute_disparity_map`` for ``mgm``.

``edge_subpix`` and ``subpix_plateau='zero'`` are held to the lax route
only: the JAX package's Pallas route ignores ``edge_subpix`` (a
behaviour of the reference, pinned below), and the port follows the lax
semantics on both of its routes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2p_tpu.config import Config as JaxConfig
from s2p_tpu.core import matching as jm
from s2p_tpu.ops import mgm_flow as mf
from s2p_tpu.ops import sgm_pallas as sp
from s2p_tpu_torch.config import Config
from s2p_tpu_torch.core import matching as tm
from s2p_tpu_torch.ops import mgm_flow as tf
from s2p_tpu_torch.ops import sgm_kernels as sk


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _pair(H, W, d, seed=0):
    """Like tests/test_mgm_flow.py's synthetic pair: a smoothed random
    texture, the reference shifted by ``d``."""
    rng = np.random.RandomState(seed)
    im2 = rng.rand(H, W).astype(np.float32) * 200
    im2 = (im2 + np.roll(im2, 1, 0) + np.roll(im2, 1, 1)) / 3
    xs = np.arange(W, dtype=np.float32)
    im1 = np.stack([np.interp(xs + d, xs, row) for row in im2])
    return im1.astype(np.float32), im2


def _nan_pair(H, W, d, seed=0):
    im1, im2 = _pair(H, W, d, seed)
    im1[:5] = np.nan
    im2[:, -7:] = np.nan
    return im1, im2


# (height, width, disp_min, disp_max): aligned; unaligned with NaN rows
# and columns (the padded static-extent route); the whole range outside
# the secondary (every pixel NaN)
_TILES = {
    'aligned_64x96': (64, 96, -2, 7),
    'unaligned_70x90': (70, 90, -2, 7),
    'range_outside': (40, 48, 60, 67),
}


@pytest.mark.parametrize('backend', ['lax', 'interpret'])
@pytest.mark.parametrize('tile', sorted(_TILES))
def test_mgm_binary_match_matches_jax(tile, backend):
    H, W, dmin, dmax = _TILES[tile]
    im1, im2 = _nan_pair(H, W, 3.0, seed=len(tile))
    if tile == 'unaligned_70x90':
        im1[:, 40:43] = np.nan
        im2[20:23] = np.nan
    ref = mf.mgm_binary_match(im1, im2, dmin, dmax,
                              mf.MgmVariant(backend=backend))
    disp, conf = tf.mgm_binary_match(im1, im2, dmin, dmax, tf.MgmVariant(),
                                     device='cpu')
    _same(disp.numpy(), ref[0])
    _same(conf.numpy(), ref[1])
    d = np.asarray(ref[0])
    if tile == 'range_outside':
        assert np.isnan(d).all()
    else:
        assert 0.5 < np.isfinite(d).mean() < 1.0


# the single-tile knobs the batch refuses, against the lax route only
_KNOBS = {
    'edge_subpix': dict(edge_subpix=True),
    'plateau_zero': dict(subpix_plateau='zero'),
    'edge_plateau_parabola_nb4': dict(edge_subpix=True,
                                      subpix_plateau='zero',
                                      subpix='parabola', nb_dir=4),
    'nb7_after_lr_no_median': dict(nb_dir=7, median_order='none',
                                   lr_tau=0.5),
}


@pytest.mark.parametrize('knobs', sorted(_KNOBS))
def test_single_tile_knobs_match_lax(knobs):
    kw = _KNOBS[knobs]
    im1, im2 = _nan_pair(57, 83, 2.5, seed=3)
    ref = mf.mgm_binary_match(im1, im2, -3, 8,
                              mf.MgmVariant(backend='lax', **kw))
    disp, conf = tf.mgm_binary_match(im1, im2, -3, 8, tf.MgmVariant(**kw),
                                     device='cpu')
    _same(disp.numpy(), ref[0])
    _same(conf.numpy(), ref[1])


def test_jax_interpret_route_ignores_edge_subpix():
    """On a 40 x 64 pair with range -2..7 the JAX package's two routes
    disagree under ``edge_subpix``: its Pallas route returns the default
    variant's map.  The port equals the lax route."""
    im1, im2 = _pair(40, 64, 3.0)
    v = dict(edge_subpix=True)
    lax = np.asarray(mf.mgm_binary_match(
        im1, im2, -2, 7, mf.MgmVariant(backend='lax', **v))[0])
    pal = np.asarray(mf.mgm_binary_match(
        im1, im2, -2, 7, mf.MgmVariant(backend='interpret', **v))[0])
    default = np.asarray(mf.mgm_binary_match(
        im1, im2, -2, 7, mf.MgmVariant(backend='interpret'))[0])
    differ = ~((lax == pal) | (np.isnan(lax) & np.isnan(pal)))
    assert differ.any()
    _same(pal, default)
    ours = tf.mgm_binary_match(im1, im2, -2, 7, tf.MgmVariant(**v),
                               device='cpu')[0]
    _same(ours.numpy(), lax)


@pytest.mark.parametrize('ext', [None, (57, 83, 80, 10)])
def test_census_cost_raw_matches(ext):
    im1, im2 = _nan_pair(64, 96, 3.0)
    h1 = w1 = w2 = d_true = None
    if ext is not None:
        h1, w1, w2, d_true = ext
    ref = mf.census_cost_raw(jnp.asarray(im1), jnp.asarray(im2), -4, 16, 5,
                             h1, w1, w2, d_true)
    ours = tf.census_cost_raw(torch.from_numpy(im1), torch.from_numpy(im2),
                              -4, 16, 5, h1, w1, w2, d_true)
    _same(ours.numpy(), ref)
    assert (np.asarray(ref) == float(mf.BIG)).any()


@pytest.mark.parametrize('kw', [{}, {'nb_dir': 6, 'overcount_fix': False},
                                {'edge_subpix': True, 'subpix': 'parabola',
                                 'subpix_plateau': 'zero'}])
def test_aggregate_flow_and_wta_refine_match(kw):
    """The plain reference's scans, votes and WTA on one cost volume."""
    im1, im2 = _nan_pair(40, 56, 2.0, seed=5)
    cost = mf.census_cost_raw(jnp.asarray(im1), jnp.asarray(im2), -3, 12, 5,
                              38, 50, 52, 10)
    S_ref, votes_ref = mf._aggregate_flow(cost, mf.MgmVariant(**kw))
    disp_ref, d_ref = mf._wta_refine(S_ref, -3, mf.MgmVariant(**kw))
    S, votes = tf._aggregate_flow(torch.from_numpy(np.array(cost)),
                                  tf.MgmVariant(**kw))
    disp, d = tf._wta_refine(S, -3, tf.MgmVariant(**kw))
    _same(S.numpy(), S_ref)
    assert len(votes) == len(votes_ref)
    for o, r in zip(votes, votes_ref):
        _same(o.numpy(), r)
    _same(disp.numpy(), disp_ref)
    _same(d.numpy(), d_ref)


@pytest.mark.parametrize('side', ['left_neg_base_ext', 'right_pos_base'])
def test_flow_one_side_matches_pallas(side):
    """The kernel route (its plain versions): flow signatures, the
    signed-base pre-pass with the padded secondary, the four scans, the
    WTA with ``big_guard``."""
    im1, im2 = _nan_pair(64, 96, 3.0, seed=7)
    if side == 'left_neg_base_ext':
        a, b, dmin, D, ext = im1, im2, -5, 16, (57, 83, 80, 11)
    else:
        a, b, dmin, D, ext = im2, im1, 3, 10, None
    disp, d_int, votes = sk.flow_one_side(
        torch.from_numpy(a)[None], torch.from_numpy(b)[None], dmin, D,
        tf.MgmVariant(), ext=ext)
    rd, rdi, rvo = sp.flow_one_side_pallas(
        jnp.asarray(a), jnp.asarray(b), dmin, D,
        mf.MgmVariant(backend='interpret'), interpret=True, ext=ext)
    _same(disp[0].numpy(), rd)
    _same(d_int[0].numpy(), rdi)
    assert len(votes) == len(rvo) == 8
    for o, r in zip(votes, rvo):
        _same(o[0].numpy(), r)


def test_flow_one_side_edge_modes_match_lax_side():
    """K3's ``edge_subpix`` and ``plateau_zero`` modes (plain versions) on
    the kernel route equal the lax route's side."""
    im1, im2 = _nan_pair(48, 64, 2.0, seed=9)
    kw = dict(edge_subpix=True, subpix_plateau='zero')
    ext = (44, 60, 58, 12)
    disp, d_int, _ = sk.flow_one_side(
        torch.from_numpy(im1)[None], torch.from_numpy(im2)[None], -4, 12,
        tf.MgmVariant(**kw), ext=ext)
    rd, rdi, _ = mf._mgm_one_side(jnp.asarray(im1), jnp.asarray(im2), -4,
                                  12, mf.MgmVariant(backend='lax', **kw),
                                  *ext[:3], d_true=ext[3])
    pad = np.zeros(im1.shape, bool)
    pad[44:] = True
    pad[:, 60:] = True
    _same(np.where(pad, np.nan, disp[0].numpy()), rd)
    _same(d_int[0].numpy(), rdi)


@pytest.mark.parametrize('edge,plateau', [(True, False), (False, True),
                                          (True, True)])
def test_wta_edge_modes_match_wta_refine(edge, plateau):
    """K3's new modes (plain version) against ``_wta_refine`` of the lax
    route, the disparity composed as ``(disp_min + d) + off``."""
    rng = np.random.RandomState(13)
    H, W, D, dmin = 12, 20, 16, -6
    S = (rng.randint(0, 40, size=(H, W, D)) * 4).astype(np.float32)
    S[rng.rand(H, W, D) < 0.2] = np.float32(1e9)       # out-of-range
    S[:, :3] = np.float32(1e9)                         # no candidate
    S[2, 5, 4:7] = S[2, 5, 5]                          # a flat run
    variant = dict(edge_subpix=edge,
                   subpix_plateau='zero' if plateau else 'clip')
    ref, d_ref = mf._wta_refine(jnp.asarray(S), dmin,
                                mf.MgmVariant(**variant))
    part = torch.from_numpy(S).permute(0, 2, 1)[None]   # (1, H, D, W)
    off, d = sk.wta([part], 'vfit', tf.BIG / 2, edge_subpix=edge,
                    plateau_zero=plateau)
    disp = (np.float32(dmin) + d[0].numpy().astype(np.float32)) + \
        off[0].numpy()
    _same(disp, ref)
    _same(d[0].numpy(), np.asarray(d_ref).astype(np.int32))


def test_compute_disparity_map_matches_jax():
    im1, im2 = _nan_pair(60, 75, 4.0, seed=11)
    ref = jm.compute_disparity_map(JaxConfig(), im1, im2, -3, 9)
    ours = tm.compute_disparity_map(Config(), im1, im2, -3, 9, device='cpu')
    for o, r in zip(ours, ref):
        _same(o, r)
    assert ours[1].dtype == np.uint8 and ours[1].any()


def test_single_tile_routes_of_every_variant():
    """What raised before this slice equals the JAX package's: the flow at
    a 7x7 census window (its lax route), ``hirschmuller02`` (by
    ``test_torch_msmw.py``'s criterion) and the cascade with ``tsgm=2``
    (the wavefront per level).  The batch's edge knobs still raise.
    ``tsgm=2`` and ``sgbm``, which raised before the wavefront and the lax
    matcher were ported, equal the JAX package's lax route."""
    from test_torch_msmw import check_msmw

    a = np.zeros((8, 8), np.float32)
    with pytest.raises(NotImplementedError, match='single-tile'):
        tf.mgm_binary_match_batch(a[None], a[None], [0], 4, [8], [8], [8],
                                  variant=tf.MgmVariant(edge_subpix=True),
                                  device='cpu')
    im1, im2 = _nan_pair(37, 45, 2.0, seed=4)
    ref = mf.mgm_binary_match(im1, im2, -3, 8,
                              mf.MgmVariant(backend='lax', census_win=7))
    disp, conf = tf.mgm_binary_match(im1, im2, -3, 8,
                                     tf.MgmVariant(census_win=7),
                                     device='cpu')
    _same(disp.numpy(), ref[0])
    _same(conf.numpy(), ref[1])
    ref = jm.compute_disparity_map(
        JaxConfig(matching_algorithm='hirschmuller02'), im1, im2, -3, 8)
    ours = tm.compute_disparity_map(
        Config(matching_algorithm='hirschmuller02'), im1, im2, -3, 8,
        device='cpu')
    check_msmw((ours[0], ours[1] == 1), (ref[0], ref[1] == 1),
               'hirschmuller02')
    kw = dict(tsgm=2, median_order='none')
    ref = mf.mgm_multi_match(im1, im2, -3, 8,
                             mf.MgmVariant(backend='lax', **kw), scales=2)
    ours = tf.mgm_multi_match(im1, im2, -3, 8, tf.MgmVariant(**kw),
                              scales=2, device='cpu')
    _same(ours[0].numpy(), ref[0])
    _same(ours[1].numpy(), ref[1])
    im1, im2 = _nan_pair(37, 45, 2.0, seed=4)
    ref = mf.mgm_binary_match(im1, im2, -3, 8,
                              mf.MgmVariant(backend='lax', tsgm=2))
    disp, conf = tf.mgm_binary_match(im1, im2, -3, 8, tf.MgmVariant(tsgm=2),
                                     device='cpu')
    _same(disp.numpy(), ref[0])
    _same(conf.numpy(), ref[1])
    ref = jm.compute_disparity_map(JaxConfig(matching_algorithm='sgbm'),
                                   im1, im2, -3, 8)
    ours = tm.compute_disparity_map(Config(matching_algorithm='sgbm'), im1,
                                    im2, -3, 8, device='cpu')
    _same(ours[0], ref[0])
    _same(ours[1], ref[1])
    assert ours[2] is None and ref[2] is None


def test_non_integer_penalties_sum_in_the_kernels_order():
    """At ``stereo_regularity_multiplier`` 0.3 (P1 2.4, P2 9.6) float32
    sums depend on their order.  The single tile sums in the kernels'
    order on both devices: it equals the batch entry on the same tile and
    the JAX package's interpret (Pallas) route, and differs from its lax
    route (931 of 6,144 disparities on this tile)."""
    im1, im2 = _pair(64, 96, 2.0, seed=3)
    kw = dict(p1=8.0 * 0.3, p2=32.0 * 0.3)
    disp, conf = tf.mgm_binary_match(im1, im2, -3, 12, tf.MgmVariant(**kw),
                                     device='cpu')
    batch = tf.mgm_binary_match_batch(im1[None], im2[None], [-3], 16, [64],
                                      [96], [96], [16], tf.MgmVariant(**kw),
                                      device='cpu')
    _same(disp.numpy(), batch['disp'][0].numpy())
    _same(conf.numpy(), batch['confidence'][0].numpy())
    pal = mf.mgm_binary_match(im1, im2, -3, 12,
                              mf.MgmVariant(backend='interpret', **kw))
    _same(disp.numpy(), pal[0])
    _same(conf.numpy(), pal[1])
    lax = np.asarray(mf.mgm_binary_match(
        im1, im2, -3, 12, mf.MgmVariant(backend='lax', **kw))[0])
    d = disp.numpy()
    differ = ~((d == lax) | (np.isnan(d) & np.isnan(lax)))
    print(f'm 0.3: {differ.sum()} of {differ.size} disparities differ from '
          'the lax route')
    assert differ.sum() == 931
