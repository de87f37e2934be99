"""The port's mgm_multi cascade (device="cpu") against the JAX package's
jitted runs, bitwise and NaN-aware: the pyramid helpers, the fractional
census cost, the scans with a per-pixel P2, ``mgm_multi_match`` and
``mgm_multi_match_batch``, ``compute_disparity_map`` for ``mgm_multi``
and ``mgm_multi_lsd``, and stage 4's two routes for them: the
``mgm_multi`` batch and the per-tile route of ``mgm_multi_lsd``, file for
file against the JAX drivers on the same tile tree.

The JAX package compiles one cascade per shape, range and variant (about
6 s each here), so the cases share them: ``compute_disparity_map`` runs
at the shape, range and variant of a ``mgm_multi_match`` case, whose
compiled program the JAX package then reuses."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2p_tpu import pipeline as jpipe
from s2p_tpu.config import Config as JConfig
from s2p_tpu.core import matching as jm
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu.ops import lsd as jlsd
from s2p_tpu.ops import mgm_flow as mf
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch.core import matching as tm
from s2p_tpu_torch.geo import geotiff as tgeotiff
from s2p_tpu_torch.ops import mgm_flow as tf

from test_torch_runner import _raises_in_time, hang  # noqa: F401 (fixture)
from test_torch_runner import _tiles as _hang_tiles
from test_torch_sift import one_thread  # noqa: F401 (autouse fixture)

_OUTPUTS = ('rectified_disp.tif', 'rectified_mask.png',
            'rectified_disp_confidence.tif')


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _pair(H, W, d, seed=0):
    """A smoothed random texture and its copy shifted by ``d`` px, with a
    few blocks and a slanted band, so that LSD finds segments."""
    rng = np.random.RandomState(seed)
    im2 = rng.rand(H, W).astype(np.float32) * 200
    im2 = (im2 + np.roll(im2, 1, 0) + np.roll(im2, 1, 1)) / 3
    ys, xs = np.mgrid[:H, :W]
    im2[H // 6:H // 2, W // 8:W // 2] += 60
    im2[np.abs(ys - 0.5 * xs - H // 3) < 2] -= 70
    xs = np.arange(W, dtype=np.float32)
    im1 = np.stack([np.interp(xs + d, xs, row) for row in im2])
    return im1.astype(np.float32), im2.astype(np.float32)


def _nan_pair(H, W, d, seed=0):
    im1, im2 = _pair(H, W, d, seed)
    im1[:5] = np.nan
    im2[:, -7:] = np.nan
    im1[H // 2:H // 2 + 2, 30:34] = np.nan
    return im1, im2


def _p2_maps(H, W, p2, seed):
    """LSD-like weight maps times P2: 0.1 on a fifth of the pixels."""
    rng = np.random.RandomState(seed)
    w = [np.where(rng.rand(H, W) < 0.2, np.float32(0.1), np.float32(1.0))
         .astype(np.float32) for _ in range(2)]
    return [m * p2 for m in w]


def _ints(*xs):
    return [torch.tensor([x]) for x in xs]


# --------------------------------------------------------------------- #
# the pyramid helpers
# --------------------------------------------------------------------- #

_SHAPES = {'even': (48, 64), 'odd': (37, 51)}


def _field(shape, seed):
    """A float32 map with NaN holes (a coarse disparity or an image)."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(*shape) * 40 - 15).astype(np.float32)
    x[rng.rand(*shape) < 0.15] = np.nan
    x[:3, :4] = np.nan
    return x


def _helper_downsample(shape):
    x = _field(shape, 1) * 7
    return (jax.jit(mf._downsample2_img)(jnp.asarray(x)),
            tf._downsample2_img(torch.from_numpy(x)[None])[0])


def _helper_minmax(shape):
    x = _field(shape, 2)
    ref = jax.jit(mf._minmax3_nan)(jnp.asarray(x))
    ours = tf._minmax3_nan(torch.from_numpy(x)[None])
    return ref, [o[0] for o in ours]


def _helper_upsample(shape):
    x = _field(((shape[0] + 1) // 2, (shape[1] + 1) // 2), 3)
    ref = jax.jit(mf._upsample2_vals, static_argnums=(1, 2))(
        jnp.asarray(x), *shape)
    return ref, tf._upsample2_vals(torch.from_numpy(x)[None], *shape)[0]


def _helper_range_maps(shape):
    x = _field(((shape[0] + 1) // 2, (shape[1] + 1) // 2), 4) * 0.5
    fn = jax.jit(mf._range_maps_from_coarse, static_argnums=(1, 2))
    ref = fn(jnp.asarray(x), *shape, jnp.float32(-9), jnp.float32(12))
    ours = tf._range_maps_from_coarse(torch.from_numpy(x)[None], *shape,
                                      torch.tensor([-9]), torch.tensor([12]))
    return ref, [o[0] for o in ours]


def _helper_divs(shape):
    a = np.arange(-3 * shape[0], 2 * shape[1], dtype=np.int32)
    ref = [jax.jit(lambda v: fn(v, k))(jnp.asarray(a))
           for fn in (mf._ceil_div, mf._floor_div) for k in (2, 4, 32)]
    ours = [fn(torch.from_numpy(a), k).to(torch.int32)
            for fn in (tf._ceil_div, tf._floor_div) for k in (2, 4, 32)]
    # and the JAX package's python-int branch
    assert [mf._ceil_div(int(v), 4) for v in a[:50]] == \
        tf._ceil_div(torch.from_numpy(a[:50]), 4).tolist()
    return ref, ours


_HELPERS = {'downsample2_img': _helper_downsample,
            'minmax3_nan': _helper_minmax, 'upsample2_vals': _helper_upsample,
            'range_maps_from_coarse': _helper_range_maps,
            'ceil_floor_div': _helper_divs}


@pytest.mark.parametrize('shape', sorted(_SHAPES))
@pytest.mark.parametrize('helper', sorted(_HELPERS))
def test_pyramid_helper_matches_jit(helper, shape):
    ref, ours = _HELPERS[helper](_SHAPES[shape])
    if not isinstance(ours, list):
        ref, ours = [ref], [ours]
    assert len(ref) == len(ours)
    for r, o in zip(ref, ours):
        _same(o.numpy(), np.asarray(r))


def test_downsample_is_not_separate_multiply_adds():
    """The jitted blur contracts its taps into fused multiply-adds: a
    plain sum of products differs from it on this input, the port's
    emulated fused chain does not."""
    x = _field((96, 128), 5) * 9.3
    ref = np.asarray(jax.jit(mf._downsample2_img)(jnp.asarray(x)))
    k = np.asarray([1, 4, 6, 4, 1], np.float32) / np.float32(16)
    p = np.pad(x, ((2, 2), (0, 0)), mode='edge')
    v = sum(p[i:i + 96] * k[i] for i in range(5))
    p = np.pad(v, ((0, 0), (2, 2)), mode='edge')
    plain = sum(p[:, i:i + 128] * k[i] for i in range(5))[::2, ::2]
    fin = np.isfinite(ref)
    assert (plain[fin] != ref[fin]).any()
    _same(tf._downsample2_img(torch.from_numpy(x)[None])[0].numpy(), ref)


# --------------------------------------------------------------------- #
# the fractional census cost and the scans
# --------------------------------------------------------------------- #

_COST_CASES = {
    'sd1_full': dict(sd=1, ext=None, maps=False),
    'sd2_full': dict(sd=2, ext=None, maps=False),
    'sd1_ext_maps': dict(sd=1, ext=(35, 50, 47, 15), maps=True),
    'sd2_ext_maps': dict(sd=2, ext=(35, 50, 47, 19), maps=True),
}


@pytest.mark.parametrize('case', sorted(_COST_CASES))
def test_census_cost_frac_matches_jit(case):
    c = _COST_CASES[case]
    sd = c['sd']
    H, W, dmin, D = 40, 56, -4, 21
    im1, im2 = _nan_pair(H, W, 2.5, seed=6)
    lo = hi = None
    if c['maps']:
        rng = np.random.RandomState(7)
        lo = (dmin + rng.rand(H, W) * 6).astype(np.float32)
        hi = (lo + rng.rand(H, W) * 5).astype(np.float32)
        lo[5:9] = np.float32(dmin)      # whole rows at the global range
    fn = jax.jit(mf._census_cost_frac, static_argnames=('D', 'sd', 'win'))
    h1, w1, w2, d_true = c['ext'] or (None,) * 4
    ref = np.asarray(fn(jnp.asarray(im1), jnp.asarray(im2), dmin, D=D, sd=sd,
                        win=5, h1=h1, w1=w1, w2=w2, d_true=d_true,
                        lo_map=None if lo is None else jnp.asarray(lo),
                        hi_map=None if hi is None else jnp.asarray(hi)))
    h1, w1, w2, d_true = c['ext'] or (H, W, W, D)
    ours = tf._census_cost_frac(
        torch.from_numpy(im1)[None], torch.from_numpy(im2)[None],
        *_ints(dmin), D, sd, 5, *_ints(h1, w1, w2, d_true),
        None if lo is None else torch.from_numpy(lo)[None],
        None if hi is None else torch.from_numpy(hi)[None])[0]
    big = ref == np.float32(mf.BIG)
    assert big.any() and (~big).any()
    # as the uint8 volume the kernels scan, and as the JAX package's floats
    _same(ours.numpy(), np.where(big, 255, ref).astype(np.uint8))
    _same(torch.where(ours == 255, tf.BIG, ours.to(torch.float32)).numpy(),
          ref)


@pytest.mark.parametrize('p2_map', [False, True])
def test_aggregate_flow_matches_jit(p2_map):
    """The scans in the JAX package's order of additions: with P2 per
    pixel (non-integer, as the lsd variant's) the sums are inexact, and S
    is still equal to the bit."""
    im1, im2 = _nan_pair(40, 56, 2.0, seed=5)
    cost = mf._census_cost_frac(jnp.asarray(im1), jnp.asarray(im2), -3, 23, 2,
                                5, 38, 50, 52, 21)
    p2 = jnp.asarray(_p2_maps(40, 56, 48.0, 8)[0]) if p2_map else None
    v = mf.MgmVariant(p1=12.0, p2=48.0)
    S_ref, votes_ref = jax.jit(lambda c, p: mf._aggregate_flow(c, v, p))(
        cost, p2)
    S, votes = tf._aggregate_flow(
        torch.from_numpy(np.array(cost)), tf.MgmVariant(p1=12.0, p2=48.0),
        None if p2 is None else torch.from_numpy(np.array(p2)))
    _same(S.numpy(), S_ref)
    assert len(votes) == len(votes_ref) == 8
    for o, r in zip(votes, votes_ref):
        _same(o.numpy(), r)


# --------------------------------------------------------------------- #
# the cascade
# --------------------------------------------------------------------- #

# (shape, range, variant knobs, p2 maps' P2 or None); at least 3 levels
_MATCH_CASES = {
    'even_narrow_none': ((96, 128), (-3, 9), {'median_order': 'none'}, None),
    'even_wide_lsd': ((96, 128), (-40, 60),
                      {'median_order': 'before_lr', 'p1': 12.0, 'p2': 48.0},
                      48.0),
    'ragged_wide_maps': ((83, 117), (-40, 60), {'median_order': 'none'},
                         32.0),
    'ragged_narrow_before_lr_nb6': ((83, 117), (-3, 9),
                                    {'median_order': 'before_lr',
                                     'nb_dir': 6}, None),
}


def _match_inputs(case):
    (H, W), (dmin, dmax), kw, p2 = _MATCH_CASES[case]
    im1, im2 = _nan_pair(H, W, -20.0 if dmin < -10 else 3.0, seed=H)
    maps = _p2_maps(H, W, p2, seed=W) if p2 else (None, None)
    return im1, im2, dmin, dmax, kw, maps


@functools.lru_cache(maxsize=None)
def _jax_match(case):
    im1, im2, dmin, dmax, kw, maps = _match_inputs(case)
    out = mf.mgm_multi_match(im1, im2, dmin, dmax, mf.MgmVariant(**kw),
                             p2_map=maps[0], p2_map_r=maps[1])
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize('case', sorted(_MATCH_CASES))
def test_mgm_multi_match_matches_jax(case):
    im1, im2, dmin, dmax, kw, maps = _match_inputs(case)
    ref = _jax_match(case)
    disp, conf = tf.mgm_multi_match(im1, im2, dmin, dmax,
                                    tf.MgmVariant(**kw), p2_map=maps[0],
                                    p2_map_r=maps[1], device='cpu')
    _same(disp.numpy(), ref[0])
    _same(conf.numpy(), ref[1])
    true = -20.0 if dmin < -10 else 3.0
    d = ref[0][np.isfinite(ref[0])]
    assert d.size > 0.5 * ref[0].size
    assert np.mean(np.abs(d - true) < 1) > 0.8


def test_mgm_multi_match_batch_matches_jax():
    """Three tiles of different shapes, bases and candidate counts in one
    padded bucket."""
    Hp, Wp, D = 128, 128, 48
    specs = [(96, 120, 3.0, -3, 9), (70, 100, -2.0, -8, 20),
             (128, 128, 5.0, 0, 40)]
    b1 = np.full((3, Hp, Wp), np.nan, np.float32)
    b2 = b1.copy()
    w2 = []
    for k, (h, w, d, _, _) in enumerate(specs):
        a, b = _pair(h, w, d, seed=10 + k)
        b1[k, :h, :w] = a
        b2[k, :h, :w - k] = b[:, :w - k]
        w2.append(w - k)
    args = (b1, b2, [s[3] for s in specs], D, [s[0] for s in specs],
            [s[1] for s in specs], w2, [s[4] - s[3] + 1 for s in specs])
    ref = mf.mgm_multi_match_batch(*args, mf.MgmVariant(median_order='none'))
    ours = tf.mgm_multi_match_batch(*args, tf.MgmVariant(median_order='none'),
                                    device='cpu')
    assert sorted(ours) == sorted(ref)
    for key in ref:
        _same(ours[key].numpy(), ref[key])
    for k, (h, w, d, _, _) in enumerate(specs):
        disp = np.asarray(ref['disp'])[k, :h, :w]
        assert np.mean(np.abs(disp[np.isfinite(disp)] - d) < 1) > 0.8
        assert np.isnan(np.asarray(ref['disp'])[k, h:]).all()


@pytest.mark.parametrize('algo,case', [
    ('mgm_multi', 'even_narrow_none'), ('mgm_multi_lsd', 'even_wide_lsd')])
def test_compute_disparity_map_matches_jax(algo, case):
    """All three outputs, the speckle filter included; the lsd variant's
    weight maps come from LSD on each image."""
    im1, im2, dmin, dmax, _, _ = _match_inputs(case)
    if algo == 'mgm_multi_lsd':
        assert (jlsd.lsd_weights(im1) < 1).any()
    ref = jm.compute_disparity_map(JConfig(matching_algorithm=algo), im1,
                                   im2, dmin, dmax)
    ours = tm.compute_disparity_map(
        state.config_from_state({'matching_algorithm': algo}), im1, im2,
        dmin, dmax, device='cpu')
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        _same(o, r)
    assert ref[1].mean() > 0.5


@pytest.mark.parametrize('kw', [dict(census_win=7), dict(census_win=17),
                                dict(tsgm=2)], ids=['win7', 'win17',
                                                    'tsgm2'])
def test_cascade_lax_variants(kw):
    """The cascade at census windows above 5x5 (7 x 7: multi-word
    signatures; 17 x 17: the 16-bit cost and K2's 16-bit source) and with
    ``tsgm=2`` (the MGM wavefront per level, which raised before), against
    the JAX package's jitted runs: the single pair at the windows (its
    ``tsgm=2`` case is ``test_torch_mgm_single.py``'s), a 2-tile batch
    with ``tsgm=2`` (the port runs one body for both)."""
    v = dict(median_order='none', **kw)
    im1, im2 = _nan_pair(40, 56, 3.0, seed=8)
    if 'tsgm' not in kw:
        ref = mf.mgm_multi_match(im1, im2, -2, 9, mf.MgmVariant(**v),
                                 scales=3)
        ours = tf.mgm_multi_match(im1, im2, -2, 9, tf.MgmVariant(**v),
                                  scales=3, device='cpu')
        for o, r in zip(ours, ref):
            _same(o.numpy(), r)
        assert np.isfinite(np.asarray(ref[0])).mean() > 0.3
        return
    b1 = np.stack([im1, np.roll(im1, 2, axis=0)])
    b2 = np.stack([im2, np.roll(im2, 2, axis=0)])
    args = (b1, b2, [-2, -4], 16, [40, 40], [56, 56], [56, 50], [12, 16])
    ref = mf.mgm_multi_match_batch(
        *(jnp.asarray(a) for a in args[:3]), args[3],
        *(jnp.asarray(a) for a in args[4:]), variant=mf.MgmVariant(**v),
        scales=3)
    ours = tf.mgm_multi_match_batch(*args, variant=tf.MgmVariant(**v),
                                    scales=3, device='cpu')
    for k in ('disp', 'confidence'):
        _same(ours[k].numpy(), ref[k])


def test_compute_disparity_map_runs_the_rest():
    """``hirschmuller02``, ``tvl1`` and ``msmw``, which raised before they
    were ported, equal the JAX package's on one pair by the criteria of
    ``test_torch_msmw.py`` and ``test_torch_tvl1.py``; ``micmac`` and an
    unknown name raise with the JAX package's messages; ``sgbm`` equals
    the JAX package's bitwise."""
    from test_torch_msmw import check_msmw
    from test_torch_tvl1 import check_tvl1

    rng = np.random.RandomState(6)
    im2 = (rng.rand(24, 40) * 200).astype(np.float32)
    im1 = np.roll(im2, 2, axis=1)
    for algo, check in (('hirschmuller02', check_msmw), ('msmw', check_msmw),
                        ('tvl1', check_tvl1)):
        ref = jm.compute_disparity_map(JConfig(matching_algorithm=algo),
                                       im1, im2, -4, 4)
        ours = tm.compute_disparity_map(
            state.config_from_state({'matching_algorithm': algo}), im1, im2,
            -4, 4, device='cpu')
        assert ours[2] is None and ref[2] is None
        check((ours[0], ours[1] == 1), (ref[0], ref[1] == 1), algo)
    for algo, match in (('micmac', 'MicMac'),
                        ('sgm', 'unknown matching algorithm')):
        with pytest.raises(NotImplementedError, match=match):
            jm.compute_disparity_map(JConfig(matching_algorithm=algo), im1,
                                     im2, -4, 4)
        with pytest.raises(NotImplementedError, match=match):
            tm.compute_disparity_map(
                state.config_from_state({'matching_algorithm': algo}), im1,
                im2, -4, 4, device='cpu')
    ref = jm.compute_disparity_map(JConfig(matching_algorithm='sgbm'), im1,
                                   im2, -4, 4)
    ours = tm.compute_disparity_map(
        state.config_from_state({'matching_algorithm': 'sgbm'}), im1, im2,
        -4, 4, device='cpu')
    _same(ours[0], ref[0])
    _same(ours[1], ref[1])
    assert ours[2] is None and ref[2] is None


# --------------------------------------------------------------------- #
# stage 4's drivers
# --------------------------------------------------------------------- #

# (h, w, shift, dmin, dmax): one bucket of (64, 128, 16) for the batch
_TILE_SPECS = [(58, 90, 3.0, -3, 9), (64, 96, -2.0, -6, 5),
               (50, 80, 4.0, 0, 12)]


def _tile_tree(root):
    """Rectified pairs of one shape a tile (as stage 3 writes them),
    written with the JAX package's writer."""
    tiles = []
    for k, (h, w, d, dmin, dmax) in enumerate(_TILE_SPECS):
        ref, sec = _pair(h, w, d, seed=20 + k)
        ref[:4] = np.nan
        sec[:, -5:] = np.nan
        pair = os.path.join(root, f'tile_{k}', 'pair_1')
        os.makedirs(pair)
        jgeotiff.write(os.path.join(pair, 'rectified_ref.tif'), ref,
                       nodata=float('nan'))
        jgeotiff.write(os.path.join(pair, 'rectified_sec.tif'), sec,
                       nodata=float('nan'))
        np.savetxt(os.path.join(pair, 'disp_min_max.txt'), [dmin, dmax])
        tiles.append(({'dir': os.path.dirname(pair)}, 1))
    return tiles


@pytest.mark.parametrize('algo', ['mgm_multi', 'mgm_multi_lsd'])
def test_stereo_matching_all_matches_jax(tmp_path, monkeypatch, algo):
    """``mgm_multi`` through the batch (never the per-tile route, as the
    JAX package pins), ``mgm_multi_lsd`` tile by tile; the TIFFs equal
    the JAX drivers' byte for byte, the masks pixel for pixel."""
    jroot, troot = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    jtiles, ttiles = _tile_tree(jroot), _tile_tree(troot)
    jcfg = JConfig(out_dir=str(tmp_path), matching_algorithm=algo)
    jpipe.stereo_matching_all(jcfg, jtiles)
    per_tile = []
    if algo == 'mgm_multi':
        monkeypatch.setattr(tpipe, 'stereo_matching',
                            lambda *a, **k: per_tile.append(a))
    tpipe.stereo_matching_all(state.config_from_state(jcfg.to_dict()),
                              ttiles, device='cpu')
    assert not per_tile
    for (jt, _), (tt, _) in zip(jtiles, ttiles):
        for name in _OUTPUTS:
            jp = os.path.join(jt['dir'], 'pair_1', name)
            tp = os.path.join(tt['dir'], 'pair_1', name)
            if name.endswith('.png'):
                readers = (jgeotiff.read_png, tgeotiff.read_png)
            else:
                readers = (jgeotiff.read, tgeotiff.read)
            ref = readers[0](jp)
            for read in readers:
                _same(read(tp), ref)
            if name.endswith('.tif'):
                # the PNG writers compress differently: pixels above
                with open(jp, 'rb') as f, open(tp, 'rb') as g:
                    assert f.read() == g.read(), name
        disp = tgeotiff.read(os.path.join(tt['dir'], 'pair_1', _OUTPUTS[0]))
        assert np.isfinite(disp).mean() > 0.5


def test_per_tile_route_bounds_a_hung_tile(tmp_path, monkeypatch, hang):
    tiles = _hang_tiles(tmp_path)
    monkeypatch.setattr(tpipe, 'stereo_matching',
                        lambda cfg, tile, i, device=None: hang(tile['key']))
    cfg = state.config_from_state({'matching_algorithm': 'mgm_multi_lsd'})
    _raises_in_time(lambda: tpipe.stereo_matching_all(
        cfg, [(t, 1) for t in tiles], timeout=1, device='cpu'))
