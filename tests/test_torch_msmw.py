"""The port's msmw matchers (``ops/msmw.py``, device="cpu") against the
JAX package's: the box sums, ``_scale_step``, ``disparity``,
``compute_disparity_map`` for ``msmw``, ``msmw2``, ``msmw3`` and
``hirschmuller02`` (the LoG prefilter) and stage 4's per-tile route.

The window means.  The JAX package's ``_box`` differences two
``jnp.cumsum`` prefix sums (XLA's CPU order of summation); the port sums
each window directly, in one order that its card and its CPU share.
Where every prefix sum is an integer below 2^24 (an image of integers
from 0 to 15 at these sizes) the orders agree and the port equals the
JAX package's jitted ``_scale_step`` bit for bit.  Elsewhere (the
pyramid's blurred levels, real images) the prefix sums round, so
``disparity`` is held to a criterion: the validity masks agree on at
least VALID_SHARE of the pixels and the disparities of pixels valid in
both lie within DISP_TOL px (measured: masks equal, disparities within
1.2e-4 px at 96 x 128 and 128 x 160; ``pytest -s`` prints the figures).

The JAX package compiles one ``_scale_step`` per shape and range, so the
cases share one pair shape and range.
"""

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
from s2p_tpu.ops import msmw as jmsmw
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch.core import matching as tm
from s2p_tpu_torch.geo import geotiff as tgeotiff
from s2p_tpu_torch.ops import msmw as tmsmw

from test_torch_sift import one_thread  # noqa: F401 (autouse fixture)

VALID_SHARE = 0.995
DISP_TOL = 1e-3

SHAPE = (48, 64)
RANGE = (-7, 9)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def pair(shape=SHAPE, shift=4, seed=0, integer=False):
    """The JAX package's msmw test pair (a sine texture with noise and its
    copy shifted by ``shift`` px), or an integer texture from 0 to 15;
    NaN over a corner block of the reference."""
    h, w = shape
    rng = np.random.RandomState(seed)
    if integer:
        im1 = rng.randint(0, 16, (h, w)).astype(np.float32)
        im2 = np.roll(im1, shift, axis=1)
        im2[:, :shift] = rng.randint(0, 16, (h, shift))
    else:
        xs = np.arange(w)[None, :]
        ys = np.arange(h)[:, None]
        im1 = (rng.rand(h, w) * 50 + np.sin(xs / 5.0) * 30
               + np.cos(ys / 7.0) * 20).astype(np.float32)
        im2 = (np.roll(im1, shift, axis=1)
               + 0.2 * rng.rand(h, w).astype(np.float32))
    im1[:3, :4] = np.nan
    return im1.astype(np.float32), im2.astype(np.float32)


def check_msmw(ours, ref, what=''):
    """The criterion of the module docstring on (disp, valid) pairs."""
    (d, v), (dr, vr) = ours, ref
    agree = (v == vr).mean()
    both = v & vr
    err = float(np.abs(d[both] - dr[both]).max()) if both.any() else 0.0
    print(f'msmw {what}: masks agree on {agree}, valid {vr.mean():.3f}, '
          f'max |disp error| {err}')
    assert agree >= VALID_SHARE
    assert err <= DISP_TOL
    assert vr.mean() > 0.3


@pytest.mark.parametrize('ry,rx', [(4, 4), (1, 4), (4, 1)])
def test_box_equals_the_prefix_sums_on_integers(ry, rx):
    """B1's plain version against ``_box`` where the prefix sums are
    exact: bitwise, a 2-D image and a (D, h, w) volume."""
    rng = np.random.RandomState(ry * 7 + rx)
    for shape in ((21, 30), (3, 17, 26)):
        a = rng.randint(0, 200, shape).astype(np.float32)
        ref = jax.jit(jmsmw._box, static_argnums=(1, 2))(jnp.asarray(a), ry,
                                                         rx)
        _same(tmsmw._box(torch.from_numpy(a), ry, rx).numpy(), ref)


def test_box_sum_plain_order():
    """The plain version adds a window from +0 in order along either axis
    and scales last: sums whose rounding depends on the order show it."""
    x = np.array([1e8, 1.0, -1e8, 1.0, 3.0], np.float32)
    pad = np.concatenate([[0], x, [0]]).astype(np.float32)
    want = []
    for i in range(len(x)):
        s = np.float32(0)
        for t in range(3):
            s = np.float32(s + pad[i + t])
        want.append(np.float32(s * np.float32(0.5)))
    want = np.array(want, np.float32)
    t = torch.from_numpy(x)
    _same(tmsmw.box_sum_plain(t[None, None], 1, False, 0.5)[0, 0].numpy(),
          want)
    _same(tmsmw.box_sum_plain(t[None, :, None], 1, True, 0.5)[0, :, 0]
          .numpy(), want)
    a = torch.zeros((4, 5))
    b = torch.zeros((2, 4, 5))
    f = torch.ones((2, 4, 5), dtype=torch.bool)
    with pytest.raises(TypeError):
        tmsmw._window_costs(a.double(), b, f)


def window_means_direct(v, ry, rx, sgn, scale):
    """The window means of a (D, h, w) float32 volume as B1 addresses
    them, by index in the original frame: the vertical sums of 2ry + 1
    rows along the sheared columns (row y + dy at column (c - dy sgn) mod
    w; rows outside are 0), then the horizontal sums of output (y, x) over
    columns (x + dx) mod w, where a term whose sheared column X + dx, X =
    (x + s_y) mod w and s_y = (y - h // 2) sgn, leaves [0, w) is 0.  sgn
    0 is the box window (no shear: the padding is the image's edge)."""
    D, h, w = v.shape
    f32 = np.float32
    ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
    vert = np.zeros_like(v)
    for dy in range(-ry, ry + 1):
        rows = ys + dy
        inside = (rows >= 0) & (rows < h)
        cols = (xs - dy * sgn) % w
        term = v[:, np.clip(rows, 0, h - 1), cols]
        vert = (vert + np.where(inside[None], term, f32(0))).astype(f32)
    X = (xs + (ys - h // 2) * sgn) % w
    out = np.zeros_like(v)
    for dx in range(-rx, rx + 1):
        inside = (X + dx >= 0) & (X + dx < w)
        term = vert[:, ys, (xs + dx) % w]
        out = (out + np.where(inside[None], term, f32(0))).astype(f32)
    return (out * f32(scale)).astype(f32)


WINDOW_SHAPES = ((1, 1), (1, 5), (5, 1), (8, 9), (9, 8), (10, 13), (7, 3),
                 (20, 21))


@pytest.mark.parametrize('sgn', [1, -1, 0])
@pytest.mark.parametrize('shape', WINDOW_SHAPES)
def test_window_addressing(shape, sgn):
    """B1's addressing of the diagonal windows (the shear's circular
    columns, the padding in the sheared frame) and of the box windows,
    against the plain composition of ``_shear`` and ``_box``: bitwise,
    on sums whose rounding depends on the order."""
    h, w = shape
    rng = np.random.RandomState(h * 31 + w + sgn)
    v = (rng.randn(2, h, w) * 1e3).astype(np.float32)
    v.flat[::5] = np.float32(1e7)
    t = torch.from_numpy(v)
    for ry, rx in ((1, 4), (4, 4), (4, 1)):
        scale = tmsmw._recip_area(ry, rx)
        if sgn:
            want = tmsmw._shear(tmsmw._box(tmsmw._shear(t, sgn), ry, rx),
                                -sgn)
        else:
            want = tmsmw._box(t, ry, rx)
        _same(window_means_direct(v, ry, rx, sgn, scale), want.numpy())


@pytest.mark.parametrize('shape,D', [((12, 17), 3), ((9, 9), 1),
                                     ((5, 7), 2), ((21, 30), 4)])
def test_window_costs_bitwise(shape, D):
    """``_window_costs`` on CPU tensors equals ``_window_costs_plain`` and
    the JAX package's jitted ``_window_costs`` (its (h, w, D) layout moved
    to (D, h, w)) bit for bit on integer images, the variance too; a uint8
    mask gives the bool mask's result."""
    h, w = shape
    rng = np.random.RandomState(h * w + D)
    a = rng.randint(0, 16, (h, w)).astype(np.float32)
    b = rng.randint(0, 16, (D, h, w)).astype(np.float32)
    fin = rng.rand(D, h, w) > 0.25
    fin[0, :2] = False
    ta, tb, tf = (torch.from_numpy(x) for x in (a, b, fin))
    tmsmw.reset_launch_counts()
    best, var9 = tmsmw._window_costs(ta, tb, tf, need_var=True)
    assert tmsmw.launch_counts() == {'window_costs': 0}
    pbest, pvar9 = tmsmw._window_costs_plain(ta, tb, tf, need_var=True)
    _same(best.numpy(), pbest.numpy())
    _same(var9.numpy(), pvar9.numpy())
    jbest, jvar9 = jax.jit(jmsmw._window_costs)(
        jnp.asarray(a), jnp.asarray(np.moveaxis(b, 0, -1)),
        jnp.asarray(np.moveaxis(fin, 0, -1)))
    _same(best.numpy(), np.moveaxis(np.asarray(jbest), -1, 0))
    _same(var9.numpy(), jvar9)
    best8, none = tmsmw._window_costs(ta, tb, tf.to(torch.uint8))
    assert none is None
    _same(best8.numpy(), best.numpy())


def test_window_costs_contract():
    """A CPU call launches nothing; a wrong dtype or rank raises
    TypeError, mismatched shapes or another device ValueError."""
    a = torch.zeros((6, 7))
    b = torch.zeros((2, 6, 7))
    f = torch.ones((2, 6, 7), dtype=torch.bool)
    tmsmw.reset_launch_counts()
    tmsmw._window_costs(a, b, f)
    assert tmsmw.launch_counts() == {'window_costs': 0}
    for args in ((a, b.double(), f), (a, b, f.float()), (a[None], b, f),
                 (a, b[0], f), (a, b, f[0])):
        with pytest.raises(TypeError):
            tmsmw._window_costs(*args)
    with pytest.raises(ValueError):
        tmsmw._window_costs(a[:5], b, f)
    with pytest.raises(ValueError):
        tmsmw._window_costs(*(t.to('meta') for t in (a, b, f)))


def test_window_costs_work_counts_the_windows():
    """``window_costs_work`` against an enumeration of every window's
    terms at a small shape: a sum of n terms inside the image is n - 1
    adds."""
    D, h, w = 3, 6, 11
    nbytes, ops = tmsmw.window_costs_work(D, h, w)
    ones = np.ones((1, h, w), np.float32)
    terms = 0
    for ry, rx, sgn in ((4, 4, 0), (1, 4, 0), (4, 1, 0), (1, 4, 1),
                        (1, 4, -1)):
        # the horizontal terms: the count of vertical sums summed
        cnt = window_means_direct(ones, 0, rx, sgn, 1.0)
        terms += int((cnt - 1).sum())
    for ry in (4, 1, 1, 1):
        cnt = window_means_direct(ones, ry, 0, 0, 1.0)
        terms += int((cnt - 1).sum())
    assert ops == D * h * w * (5 + 5 * 9 + 4) + D * 3 * (terms
                                                          + 5 * h * w)
    assert nbytes == 4 * h * w + 9 * D * h * w


def test_scale_step_bitwise_on_integer_images():
    """One level, both directions, the range maps, the self-similarity
    test, the variance test of ``min_dist``, the reciprocity."""
    min_dist = 0.5
    im1, im2 = pair(integer=True, shift=3)
    h, w = SHAPE
    lo = np.full((h, w), RANGE[0] - 1, np.float32)
    hi = np.full((h, w), RANGE[1] + 1, np.float32)
    lo[10:20, 5:30] = 1.0                     # a per-pixel restriction
    dmin, D = RANGE[0] - 1, 24
    ref = jmsmw._scale_step(*(jnp.asarray(v) for v in
                              (im1, im2, lo, hi, -hi, -lo)), dmin, D,
                            self_sim=True, min_dist=min_dist)
    ours = tmsmw._scale_step(*(torch.from_numpy(v) for v in
                               (im1, im2, lo, hi, -hi, -lo)), dmin, D,
                             min_dist=min_dist)
    for o, r in zip(ours, ref):
        _same(o.numpy(), r)
    assert 0.3 < np.asarray(ref[2]).mean() < 1


@pytest.fixture(scope='module')
def jax_disparity():
    im1, im2 = pair()
    return (im1, im2), jmsmw.disparity(im1, im2, *RANGE)


def test_disparity_within_the_criterion(jax_disparity):
    (im1, im2), ref = jax_disparity
    ours = tmsmw.disparity(im1, im2, *RANGE, device='cpu')
    assert ours[0].dtype == np.float32 and ours[1].dtype == bool
    check_msmw(ours, ref, 'disparity')
    good = ours[1] & np.isfinite(ours[0])
    assert abs(np.median(ours[0][good]) - 4.0) < 0.25


def test_host_helpers_equal():
    """The range maps, their upsampling, the pyramid's subsampling and
    the grain filter: the JAX package's host code, bitwise."""
    rng = np.random.RandomState(3)
    d = (rng.rand(20, 26) * 10 - 5).astype(np.float32)
    ok = rng.rand(20, 26) > 0.3
    for a, b in zip(tmsmw._update_range_maps(d, ok, -6.0, 6.0),
                    jmsmw._update_range_maps(d, ok, -6.0, 6.0)):
        _same(a, b)
    lo, hi = jmsmw._update_range_maps(d, ok, -6.0, 6.0)
    for a, b in zip(tmsmw._upsample_range(lo, hi, (40, 51), -13.0, 13.0),
                    jmsmw._upsample_range(lo, hi, (40, 51), -13.0, 13.0)):
        _same(a, b)
    img = pair()[0]
    _same(tmsmw._downsample2(img), jmsmw._downsample2(img))
    _same(tmsmw._grain_filter(ok, 5), jmsmw._grain_filter(ok, 5))


@pytest.mark.parametrize('algo', ['msmw', 'msmw2', 'msmw3',
                                  'hirschmuller02'])
def test_compute_disparity_map(algo):
    """The three msmw names run one engine; hirschmuller02 runs it on the
    LoG-prefiltered pair.  No confidence; the rejection mask."""
    im1, im2 = pair()
    ref = jm.compute_disparity_map(JConfig(matching_algorithm=algo), im1,
                                   im2, *RANGE)
    ours = tm.compute_disparity_map(
        state.config_from_state({'matching_algorithm': algo}), im1, im2,
        *RANGE, device='cpu')
    assert ours[2] is None and ref[2] is None
    assert ours[1].dtype == np.uint8
    check_msmw((ours[0], ours[1] == 1), (ref[0], ref[1] == 1), algo)


def write_tiles(root, algo_pair, specs):
    """Rectified pairs (as stage 3 writes them), with the JAX package's
    writer: ``algo_pair(k)`` gives tile k's (ref, sec), ``specs`` its
    range."""
    tiles = []
    for k, (dmin, dmax) in enumerate(specs):
        ref, sec = algo_pair(k)
        d = os.path.join(root, f'tile_{k}', 'pair_1')
        os.makedirs(d)
        jgeotiff.write(os.path.join(d, 'rectified_ref.tif'), ref,
                       nodata=float('nan'))
        jgeotiff.write(os.path.join(d, 'rectified_sec.tif'), sec,
                       nodata=float('nan'))
        np.savetxt(os.path.join(d, 'disp_min_max.txt'), [dmin, dmax])
        tiles.append(({'dir': os.path.dirname(d)}, 1))
    return tiles


def stage4_against_jax(tmp_path, algo, algo_pair, specs, check):
    """``stereo_matching_all`` of both packages on the same tiles: the
    same file set (no confidence file), the maps by ``check``."""
    jtiles = write_tiles(str(tmp_path / 'jax'), algo_pair, specs)
    ttiles = write_tiles(str(tmp_path / 'torch'), algo_pair, specs)
    jcfg = JConfig(out_dir=str(tmp_path), matching_algorithm=algo)
    jpipe.stereo_matching_all(jcfg, jtiles)
    tpipe.stereo_matching_all(state.config_from_state(jcfg.to_dict()),
                              ttiles, device='cpu')
    for (jt, _), (tt, _) in zip(jtiles, ttiles):
        jd, td = (os.path.join(t['dir'], 'pair_1') for t in (jt, tt))
        assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
        assert 'rectified_disp_confidence.tif' not in os.listdir(td)
        d, dr = (g.read(os.path.join(p, 'rectified_disp.tif'))
                 for g, p in ((tgeotiff, td), (jgeotiff, jd)))
        m, mr = (g.read_png(os.path.join(p, 'rectified_mask.png')) > 0
                 for g, p in ((tgeotiff, td), (jgeotiff, jd)))
        check((d, m), (dr, mr), f'{algo} stage 4')


@pytest.mark.parametrize('algo', ['msmw', 'hirschmuller02'])
def test_stereo_matching_all(tmp_path, algo):
    """Stage 4's per-tile route with the msmw engines."""
    stage4_against_jax(tmp_path, algo, lambda k: pair(seed=k),
                       [RANGE, RANGE], check_msmw)
