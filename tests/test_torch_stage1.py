"""The port's stage 1 (``pipeline.pointing_correction_all``, device="cpu")
against the JAX package's, run on its device SIFT route on the CPU.

The scene: image 1 is seeded smoothed noise; image 2 shows, at each
pixel, the ground point at H0 that camera 2 sees POINTING px above it,
as camera 1 sees it (the cameras of ``test_torch_triangulation.py``,
which share their rows' polynomials).  So the true pointing correction
of every tile is a translation of -POINTING px in y.  Two tiles of
200 x 200 px; ``rpc_alt_range_scale_factor`` narrows the cameras' coarse
altitude range to 400-600 m, so the secondary crops stay small.

``pointing.txt`` must equal the JAX package's byte for byte (measured:
equal, -0.700 in y).  The matches follow from keypoints that meet
``test_torch_sift.py``'s set criterion, so ``sift_matches.txt`` is held
to a set criterion too: at least MATCH_SHARE of the port's matches lie
within MATCH_TOL px, in all four coordinates, of a row of the JAX
package's file, and the counts differ by at most COUNT_SHARE (measured,
as ``pytest -s`` prints:
99.8% and 100% within 0.01 px, 92% of the rows equal as printed; 1,630
against 1,629 and 1,614 against 1,615 rows).  ``center_keypts_sec.txt``,
the mean of the secondary points, is held within CENTER_TOL px: one
match that differs moves a mean of 1,600 matches by that much (measured
0.093 and 0.030 px).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from s2p_tpu import pipeline as jpipe
from s2p_tpu.config import Config as JConfig
from s2p_tpu.config import ImageSpec as JImageSpec
from s2p_tpu.core import pointing as jpoint
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu.ops import sift as jsift
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch.core import pointing as tpoint
from s2p_tpu_torch.core import rpc_geom as tgeom
from s2p_tpu_torch.core import estimation as test_
from s2p_tpu_torch.ops import sift as tsift

from test_torch_triangulation import cameras
from test_torch_sift import one_thread  # noqa: F401 (autouse fixture)

H0 = 500.0
POINTING = 0.7
SHAPE = (420, 700)
ROI = (150, 110, 400, 200)
TILE = 200
FILES = ('pointing.txt', 'sift_matches.txt', 'center_keypts_sec.txt')
MATCH_SHARE = 0.99
MATCH_TOL = 0.01
COUNT_SHARE = 0.01
CENTER_TOL = 0.5


def _render(root, t1, t2):
    """The two images and the tiles (no stage-1 files yet)."""
    rng = np.random.RandomState(7)
    h, w = SHAPE
    img1 = ndimage.gaussian_filter(rng.rand(h, w) * 255, 1.5) \
        .astype(np.float32)
    step = 8
    gy, gx = np.mgrid[0:h + step:step, 0:w + step:step].astype(np.float64)
    lon, lat = t2.localization(gx.ravel(), gy.ravel() - POINTING, H0)
    c1, r1 = t1.projection(lon, lat, H0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) / step
    cmap = ndimage.map_coordinates(c1.reshape(gx.shape), [yy, xx], order=1)
    rmap = ndimage.map_coordinates(r1.reshape(gx.shape), [yy, xx], order=1)
    img2 = ndimage.map_coordinates(img1, [rmap, cmap], order=3,
                                   mode='nearest').astype(np.float32)
    os.makedirs(root)
    paths = [os.path.join(root, f'img_{k}.tif') for k in (1, 2)]
    for path, img in zip(paths, (img1, img2)):
        jgeotiff.write(path, img)
    rx, ry, rw, _ = ROI
    tiles = []
    for x in range(rx, rx + rw, TILE):
        d = os.path.join(root, 'tiles', f'col_{x:07d}')
        os.makedirs(os.path.join(d, 'pair_1'))
        tiles.append({'dir': d, 'coordinates': (x, ry, TILE, TILE),
                      'neighborhood_dirs': []})
    return paths, tiles


def _configs(root, paths, **kw):
    j1, j2, _, _ = cameras(same_rows=True)
    jcfg = JConfig(images=(JImageSpec(img=paths[0], rpcm=j1),
                           JImageSpec(img=paths[1], rpcm=j2)),
                   out_dir=root, rpc_alt_range_scale_factor=0.2, **kw)
    d = jcfg.to_dict()
    for img, j in zip(d['images'], (j1, j2)):
        img['rpcm'] = dataclasses.asdict(j)
    return jcfg, state.config_from_state(d)


def _copy(src, dst, paths, tiles):
    shutil.copytree(src, dst)
    return ([p.replace(src, dst) for p in paths],
            [dict(t, dir=t['dir'].replace(src, dst)) for t in tiles])


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    """The scene under ``base``, then stage 1 of both packages on copies
    of it: {'jax': tiles, 'torch': tiles, 'base': (root, paths, tiles)}."""
    _, _, t1, t2 = cameras(same_rows=True)
    root = tmp_path_factory.mktemp('stage1')
    base = str(root / 'base')
    paths, tiles = _render(base, t1, t2)
    runs = {'base': (base, paths, tiles)}
    for name in ('jax', 'torch'):
        ps, ts = _copy(base, str(root / name), paths, tiles)
        jcfg, tcfg = _configs(str(root / name), ps)
        pairs = [(t, 1) for t in ts]
        if name == 'jax':
            jsift.set_device_mode('device')
            try:
                jpipe.pointing_correction_all(jcfg, pairs)
            finally:
                jsift.set_device_mode('auto')
        else:
            tpipe.pointing_correction_all(tcfg, pairs, device='cpu')
        runs[name] = ts
    return runs


def _load(tile, name):
    return np.loadtxt(os.path.join(tile['dir'], 'pair_1', name))


def test_pointing_txt_equal_byte_for_byte(scene):
    for a, b in zip(scene['torch'], scene['jax']):
        p = os.path.join('pair_1', 'pointing.txt')
        assert _read(os.path.join(a['dir'], p)) == \
            _read(os.path.join(b['dir'], p))


def test_pointing_recovers_the_rendered_error(scene):
    for t in scene['torch']:
        A = _load(t, 'pointing.txt')
        assert np.array_equal(A[:2, :2], np.eye(2))
        assert abs(A[1, 2] + POINTING) < 0.1 and abs(A[0, 2]) < 0.1


def test_matches_set_criterion(scene):
    for a, b in zip(scene['torch'], scene['jax']):
        got, want = _load(a, 'sift_matches.txt'), _load(b, 'sift_matches.txt')
        assert abs(len(got) - len(want)) <= COUNT_SHARE * len(want)
        assert len(got) > 500
        d, _ = cKDTree(want).query(got, k=1, p=np.inf)
        c_got, c_want = (_load(t, 'center_keypts_sec.txt') for t in (a, b))
        print(f'{len(got)} matches against {len(want)}: '
              f'{(d <= MATCH_TOL).mean()} within {MATCH_TOL} px, '
              f'{(d == 0).mean()} equal; centre within '
              f'{np.abs(c_got - c_want).max()} px')
        assert (d <= MATCH_TOL).mean() >= MATCH_SHARE
        assert np.abs(c_got - c_want).max() <= CENTER_TOL


def test_error_vectors_and_local_translation_bitwise(scene):
    """On the JAX package's matches of each tile."""
    j1, j2, t1, t2 = cameras(same_rows=True)
    kw = dict(rpc_alt_range_scale_factor=0.2)
    for t in scene['jax']:
        m = _load(t, 'sift_matches.txt')
        x, y, w, h = t['coordinates']
        F = test_.affine_fundamental_matrix(
            tgeom.matches_from_rpc(t1, t2, x, y, w, h, 5, **kw))
        for ind in ('ref', 'sec'):
            assert np.array_equal(tpoint.error_vectors(m, F, ind),
                                  jpoint.error_vectors(m, F, ind))
        got = tpoint.local_translation(t1, t2, x, y, w, h, m, 5, **kw)
        want = jpoint.local_translation(j1, j2, x, y, w, h, m, 5, **kw)
        assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        tpoint.error_vectors(m, F, 'both')


def test_single_tile_equals_the_batch(scene, tmp_path):
    """pointing_correction of one tile writes the batch's files."""
    base, paths, tiles = scene['base']
    ps, ts = _copy(base, str(tmp_path / 'one'), paths, tiles)
    _, tcfg = _configs(str(tmp_path / 'one'), ps)
    tpipe.pointing_correction(tcfg, ts[1], 1, device='cpu')
    for name in FILES:
        p = os.path.join('pair_1', name)
        assert _read(os.path.join(ts[1]['dir'], p)) == \
            _read(os.path.join(scene['torch'][1]['dir'], p))
    assert not os.path.exists(os.path.join(ts[0]['dir'], 'pair_1',
                                           'pointing.txt'))


def test_host_route_equals_jax_and_cuda_default_raises(scene, tmp_path,
                                                       monkeypatch):
    """SIFT's host route ('host', which raised before it was ported) on
    both packages, tile by tile: the three files of every tile byte for
    byte; then the CUDA default raises without CUDA."""
    base, paths, tiles = scene['base']
    runs = {}
    for name in ('jax', 'torch'):
        ps, ts = _copy(base, str(tmp_path / name), paths, tiles)
        jcfg, tcfg = _configs(str(tmp_path / name), ps, sift_device='host')
        jsift.set_device_mode('host')
        tsift.set_device_mode('host')
        try:
            if name == 'jax':
                jpipe.pointing_correction_all(jcfg, [(t, 1) for t in ts])
            else:
                tpipe.pointing_correction_all(tcfg, [(t, 1) for t in ts],
                                              device='cpu')
        finally:
            jsift.set_device_mode('auto')
            tsift.set_device_mode('auto')
        runs[name] = ts
    for a, b in zip(runs['torch'], runs['jax']):
        for name in FILES:
            p = os.path.join('pair_1', name)
            assert _read(os.path.join(a['dir'], p)) == \
                _read(os.path.join(b['dir'], p)), name
    A = _load(runs['torch'][0], 'pointing.txt')
    assert abs(A[1, 2] + POINTING) < 0.1
    _, tcfg = _configs(base, paths)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tpipe.pointing_correction_all(tcfg, [(tiles[0], 1)])
    for name in FILES:
        assert not os.path.exists(os.path.join(tiles[0]['dir'], 'pair_1',
                                               name))
