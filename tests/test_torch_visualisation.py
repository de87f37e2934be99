"""The port's debug plot of stage 1's matches (``core/visualisation.py``,
numpy, no PIL) against the JAX package's, which PIL's ``ImageDraw``
draws: both PNGs decode to the same pixels, every case.  Then stage 1
writes ``sift_matches_pointing.png`` under ``cfg.debug``, and only then,
on both of SIFT's routes.
"""

import dataclasses
import os
import zlib

import numpy as np
import pytest
from PIL import Image

from s2p_tpu.core import visualisation as jvis
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch.config import Config, ImageSpec
from s2p_tpu_torch.core import visualisation as tvis
from s2p_tpu_torch.geo import geotiff
from test_torch_triangulation import jax_rpc


def _pixels(path):
    return np.array(Image.open(path).convert('RGB'))


def _crops(rng, h1, w1, h2, w2):
    return (rng.randint(0, 256, (h1, w1)).astype(np.uint8),
            rng.randint(0, 256, (h2, w2)).astype(np.uint8))


def _case(name):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    if name == 'float':              # fractional and negative coordinates
        c1, c2 = _crops(rng, 40, 50, 40, 45)
        m = np.column_stack([rng.uniform(-1.5, 50, 9), rng.uniform(-1.5, 40, 9),
                             rng.uniform(-1.5, 45, 9), rng.uniform(-1.5, 40, 9)])
    elif name == 'borders':          # ends on the crops' first and last pixels
        c1, c2 = _crops(rng, 30, 33, 30, 27)
        m = np.array([[0, 0, 0, 0], [32, 29, 26, 29], [0, 29, 26, 0],
                      [32, 0, 0, 29], [32.9, 29.9, 26.9, 29.9],
                      [0.5, 15, 13.5, 0.2], [1, 1, 25, 28], [31, 2, 1, 27]])
    elif name == 'off_canvas':       # ends and ellipses past every edge
        c1, c2 = _crops(rng, 30, 33, 30, 27)
        m = np.array([[-10, -10, 40, 40], [-3, 15, 30, 15], [16, -4, 10, 34],
                      [50, 50, -40, -3], [-1.9, -1.9, 27.5, 31.9],
                      [-200, 5, 300, 20]])
    elif name == 'many':             # more than five: the colours cycle,
        c1, c2 = _crops(rng, 35, 40, 35, 40)     # later lines paint over
        m = np.column_stack([rng.uniform(0, 40, 23), rng.uniform(0, 35, 23),
                             rng.uniform(0, 40, 23), rng.uniform(0, 35, 23)])
        m[::4] = m[0]
    elif name == 'taller_first':
        c1, c2 = _crops(rng, 50, 30, 20, 35)
        m = rng.uniform(-2, 52, (12, 4))
    elif name == 'taller_second':
        c1, c2 = _crops(rng, 18, 30, 44, 25)
        m = rng.uniform(-2, 46, (12, 4))
    elif name == 'none':
        c1, c2 = _crops(rng, 10, 12, 14, 9)
        m = np.zeros((0, 4))
    else:                            # random sizes and matches
        c1, c2 = _crops(rng, *rng.randint(4, 50, 4))
        n = rng.randint(1, 30)
        m = rng.uniform(-8, 60, (n, 4))
        if rng.rand() < 0.5:
            m = np.round(m * 2) / 2
    return c1, c2, m


CASES = ['float', 'borders', 'off_canvas', 'many', 'taller_first',
         'taller_second', 'none'] + [f'random_{k}' for k in range(24)]


@pytest.mark.parametrize('name', CASES)
def test_plot_matches_low_level_equals_pil(tmp_path, name):
    c1, c2, m = _case(name)
    jvis.plot_matches_low_level(c1, c2, m, str(tmp_path / 'jax.png'))
    tvis.plot_matches_low_level(c1, c2, m, str(tmp_path / 'port.png'))
    want = _pixels(tmp_path / 'jax.png')
    got = _pixels(tmp_path / 'port.png')
    assert got.shape == want.shape == (max(len(c1), len(c2)),
                                       c1.shape[1] + c2.shape[1], 3)
    assert np.array_equal(got, want)
    assert np.array_equal(geotiff.read_png(str(tmp_path / 'port.png')), got)
    assert np.array_equal(tvis.draw_matches(c1, c2, m), got)


def _cameras():
    """The synthetic cameras of test_torch_triangulation.py, their image
    centre moved to (100, 100) so that small images hold the ROI."""
    j = [dataclasses.replace(jax_rpc(1, 0.02), col_offset=100.0,
                             row_offset=100.0),
         dataclasses.replace(jax_rpc(2, -0.015), col_offset=100.0,
                             row_offset=100.0)]
    return j, [state.rpc_from_state(dataclasses.asdict(r)) for r in j]


def _images():
    rng = np.random.RandomState(5)
    im1 = rng.rand(300, 400).astype(np.float32) * 1000
    im2 = rng.rand(300, 700).astype(np.float32) * 1000
    im2[:10] = np.nan
    return im1, im2


def test_plot_matches_equals_jax(tmp_path):
    (j1, j2), (t1, t2) = _cameras()
    im1, im2 = _images()
    x, y, w, h = 60, 50, 80, 70
    rng = np.random.RandomState(6)
    m = np.column_stack([rng.uniform(x, x + w, 40), rng.uniform(y, y + h, 40),
                         rng.uniform(x - 150, x + w + 200, 40),
                         rng.uniform(y, y + h, 40)])
    jvis.plot_matches(im1, im2, j1, j2, m, str(tmp_path / 'jax.png'),
                      x, y, w, h)
    tvis.plot_matches(im1, im2, t1, t2, m, str(tmp_path / 'port.png'),
                      x, y, w, h)
    want, got = _pixels(tmp_path / 'jax.png'), _pixels(tmp_path / 'port.png')
    assert got.shape == want.shape and got.shape[0] == h
    assert np.array_equal(got, want)
    # no matches, no file
    tvis.plot_matches(im1, im2, t1, t2, np.zeros((0, 4)),
                      str(tmp_path / 'none.png'), x, y, w, h)
    assert not os.path.exists(tmp_path / 'none.png')


@pytest.mark.parametrize('route', ['device', 'host'])
@pytest.mark.parametrize('debug', [False, True])
def test_stage1_writes_the_plot_under_debug(tmp_path, monkeypatch, route,
                                            debug):
    (j1, j2), (t1, t2) = _cameras()
    im1, im2 = _images()
    images = {'ref.tif': im1, 'sec.tif': im2}
    cfg = Config(images=(ImageSpec(img='ref.tif', rpcm=t1),
                         ImageSpec(img='sec.tif', rpcm=t2)), debug=debug)
    tiles = []
    for k, (x, y) in enumerate(((60, 50), (150, 120))):
        d = tmp_path / f'tile_{k}'
        (d / 'pair_1').mkdir(parents=True)
        tiles.append({'dir': str(d), 'coordinates': (x, y, 80, 70)})
    rng = np.random.RandomState(7)
    m = np.column_stack([rng.uniform(60, 140, 30), rng.uniform(50, 120, 30),
                         rng.uniform(60, 300, 30), rng.uniform(50, 120, 30)])
    monkeypatch.setattr(tpipe, '_image', lambda path: images[path])
    monkeypatch.setattr(tpipe.sift_ops, '_DEVICE_MODE', route)
    monkeypatch.setattr(tpipe.sift_ops, 'matches_on_rpc_roi_batch',
                        lambda jobs, device: [m for _ in jobs])
    monkeypatch.setattr(tpipe.pointing, 'compute_correction',
                        lambda *a, **kw: (np.eye(3), m))
    monkeypatch.setattr(tpipe.pointing, 'local_translation',
                        lambda *a, **kw: np.eye(3))
    tpipe.pointing_correction_all(cfg, [(t, 1) for t in tiles], timeout=60,
                                  nb_workers=2, device='cpu')
    for t in tiles:
        out = os.path.join(t['dir'], 'pair_1')
        assert os.path.exists(os.path.join(out, 'pointing.txt'))
        png = os.path.join(out, 'sift_matches_pointing.png')
        assert os.path.exists(png) == debug
        if debug:
            x, y, w, h = t['coordinates']
            jvis.plot_matches(im1, im2, j1, j2, m, str(tmp_path / 'j.png'),
                              x, y, w, h)
            assert np.array_equal(_pixels(png), _pixels(tmp_path / 'j.png'))
