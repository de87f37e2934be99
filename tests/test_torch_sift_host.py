"""SIFT's host route (``sift_device='host'``: ``ops/sift_host.py`` and the
host branches of ``ops/sift.py``) and ASIFT (``ops/asift.py``) against
the JAX package's, both on their host routes.

The host route is numpy and scipy in both packages, the same code, so
every comparison is bitwise: the keypoints (detection, refinement,
orientations, descriptors), the match's host distances with and without
the epipolar gate, the per-pair flow ``_matches_on_rpc_roi_independent``
on the rendered scene of ``test_torch_stage1.py``, and ASIFT's simulated
views and mapped-back keypoints.  Stage 1's files with 'host' are
``test_torch_stage1.py``'s.
"""

import numpy as np
import pytest
from scipy import ndimage

from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu.ops import asift as jasift
from s2p_tpu.ops import sift as jsift
from s2p_tpu_torch.ops import asift as tasift
from s2p_tpu_torch.ops import sift as tsift
from s2p_tpu_torch.ops import sift_host

from test_torch_sift import one_thread  # noqa: F401 (autouse fixture)
from test_torch_stage1 import ROI, TILE, _render, cameras


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    assert (a.view(np.uint8) == b.view(np.uint8)).all()


@pytest.fixture
def host():
    """Both packages on their host routes, restored afterwards."""
    jsift.set_device_mode('host')
    tsift.set_device_mode('host')
    yield
    jsift.set_device_mode('auto')
    tsift.set_device_mode('auto')


@pytest.fixture(scope='module')
def image():
    rng = np.random.RandomState(0)
    img = ndimage.gaussian_filter(rng.rand(150, 170) * 255, 1.5)
    return img.astype(np.float32)


def test_mode_switch():
    assert tsift._use_device_sift()              # 'auto' is the card
    for mode, dev in (('host', False), ('device', True), ('auto', True)):
        tsift.set_device_mode(mode)
        assert tsift._use_device_sift() is dev
    with pytest.raises(ValueError):
        tsift.set_device_mode('tpu')


def test_keypoints_bitwise(host, image):
    """``image_keypoints`` over a clipped ROI (its offset added), and
    ``keypoints_from_array`` at a halved DoG threshold."""
    ref = jsift.image_keypoints(image, -5, 10, 120, 200)
    ours = tsift.image_keypoints(image, -5, 10, 120, 200)
    assert len(ref) > 50
    _same(ours, ref)
    crop = image[20:110, 30:140]
    _same(tsift.keypoints_from_array(crop, 0.0133 / 2),
          jsift.keypoints_from_array(crop, 0.0133 / 2))
    _same(sift_host.keypoints_from_array(crop, 0.0133 / 2),
          tsift.keypoints_from_array(crop, 0.0133 / 2))


def test_scale_space_and_stages_bitwise(image):
    """The pyramid's octaves and the extrema of the first one."""
    ours = sift_host._build_scale_space(image, 8, 3)
    ref = jsift._build_scale_space(image, 8, 3)
    assert len(ours) == len(ref)
    for (g, dog, delta), (gr, dogr, deltar) in zip(ours, ref):
        _same(g, gr)
        _same(dog, dogr)
        assert delta == deltar
    _same(sift_host._extrema_mask(ours[0][1]), jsift._extrema_mask(ref[0][1]))


def test_keypoints_match_host_branch(host, image):
    """The host distances, ungated and gated by an affine F, with and
    without RANSAC, the ratio and absolute tests."""
    k1 = jsift.image_keypoints(image, 0, 0, 120, 130)
    k2 = jsift.image_keypoints(image, 8, 3, 120, 130)
    F = np.array([[0, 0, 0.02], [0, 0, -1.0], [-0.02, 1.0, -2.5]])
    for kw in (dict(), dict(F=F, epipolar_threshold=4),
               dict(method='absolute', sift_thresh=250.0, F=F),
               dict(F=F, model='fundamental')):
        ref = jsift.keypoints_match(k1, k2, **kw)
        ours = tsift.keypoints_match(k1, k2, **kw)
        assert len(ref) > 10, kw
        _same(ours, ref)
    _same(tsift.keypoints_match(k1[:0], k2), jsift.keypoints_match(k1[:0],
                                                                   k2))


def test_matches_on_rpc_roi_independent(host, tmp_path, monkeypatch):
    """The per-pair flow on a 100 x 100 window of the rendered scene (RPC
    cameras, corresponding ROI, affine-F gate, RANSAC): the same matches;
    and ``matches_on_rpc_roi`` takes it on the host route."""
    j1, j2, t1, t2 = cameras(same_rows=True)
    paths, _ = _render(str(tmp_path / 'scene'), t1, t2)
    im1, im2 = (jgeotiff.read(p).astype(np.float32) for p in paths)
    x, y, w = ROI[0] + 50, ROI[1] + 50, TILE // 2
    kw = dict(rpc_alt_range_scale_factor=0.2)
    ref = jsift._matches_on_rpc_roi_independent(
        im1, im2, j1, j2, x, y, w, w, 'relative', 0.6, 10, **kw)
    ours = tsift._matches_on_rpc_roi_independent(
        im1, im2, t1, t2, x, y, w, w, 'relative', 0.6, 10, **kw)
    assert len(ref) > 50
    _same(ours, ref)
    calls = []
    monkeypatch.setattr(tsift, '_matches_on_rpc_roi_independent',
                        lambda *a, **k: calls.append(a) or ours)
    _same(tsift.matches_on_rpc_roi(im1, im2, t1, t2, x, y, w, w, **kw), ref)
    assert len(calls) == 1


def test_asift_keypoints_bitwise(host, image):
    crop = image[:90, :100]
    for t, phi in ((2.0, 0.0), (2 ** 0.5, 50.9)):
        for o, r in zip(tasift._simulate(crop, t, phi),
                        jasift._simulate(crop, t, phi)):
            _same(o, r)
    ref = jasift.keypoints(crop, n_tilts=2)
    ours = tasift.keypoints(crop, n_tilts=2)
    assert len(ref) > len(jsift.keypoints_from_array(crop))
    _same(ours, ref)
