"""The port's stages 2 and 3 (``pipeline.global_pointing_correction`` and
``pipeline.rectification_all``, device="cpu") against the JAX package's
on one synthetic scene: two small images seen by the synthetic cameras
of ``test_torch_triangulation.py`` (sharing their rows' polynomials, so
the affine epipolar model holds to a fraction of a pixel this far from
their centre), three tiles in a row with their neighbour halos, and the
stage-1 files each tile would hold.

The text files (``global_pointing_pair_1.txt``, ``H_ref.txt``,
``H_sec.txt``, ``disp_min_max.txt``) must be equal byte for byte.  The
rectified images equal the JAX package's run under ``jax.disable_jit()``
bitwise; against its jitted run they agree within WARP_JIT_TOL, with the
same NaN sets away from source coordinates within 1e-4 px of an integer
(``test_torch_interp.py``).
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from s2p_tpu import pipeline as jpipe
from s2p_tpu.config import Config as JConfig
from s2p_tpu.config import ImageSpec as JImageSpec
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch.geo import geotiff as tgeotiff

from test_torch_interp import WARP_JIT_TOL, _near_integer_source
from test_torch_rectification import sift_matches
from test_torch_triangulation import cameras

# three 100 x 120 tiles in a row; the images cover them with room for the
# rectification's margins
ROI = (150, 140, 300, 120)
TILE = (100, 120)
IMG_SHAPE = (420, 640)
TEXT = ('H_ref.txt', 'H_sec.txt', 'disp_min_max.txt')


def _tile_dir(x, y, w, h):
    return os.path.join('tiles', f'row_{y:07d}_height_{h}',
                        f'col_{x:07d}_width_{w}')


def _scene(root, t1, t2):
    """Images, tiles and stage-1 files under ``root``: tile 0 has all
    three files, tile 1 no SIFT matches (its halo supplies them), tile 2
    no pointing.txt (the scene's fit stands in)."""
    os.makedirs(root)
    rng = np.random.RandomState(11)
    paths = []
    for k in (1, 2):
        img = (rng.rand(*IMG_SHAPE) * 200).astype(np.float32)
        img[200:203, 300:310] = np.nan
        paths.append(os.path.join(root, f'img_{k}.tif'))
        jgeotiff.write(paths[-1], img)
    rx, ry, rw, rh = ROI
    tw, th = TILE
    coords = [(x, ry, tw, th) for x in range(rx, rx + rw, tw)]
    tiles = []
    for k, c in enumerate(coords):
        tdir = os.path.join(root, _tile_dir(*c))
        pdir = os.path.join(tdir, 'pair_1')
        os.makedirs(pdir)
        nbrs = [os.path.join('../../..', _tile_dir(*n)) for n in coords
                if abs(n[0] - c[0]) <= tw]
        m = sift_matches(t1, t2, c, n=30, seed=20 + k, noise=0.02)
        m[:, 3] += 0.4                 # a pointing error of 0.4 px in y
        if k != 1:
            np.savetxt(os.path.join(pdir, 'sift_matches.txt'), m,
                       fmt='%9.3f')
        if k != 2:
            A = np.array([[1, 0, 0.01 * k], [0, 1, -0.4], [0, 0, 1]])
            np.savetxt(os.path.join(pdir, 'pointing.txt'), A, fmt='%6.3f')
            np.savetxt(os.path.join(pdir, 'center_keypts_sec.txt'),
                       np.mean(m[:, 2:], 0), fmt='%9.3f')
        tiles.append({'dir': tdir, 'coordinates': c,
                      'neighborhood_dirs': nbrs})
    return paths, tiles


def _configs(root, paths, clean=False):
    j1, j2, _, _ = cameras(same_rows=True)
    kw = dict(out_dir=root, clean_intermediate=clean, epipolar_thresh=3.0)
    jcfg = JConfig(images=(JImageSpec(img=paths[0], rpcm=j1),
                           JImageSpec(img=paths[1], rpcm=j2)), **kw)
    d = jcfg.to_dict()
    for img, j in zip(d['images'], (j1, j2)):
        img['rpcm'] = dataclasses.asdict(j)
    return jcfg, state.config_from_state(d)


def _copy(src, dst, tiles):
    shutil.copytree(src, dst)
    return [dict(t, dir=t['dir'].replace(src, dst)) for t in tiles]


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def _run(tmp_path, clean=False):
    """Stages 2 and 3 on copies of one scene: the port on the CPU, the
    JAX package unjitted and jitted."""
    _, _, t1, t2 = cameras(same_rows=True)
    base = str(tmp_path / 'scene')
    paths, tiles = _scene(base, t1, t2)
    runs = {}
    for name in ('torch', 'nojit', 'jit'):
        root = str(tmp_path / name)
        ts = _copy(base, root, tiles)
        ps = [p.replace(base, root) for p in paths]
        jcfg, tcfg = _configs(root, ps, clean)
        pairs = [(t, 1) for t in ts]
        if name == 'torch':
            tpipe.global_pointing_correction(tcfg, ts)
            tpipe.rectification_all(tcfg, pairs, device='cpu')
        elif name == 'nojit':
            with jax.disable_jit():
                jpipe.global_pointing_correction(jcfg, ts)
                jpipe.rectification_all(jcfg, pairs)
        else:
            jpipe.global_pointing_correction(jcfg, ts)
            jpipe.rectification_all(jcfg, pairs)
        runs[name] = (root, ts)
    return runs


@pytest.fixture(scope='module')
def scene_runs(tmp_path_factory):
    return _run(tmp_path_factory.mktemp('stage23'))


def test_stage2_files_equal(scene_runs):
    (troot, _), (jroot, _) = scene_runs['torch'], scene_runs['jit']
    name = 'global_pointing_pair_1.txt'
    got = _read(os.path.join(troot, name))
    assert got == _read(os.path.join(jroot, name))
    A = np.loadtxt(os.path.join(troot, name))
    assert abs(A[1, 2] + 0.4) < 1e-3 and np.allclose(A[:2, :2], np.eye(2),
                                                     atol=1e-3)


def test_stage3_text_files_equal(scene_runs):
    (_, tt), (_, jt) = scene_runs['torch'], scene_runs['jit']
    for a, b in zip(tt, jt):
        for name in TEXT:
            got = _read(os.path.join(a['dir'], 'pair_1', name))
            assert got == _read(os.path.join(b['dir'], 'pair_1', name)), name
        lo, hi = np.loadtxt(os.path.join(a['dir'], 'pair_1', TEXT[2]))
        assert lo <= -3 and hi >= 3


@pytest.mark.parametrize('name', ['rectified_ref.tif', 'rectified_sec.tif'])
def test_stage3_images_equal_unjitted_jax(scene_runs, name):
    (_, tt), (_, nt) = scene_runs['torch'], scene_runs['nojit']
    for a, b in zip(tt, nt):
        pa, pb = (os.path.join(t['dir'], 'pair_1', name) for t in (a, b))
        assert _read(pa) == _read(pb)
        img = tgeotiff.read(pa)
        assert img.dtype == np.float32 and np.isfinite(img).mean() > 0.5


@pytest.mark.parametrize('name,H', [('rectified_ref.tif', 'H_ref.txt'),
                                    ('rectified_sec.tif', 'H_sec.txt')])
def test_stage3_images_near_jitted_jax(scene_runs, name, H):
    (_, tt), (_, jt) = scene_runs['torch'], scene_runs['jit']
    for a, b in zip(tt, jt):
        got = tgeotiff.read(os.path.join(a['dir'], 'pair_1', name))
        want = jgeotiff.read(os.path.join(b['dir'], 'pair_1', name))
        assert got.shape == want.shape
        Hm = np.loadtxt(os.path.join(a['dir'], 'pair_1', H))
        amb = _near_integer_source(np.linalg.inv(Hm), got.shape[1],
                                   got.shape[0])
        assert np.array_equal(np.isnan(got)[~amb], np.isnan(want)[~amb])
        fin = np.isfinite(got) & np.isfinite(want)
        assert np.abs(got[fin] - want[fin]).max() <= WARP_JIT_TOL


def test_rectified_rows_agree(scene_runs):
    """The SIFT matches' rectified rows agree within 0.1 px (the JAX
    package's test_rectify_pair_with_matches)."""
    from s2p_tpu_torch.ops.homography import points_apply_homography
    _, _, t1, t2 = cameras(same_rows=True)
    _, tt = scene_runs['torch']
    for k, t in enumerate(tt):
        m = sift_matches(t1, t2, t['coordinates'], n=30, seed=20 + k,
                         noise=0.0)
        m[:, 3] += 0.4
        d = os.path.join(t['dir'], 'pair_1')
        y1 = points_apply_homography(np.loadtxt(os.path.join(d, TEXT[0])),
                                     m[:, :2])[:, 1]
        y2 = points_apply_homography(np.loadtxt(os.path.join(d, TEXT[1])),
                                     m[:, 2:])[:, 1]
        assert np.abs(y1 - y2).max() < 0.1


def test_stage2_clean_intermediate_and_one_pair(tmp_path):
    """clean_intermediate removes center_keypts_sec.txt as the JAX
    package's does; rectification_pair is one tile of rectification_all."""
    _, _, t1, t2 = cameras(same_rows=True)
    base = str(tmp_path / 'scene')
    paths, tiles = _scene(base, t1, t2)
    _, tcfg = _configs(base, paths, clean=True)
    tpipe.global_pointing_correction(tcfg, tiles)
    for t in tiles:
        assert not os.path.exists(os.path.join(t['dir'], 'pair_1',
                                               'center_keypts_sec.txt'))
    ref = str(tmp_path / 'ref')
    rtiles = _copy(base, ref, tiles)
    _, rcfg = _configs(ref, [p.replace(base, ref) for p in paths])
    tpipe.rectification_all(rcfg, [(rtiles[0], 1)], device='cpu')
    tpipe.rectification_pair(tcfg, tiles[0], 1, device='cpu')
    for name in TEXT + ('rectified_ref.tif', 'rectified_sec.tif'):
        assert _read(os.path.join(tiles[0]['dir'], 'pair_1', name)) == \
            _read(os.path.join(rtiles[0]['dir'], 'pair_1', name))


def test_rectification_all_raises_without_cuda(tmp_path, monkeypatch):
    _, _, t1, t2 = cameras(same_rows=True)
    base = str(tmp_path / 'scene')
    paths, tiles = _scene(base, t1, t2)
    _, tcfg = _configs(base, paths)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tpipe.rectification_all(tcfg, [(t, 1) for t in tiles])
    assert not os.path.exists(os.path.join(tiles[0]['dir'], 'pair_1',
                                           'H_ref.txt'))
