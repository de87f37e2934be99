"""The port's stage 5 in pair mode (``disparity_to_ply_all``, device="cpu")
against the JAX package's on the same synthetic tile directories.

Both read the stage-4 files, the homographies, the tile's original mask
and the scene's pointing correction, triangulate, filter in 3D and write
``cloud.ply``.  The clouds must hold the same points in the same order
with the same colours and confidence; coordinates agree within the
tolerances of ``test_torch_triangulation.py`` (float32 on both sides,
rounded differently by XLA).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from s2p_tpu import pipeline as jpipe
from s2p_tpu.config import Config as JConfig
from s2p_tpu.config import ImageSpec as JImageSpec
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch.geo import ply as tply

from test_torch_triangulation import (ALT_TOL_M, SPECS, UTM, XY_TOL_M,
                                      cameras, tile_job)

_FILES = ('H_ref.txt', 'H_sec.txt', 'rectified_disp.tif',
          'rectified_mask.png', 'rectified_ref.tif',
          'rectified_disp_confidence.tif')


def _scene(root, rpc1, rpc2):
    """Stage-4 outputs of three tiles (two padded shapes) and the scene's
    pointing correction, written with the JAX package's writers."""
    os.makedirs(root)
    np.savetxt(os.path.join(root, 'global_pointing_pair_1.txt'), np.eye(3))
    tiles = []
    for seed, h, w, x0, y0 in SPECS:
        job = tile_job(seed, h, w, x0, y0, rpc1, rpc2)
        rng = np.random.RandomState(seed + 50)
        tdir = os.path.join(root, f'tile_{seed}')
        pdir = os.path.join(tdir, 'pair_1')
        os.makedirs(pdir)
        np.savetxt(os.path.join(pdir, 'H_ref.txt'), job['H1'])
        np.savetxt(os.path.join(pdir, 'H_sec.txt'), job['H2'])
        jgeotiff.write(os.path.join(pdir, 'rectified_disp.tif'), job['disp'],
                       nodata=float('nan'))
        jgeotiff.write_png(os.path.join(pdir, 'rectified_mask.png'),
                           job['mask_rect'])
        ref = (rng.rand(h, w) * 900 + 100).astype(np.float32)
        ref[:2] = np.nan
        jgeotiff.write(os.path.join(pdir, 'rectified_ref.tif'), ref,
                       nodata=float('nan'))
        jgeotiff.write(os.path.join(pdir, 'rectified_disp_confidence.tif'),
                       (rng.randint(0, 9, (h, w)) / 8).astype(np.float32))
        jgeotiff.write_png(os.path.join(tdir, 'mask.png'),
                           job['mask_orig'] * 255)
        x, x1, y, y1 = job['img_bbx']
        tiles.append({'dir': tdir, 'coordinates': (x, y, x1 - x, y1 - y)})
    return tiles


def _configs(root, clean, filt, clr=None):
    j1, j2, _, _ = cameras(same_rows=False)
    kw = dict(out_dir=root, out_crs=UTM, gsd=1.0, clean_intermediate=clean)
    if filt:
        kw.update(filtering_3d_r=2.5, filtering_3d_n=8)
    jcfg = JConfig(images=(JImageSpec(img='a.tif', rpcm=j1, clr=clr),
                           JImageSpec(img='b.tif', rpcm=j2)), **kw)
    d = jcfg.to_dict()
    for img, j in zip(d['images'], (j1, j2)):
        img['rpcm'] = dataclasses.asdict(j)
    return jcfg, state.config_from_state(d)


def _copy(src, dst, tiles):
    shutil.copytree(src, dst)
    return [dict(t, dir=t['dir'].replace(src, dst)) for t in tiles]


@pytest.mark.parametrize('filt', [True, False], ids=['filter', 'no_filter'])
@pytest.mark.parametrize('clean', [False, True], ids=['keep', 'clean'])
def test_disparity_to_ply_all_matches_jax(tmp_path, filt, clean):
    j1, j2, t1, t2 = cameras(same_rows=False)
    base = str(tmp_path / 'scene')
    tiles = _scene(base, t1, t2)
    jroot, troot = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    jtiles, ttiles = _copy(base, jroot, tiles), _copy(base, troot, tiles)
    jcfg, _ = _configs(jroot, clean, filt)
    _, tcfg = _configs(troot, clean, filt)
    assert all(np.array_equal(a, b) for a, b in zip(
        tcfg.images[0].rpcm.params(), j1.params()))
    jpipe.disparity_to_ply_all(jcfg, jtiles)
    tpipe.disparity_to_ply_all(tcfg, ttiles, device='cpu')

    removed = 0
    for jt, tt in zip(jtiles, ttiles):
        for sub in ('', 'pair_1'):
            jl = sorted(os.listdir(os.path.join(jt['dir'], sub)))
            tl = sorted(os.listdir(os.path.join(tt['dir'], sub)))
            assert jl == tl, (jl, tl)
        removed += sum(not os.path.exists(os.path.join(tt['dir'], 'pair_1',
                                                       f)) for f in _FILES)
        (jp, jc), (tp, tc) = (tply.read_ply(os.path.join(t['dir'],
                                                         'cloud.ply'))
                              for t in (jt, tt))
        assert jc == tc
        assert jp.shape == tp.shape and len(tp) > 1000
        # x y z red green blue confidence
        assert np.array_equal(jp[:, 3:], tp[:, 3:])
        d_xy = np.abs(jp[:, :2] - tp[:, :2]).max()
        d_z = np.abs(jp[:, 2] - tp[:, 2]).max()
        print(f"{os.path.basename(tt['dir'])}: {len(tp)} points, xy "
              f'{d_xy:.3g} m, altitude {d_z:.3g} m')
        assert d_xy <= XY_TOL_M
        assert d_z <= ALT_TOL_M
    assert removed == (5 * len(tiles) if clean else 0)


def test_clr_image_raises_naming_m7(tmp_path):
    _, _, t1, t2 = cameras(same_rows=False)
    root = str(tmp_path / 'scene')
    tiles = _scene(root, t1, t2)
    _, tcfg = _configs(root, False, False, clr='clr.tif')
    with pytest.raises(NotImplementedError, match='M7'):
        tpipe.disparity_to_ply_all(tcfg, tiles, device='cpu')


def test_stage5_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    from s2p_tpu_torch.core import triangulation as ttri
    from s2p_tpu_torch.ops import filtering as tfilt
    _, _, t1, t2 = cameras(same_rows=False)
    root = str(tmp_path / 'scene')
    tiles = _scene(root, t1, t2)
    _, tcfg = _configs(root, False, True)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tpipe.disparity_to_ply_all(tcfg, tiles)
    with pytest.raises(RuntimeError, match='CUDA'):
        ttri.disp_to_xyz_batch([tile_job(0, 60, 70, 4000, 4800, t1, t2)])
    with pytest.raises(RuntimeError, match='CUDA'):
        tfilt.count_3d_neighbors_batch([np.zeros((4, 4, 3))], 1.0, 1)
    assert not os.path.exists(os.path.join(tiles[0]['dir'], 'cloud.ply'))
