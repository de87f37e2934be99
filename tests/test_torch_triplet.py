"""The port's triplet mode (stage 5 in four steps: 5a height maps, 5b and
5c the pairs' mean offsets, 5d fusion and the fused clouds) against the
JAX package.

  * The functions it ports, on the same seeded inputs: ``fusion``'s
    merge, ``morphology``'s window min and max (by value: the sign of a
    zero may differ) and small-component removals, and the host
    resampling and localization of ``triangulation``, bitwise; the
    single-tile height map and the triangulation of correspondences
    within ``test_torch_triangulation.py``'s tolerances (float32 solves
    that XLA rounds differently from torch).
  * The stage-5b/5c/5d drivers on the same tile directories, built from
    seeded per-pair height maps written by the JAX package's writer:
    every file they write byte for byte, with and without the
    despeckling, ``debug`` and ``clean_intermediate``.
  * A triplet scene through the port's ``main`` on the CPU, and stage 5
    onward on copies of its tree by both packages (the fixture
    ``triplet``, described there).

``pytest -s`` prints the measured figures.
"""

import dataclasses
import glob
import json
import os
import shutil
import time

import numpy as np
import pytest

from s2p_tpu import pipeline as jpipe
from s2p_tpu.config import Config as JConfig
from s2p_tpu.config import ImageSpec as JImageSpec
from s2p_tpu.core import fusion as jfusion
from s2p_tpu.core import triangulation as jtri
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu.ops import morphology as jmorph
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch.core import fusion as tfusion
from s2p_tpu_torch.core import triangulation as ttri
from s2p_tpu_torch.geo import geotiff as tgeotiff
from s2p_tpu_torch.geo import ply as tply
from s2p_tpu_torch.ops import morphology as tmorph

from test_torch_scene import H0, TILE, _cams, _read, _render, _same
from test_torch_sift import one_thread  # noqa: F401 (autouse fixture)
from test_torch_triangulation import (ALT_TOL_M, ERR_TOL_PX, LONLAT_TOL_DEG,
                                      UTM, XY_TOL_M, cameras, jax_rpc,
                                      tile_job)

THRESH = 3.0        # the default fusion_thresh


# --------------------------------------------------------------------- #
# The ported functions
# --------------------------------------------------------------------- #

def _fusion_maps(n):
    """n float64 maps and offsets: noise about 300 m, NaN in some maps
    and in all maps, and pixels whose spread after the offsets is exactly
    THRESH or one float64 ulp either side of it."""
    rng = np.random.RandomState(n)
    offsets = [0.5, -0.25, 1.75][:n]
    maps = [300 + o + rng.normal(0, 1.5, (12, 16)) for o in offsets]
    maps[0][0, :3] = np.nan                  # NaN in one map
    for m in maps:
        m[1, :4] = np.nan                    # NaN in all maps
    for col, top in enumerate((np.nextafter(103.0, 0), 103.0,
                               np.nextafter(103.0, 200))):
        for k, m in enumerate(maps):
            m[2, col] = (100.0 if k == 0 else top if k == 1 else 101.5) \
                + offsets[k]
    return maps, offsets


@pytest.mark.parametrize('averaging', ['average_if_close', 'np.nanmedian',
                                       'np.nanmean'])
@pytest.mark.parametrize('n', [2, 3])
def test_merge_n_arrays(n, averaging):
    maps, offsets = _fusion_maps(n)
    with np.errstate(all='ignore'), pytest.warns(RuntimeWarning):
        got = tfusion.merge_n_arrays(maps, offsets, averaging, THRESH)
    with np.errstate(all='ignore'), pytest.warns(RuntimeWarning):
        want = jfusion.merge_n_arrays(maps, offsets, averaging, THRESH)
    _same(got, want)
    assert np.isnan(got[1, :4]).all() and np.isfinite(got[0, :3]).all()
    if averaging == 'average_if_close':
        # spread THRESH - ulp and THRESH kept, THRESH + ulp dropped
        assert np.isfinite(got[2, :2]).all() and np.isnan(got[2, 2])


def _morph_cases():
    rng = np.random.RandomState(3)
    a = (rng.rand(23, 31) * 20).astype(np.float32)
    a[rng.rand(23, 31) < 0.1] = np.nan
    a[5:12, 8:17] = np.nan                   # an all-NaN 5 x 5 window
    b = (rng.rand(1, 40) * 5).astype(np.float32)
    b[0, 10:20] = np.nan
    c = np.array([[1.0, np.nan], [-2.0, 0.0], [-0.0, 4.0]], np.float32)
    return {'map': a, '1xN': b, 'smaller_than_window': c,
            'Nx1': np.ascontiguousarray(b.T)}


@pytest.mark.parametrize('size', [3, 5])
@pytest.mark.parametrize('operation', ['min', 'max'])
@pytest.mark.parametrize('case', ['map', '1xN', 'Nx1',
                                  'smaller_than_window'])
def test_morphoop(case, operation, size):
    img = _morph_cases()[case]
    got = tmorph.morphoop(img, operation, size, device='cpu')
    want = jmorph.morphoop(img, operation, size)
    assert got.dtype == np.float32 and got.shape == img.shape
    # by value: -0 and +0 are equal, and no NaN comes out
    assert np.array_equal(got, want)
    if case == 'map':
        assert np.isinf(got[8, 12])          # its window is all NaN


def _speckle_map():
    """A height map at about 300 m with spikes of 4.9, 6 and 20 m, a NaN
    hole, blocks of 199, 200 and 201 px standing 50 m off the ground,
    and two regions exactly 5 m apart, then 5 m + one float32 ulp."""
    rng = np.random.RandomState(11)
    img = (300 + rng.rand(80, 90) * 0.5).astype(np.float32)
    for (y, x), d in zip(((10, 10), (10, 30), (10, 50)), (4.9, 6.0, 20.0)):
        img[y, x] += d
    img[20:26, 60:70] = np.nan
    for (y, x, hh, ww), cut in zip(((30, 5, 10, 20), (30, 30, 10, 20),
                                    (30, 55, 10, 20)), (1, 0, -1)):
        # a NaN moat 2 px wide, so that the 5 x 5 range sees no ground
        img[y - 2:y + hh + 3, x - 2:x + ww + 2] = np.nan
        block = np.full((hh, ww), 350.0, np.float32)
        if cut > 0:
            block[-1, -1] = np.nan           # 199 px
        img[y:y + hh, x:x + ww] = block
        if cut < 0:
            img[y + hh, x] = 350.0           # 201 px
    img[55:80, 0:45] = 310.0
    img[55:80, 45:90] = 315.0                # exactly 5 m apart
    img[70:80, 45:90] = np.nextafter(np.float32(315.0), np.float32(400))
    return img


def _disp_speckles():
    rng = np.random.RandomState(12)
    disp = (rng.rand(40, 50) * 0.2).astype(np.float32)
    valid = rng.rand(40, 50) > 0.05
    for (y, x), n in zip(((2, 2), (12, 2), (22, 2)), (24, 25, 26)):
        blob = np.zeros((8, 10), bool)
        blob.flat[:n] = True
        disp[y:y + 8, x:x + 10] = np.where(blob, 10.0, 20.0)
        valid[y:y + 8, x:x + 10] = blob
    disp[30:40, 20:30] = 5.0
    disp[30:40, 30:40] = 6.0                 # exactly 1 apart: connected
    return disp, valid


@pytest.mark.parametrize('fn', ['despeckle', 'remove_small_components',
                                'remove_small_disparity_speckles'])
@pytest.mark.parametrize('case', ['map', 'all_nan'])
def test_speckle_removal(fn, case):
    img = _speckle_map()
    if case == 'all_nan':
        img = np.full_like(img, np.nan)
    if fn == 'despeckle':
        got = tmorph.despeckle_height_map(img, device='cpu')
        want = jmorph.despeckle_height_map(img)
    elif fn == 'remove_small_components':
        got = tmorph.remove_small_components(img)
        want = jmorph.remove_small_components(img)
    else:
        disp, valid = _disp_speckles()
        if case == 'all_nan':
            valid[:] = False
        got = tmorph.remove_small_disparity_speckles(disp, valid)
        want = jmorph.remove_small_disparity_speckles(disp, valid)
    _same(got, want)
    if case == 'all_nan':
        assert not np.any(np.isfinite(got) if got.dtype.kind == 'f'
                          else got)
        return
    if fn == 'remove_small_disparity_speckles':
        assert not got[2:10, 2:12].any()     # 24 px: removed
        assert got[12:20, 2:12].sum() == 25 and got[22:30, 2:12].sum() == 26
        return
    kept = np.isfinite(got)
    assert not kept[30:40, 5:25].any()       # 199 px: removed
    assert kept[30:40, 30:50].all() and kept[30:41, 55:75].sum() == 201
    if fn == 'despeckle':
        assert np.isnan(got[10, 30]) and np.isnan(got[10, 50])
        assert np.isfinite(got[10, 10])      # 4.9 m: within the range
        # 5 m apart keeps the border, 5 m + 1 ulp clears it
        assert np.isfinite(got[60, 44:46]).all()
        assert np.isnan(got[75, 44:46]).all()


def _resample_inputs(with_nan):
    rng = np.random.RandomState(21)
    hmap = 300 + rng.rand(50, 64) * 10
    if with_nan:
        hmap[rng.rand(50, 64) < 0.05] = np.nan
        hmap[10:14, 20:30] = np.nan
    H1 = np.array([[1.0, 0.002, -4003.0], [-0.001, 1.0, -4798.0],
                   [0.0, 0.0, 1.0]])
    return hmap, H1


@pytest.mark.parametrize('with_nan', [False, True], ids=['clean', 'nan'])
def test_height_map_resample(with_nan):
    hmap, H1 = _resample_inputs(with_nan)
    got = ttri.height_map_resample(hmap, 4000, 4800, 44, 40, H1)
    want = jtri.height_map_resample(hmap, 4000, 4800, 44, 40, H1)
    _same(got, want)
    assert np.isnan(got).any() == with_nan and np.isfinite(got).mean() > 0.5


def test_height_map_job():
    _, _, t1, t2 = cameras()
    job = tile_job(0, 60, 70, 4000, 4800, t1, t2)
    args = (4000, 4800, 64, 56, t1, t2, job['H1'], job['H2'], job['disp'],
            job['mask_rect'], job['mask_orig'][:56, :64])
    got = ttri.height_map_job(*args, A=np.eye(3))
    want = jtri.height_map_job(*args, A=np.eye(3))
    assert got.keys() == want.keys()
    for k in got:
        if k in ('rpc1', 'rpc2'):
            assert got[k] is want[k]
        else:
            _same(got[k], want[k])
    assert got['img_bbx'] == (3999, 4066, 4799, 4858)
    assert got['mask_orig'].shape == (58, 66)


@pytest.mark.parametrize('out_crs', [None, UTM])
def test_height_map_to_xyz(out_crs):
    j1, _, t1, _ = cameras()
    rng = np.random.RandomState(4)
    h = (300 + rng.rand(40, 50) * 30).astype(np.float32)
    h[rng.rand(40, 50) < 0.1] = np.nan
    got = ttri.height_map_to_xyz(h, t1, 4000, 4800, out_crs)
    want = jtri.height_map_to_xyz(h, j1, 4000, 4800, out_crs)
    _same(got, want)
    assert got.shape == (40, 50, 3)
    assert np.array_equal(np.isnan(got[..., 0]), np.isnan(h))


def test_height_map_within_the_stage5_tolerances():
    """The single-tile height map (``disp_to_xyz`` in lon/lat/alt, then
    the resample) against the JAX package's."""
    j1, j2, t1, t2 = cameras(same_rows=False)
    x0, y0, h, w = 4000, 4800, 60, 70
    jobs = [tile_job(0, h, w, x0, y0, r1, r2) for r1, r2 in ((j1, j2),
                                                              (t1, t2))]
    for job in jobs:
        # an affine H1 (the resample is scipy's affine_transform)
        job['H1'][2] = (0.0, 0.0, 1.0)

    def run(tri, job, **kw):
        return tri.height_map(x0, y0, w - 6, h - 4, job['rpc1'], job['rpc2'],
                              job['H1'], job['H2'], job['disp'],
                              job['mask_rect'], job['mask_orig'], A=job['A'],
                              **kw)
    want = run(jtri, jobs[0])
    got = run(ttri, jobs[1], device='cpu')
    assert got.shape == want.shape == (h - 4, w - 6)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(got)
    d = float(np.abs(got[fin] - want[fin]).max())
    print(f'height_map: {fin.mean():.4f} finite, altitude within {d:.3g} m')
    assert fin.mean() > 0.5 and d <= ALT_TOL_M


@pytest.mark.parametrize('out_crs', [None, UTM])
def test_stereo_corresp_to_xyz(out_crs):
    """Correspondences of ground points at known altitudes (float64
    cameras) triangulated by both packages."""
    j1, j2, t1, t2 = cameras(same_rows=False)
    rng = np.random.RandomState(8)
    n = 500
    pts1 = np.column_stack([4000 + rng.rand(n) * 300,
                            4800 + rng.rand(n) * 300])
    alt = 200 + rng.rand(n) * 300
    lon, lat = t1.localization(pts1[:, 0], pts1[:, 1], alt)
    pts2 = np.column_stack(t2.projection(lon, lat, alt))
    xj, ej = jtri.stereo_corresp_to_xyz(j1, j2, pts1, pts2, out_crs)
    xt, et = ttri.stereo_corresp_to_xyz(t1, t2, pts1, pts2, out_crs,
                                        device='cpu')
    assert xt.shape == xj.shape == (n, 3) and xt.dtype == np.float64
    assert et.dtype == ej.dtype and et.shape == (n,)
    d_xy = float(np.abs(xt[:, :2] - xj[:, :2]).max())
    d_z = float(np.abs(xt[:, 2] - xj[:, 2]).max())
    d_e = float(np.abs(et - ej).max())
    print(f'{out_crs}: xy {d_xy:.3g}, altitude {d_z:.3g} m, error '
          f'{d_e:.3g} px; altitude against the truth '
          f'{np.abs(xt[:, 2] - alt).max():.3g} m')
    assert d_xy <= (XY_TOL_M if out_crs else LONLAT_TOL_DEG)
    assert d_z <= ALT_TOL_M and d_e <= ERR_TOL_PX
    assert np.abs(xt[:, 2] - alt).max() < 0.05


# --------------------------------------------------------------------- #
# The stage-5b/5c/5d drivers on the same files
# --------------------------------------------------------------------- #

# tiles of the drivers' scene: (x, y, w, h) on a 300 x 320 image whose
# cameras are centred on it
D_TILES = ((20, 30, 64, 56), (84, 30, 64, 56), (20, 86, 70, 48))
D_SHAPE = (320, 300)
D_OFFSETS = (0.4, -0.3)      # the pairs' mean heights about the ground


def _d_cams():
    js = [dataclasses.replace(j, col_offset=150.0, row_offset=160.0)
          for j in (jax_rpc(1, 0.02), jax_rpc(2, -0.015), jax_rpc(3, 0.005))]
    return js, [state.rpc_from_state(dataclasses.asdict(j)) for j in js]


def _d_scene(root):
    """Three tiles, each with both pairs' height maps (seeded: a sloped
    ground at about 300 m, per-pair offsets and noise, spikes, a NaN
    hole, small blocks and a pair-2 disagreement beyond THRESH) and its
    mask, the reference image, a 3-band clr image and the pairs' global
    mean heights, written with the JAX package's writers."""
    os.makedirs(root)
    rng = np.random.RandomState(31)
    img = (rng.rand(*D_SHAPE) * 1000).astype(np.float32)
    img[:3] = np.nan
    jgeotiff.write(os.path.join(root, 'img.tif'), img)
    jgeotiff.write(os.path.join(root, 'clr.tif'),
                   (rng.rand(*D_SHAPE, 3) * 255).astype(np.float32))
    tiles = []
    for k, (x, y, w, h) in enumerate(D_TILES):
        tdir = os.path.join(root, f'tile_{k}')
        yy, xx = np.mgrid[y:y + h, x:x + w]
        ground = 300 + 0.05 * xx - 0.03 * yy
        for i, off in enumerate(D_OFFSETS):
            pdir = os.path.join(tdir, f'pair_{i + 1}')
            os.makedirs(pdir)
            hm = (ground + off + rng.normal(0, 0.3, (h, w))).astype(
                np.float32)
            hm[rng.rand(h, w) < 0.03] += 30.0                # spikes
            hm[5:9, 10:20] = np.nan
            hm[30:35, 40:45] += 40.0                         # small block
            if i == 1:
                hm[20:26, 3:30] += 5.0                       # beyond THRESH
            jgeotiff.write(os.path.join(pdir, 'height_map.tif'), hm,
                           nodata=float('nan'))
        jgeotiff.write_png(os.path.join(tdir, 'mask.png'),
                           np.full((h, w), 255, np.uint8))
        tiles.append({'dir': tdir, 'coordinates': (x, y, w, h)})
    for i, off in enumerate(D_OFFSETS):
        np.savetxt(os.path.join(root, f'global_mean_height_pair_{i + 1}.txt'),
                   [300 + off + 0.01 * i])
    return tiles


def _d_configs(root, clr=False, **kw):
    """(JAX config, port config) of the drivers' scene under ``root``."""
    js, _ = _d_cams()
    kw = dict(dict(out_dir=root, out_crs=UTM, gsd=1.0, filtering_3d_r=2.5,
                   filtering_3d_n=8), **kw)
    c = os.path.join(root, 'clr.tif') if clr else None
    jcfg = JConfig(images=(JImageSpec(img=os.path.join(root, 'img.tif'),
                                      rpcm=js[0], clr=c),
                           JImageSpec(img='b.tif', rpcm=js[1]),
                           JImageSpec(img='c.tif', rpcm=js[2])), **kw)
    d = jcfg.to_dict()
    for img, j in zip(d['images'], js):
        img['rpcm'] = dataclasses.asdict(j)
    return jcfg, state.config_from_state(d)


@pytest.fixture
def d_trees(tmp_path):
    """The drivers' scene and two copies, one per package."""
    base = str(tmp_path / 'base')
    tiles = _d_scene(base)
    trees = {}
    for name in ('jax', 'torch'):
        root = str(tmp_path / name)
        shutil.copytree(base, root)
        trees[name] = (root, [dict(t, dir=t['dir'].replace(base, root))
                              for t in tiles])
    return trees


def _tree_files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, '**'), recursive=True) if os.path.isfile(p))


def _trees_equal(jroot, troot, names=None):
    """The same files in both trees, equal byte for byte (``names``: the
    base names compared, default all)."""
    files = _tree_files(jroot)
    assert files == _tree_files(troot)
    n = 0
    for f in files:
        if names is None or os.path.basename(f) in names:
            assert _read(os.path.join(jroot, f)) == \
                _read(os.path.join(troot, f)), f
            n += 1
    return n


def test_mean_heights_byte_for_byte(d_trees):
    (jroot, jtiles), (troot, ttiles) = d_trees['jax'], d_trees['torch']
    jcfg, _ = _d_configs(jroot)
    _, tcfg = _d_configs(troot)
    # a tile with no pair 2 map: its mean is over no pixel (NaN)
    for root, tiles in d_trees.values():
        os.remove(os.path.join(tiles[2]['dir'], 'pair_2', 'height_map.tif'))
    with pytest.warns(RuntimeWarning):
        for t in jtiles:
            jpipe.mean_heights(jcfg, t)
    with pytest.warns(RuntimeWarning):
        for t in ttiles:
            tpipe.mean_heights(tcfg, t)
    for f in ('global_mean_height_pair_1.txt',
              'global_mean_height_pair_2.txt'):
        os.remove(os.path.join(jroot, f))
        os.remove(os.path.join(troot, f))
    jpipe.global_mean_heights(jcfg, jtiles)
    tpipe.global_mean_heights(tcfg, ttiles)
    n = _trees_equal(jroot, troot, ('local_mean_heights.txt',
                                    'global_mean_height_pair_1.txt',
                                    'global_mean_height_pair_2.txt'))
    assert n == 5
    means = np.loadtxt(os.path.join(ttiles[0]['dir'],
                                    'local_mean_heights.txt'))
    assert np.isfinite(means).all()
    assert np.isnan(np.loadtxt(os.path.join(ttiles[2]['dir'],
                                            'local_mean_heights.txt'))).all()
    print(f'local means of tile 0: {means.tolist()}')


@pytest.mark.parametrize('basura,debug', [(True, False), (False, False),
                                          (True, True)],
                         ids=['despeckle', 'raw', 'debug'])
def test_heights_fusion_bitwise(d_trees, basura, debug):
    (jroot, jtiles), (troot, ttiles) = d_trees['jax'], d_trees['torch']
    jcfg, _ = _d_configs(jroot, cargarse_basura=basura, debug=debug)
    _, tcfg = _d_configs(troot, cargarse_basura=basura, debug=debug)
    for jt, tt in zip(jtiles, ttiles):
        jpipe.heights_fusion(jcfg, jt)
        tpipe.heights_fusion(tcfg, tt, device='cpu')
    n = _trees_equal(jroot, troot)
    assert n == (6 if debug else 4) * len(jtiles) + 4
    for jt, tt in zip(jtiles, ttiles):
        names = ['height_map.tif'] + [
            f'pair_{i}/height_map{s}.tif' for i in (1, 2)
            for s in (('', '_registered') if debug else ('',))]
        for name in names:
            _same(tgeotiff.read(os.path.join(tt['dir'], name)),
                  jgeotiff.read(os.path.join(jt['dir'], name)))
    fused = tgeotiff.read(os.path.join(ttiles[0]['dir'], 'height_map.tif'))
    print(f'fused map of tile 0: {np.isfinite(fused).mean():.4f} finite')
    assert 0.3 < np.isfinite(fused).mean() < 0.99


@pytest.mark.parametrize('clean', [False, True], ids=['keep', 'clean'])
@pytest.mark.parametrize('clr', [False, True], ids=['image', 'clr'])
@pytest.mark.parametrize('driver', ['all', 'one'])
def test_heights_to_ply_byte_for_byte(d_trees, clr, clean, driver):
    """``heights_to_ply_all`` (and the single tile's ``heights_to_ply``)
    on both trees: every file byte for byte (``cloud.ply`` with the 3D
    filter on), the same file set after ``clean_intermediate``."""
    (jroot, jtiles), (troot, ttiles) = d_trees['jax'], d_trees['torch']
    jcfg, _ = _d_configs(jroot, clr=clr, clean_intermediate=clean)
    _, tcfg = _d_configs(troot, clr=clr, clean_intermediate=clean)
    if driver == 'all':
        jpipe.heights_to_ply_all(jcfg, jtiles)
        tpipe.heights_to_ply_all(tcfg, ttiles, device='cpu')
    else:
        for jt, tt in zip(jtiles, ttiles):
            jpipe.heights_to_ply(jcfg, jt)
            tpipe.heights_to_ply(tcfg, tt, device='cpu')
    _trees_equal(jroot, troot)
    for tt in ttiles:
        pts, comments = tply.read_ply(os.path.join(tt['dir'], 'cloud.ply'))
        assert pts.shape[1] == 6 and len(pts) > 1000     # x y z r g b
        left = set(os.listdir(tt['dir']))
        assert ('height_map.tif' in left) != clean
        assert ('mask.png' in left) != clean
        for i in (1, 2):
            assert (os.path.exists(os.path.join(tt['dir'], f'pair_{i}',
                                                'height_map.tif'))) != clean
    print(f"{driver}, {'clr' if clr else 'image'}, "
          f"{'clean' if clean else 'keep'}: {len(pts)} points in the last "
          f'tile, z {np.nanmedian(pts[:, 2]):.3f} m median')


# --------------------------------------------------------------------- #
# A triplet scene through main
# --------------------------------------------------------------------- #

# image 3: its camera's columns move 0.05 px per metre (a base of 0.15
# px/m to camera 1, against pair 1's 0.35) and its pointing error; the
# ROI: the top row of test_torch_scene.py's 2 x 2 tiles (the CPU's
# stages 1 and 5a take most of the file's time, single-threaded)
ROI_ROWS = 1
H3_TERM = 0.005
POINTING3 = -0.5
CLOUD_ALT_TOL_M = (1.0, 3.0)     # median, 90th percentile of |z - H0|
NAN_STATE_SHARE = 1e-3           # fused maps: pixels NaN in one run only


def _render_triplet(base):
    """test_torch_scene.py's two images, a third seen by camera 3 with its
    own pointing error, and a config per run (relative paths)."""
    from scipy import ndimage

    _render(base)
    (j1, _), (t1, _) = _cams()
    j3 = dataclasses.replace(jax_rpc(3, H3_TERM, same_rows=True),
                             col_offset=j1.col_offset,
                             row_offset=j1.row_offset)
    t3 = state.rpc_from_state(dataclasses.asdict(j3))
    img1 = jgeotiff.read(os.path.join(base, 'img_1.tif'))
    h, w = img1.shape
    step = 8
    gy, gx = np.mgrid[0:h + step:step, 0:w + step:step].astype(np.float64)
    lon, lat = t3.localization(gx.ravel(), gy.ravel() - POINTING3, H0)
    c1, r1 = t1.projection(lon, lat, H0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) / step
    cmap = ndimage.map_coordinates(c1.reshape(gx.shape), [yy, xx], order=1)
    rmap = ndimage.map_coordinates(r1.reshape(gx.shape), [yy, xx], order=1)
    img3 = ndimage.map_coordinates(img1, [rmap, cmap], order=3,
                                   mode='nearest').astype(np.float32)
    jgeotiff.write(os.path.join(base, 'img_3.tif'), img3, rpc=j3)
    with open(os.path.join(base, 'torch.json')) as f:
        d = json.load(f)
    d['images'].append({'img': 'img_3.tif'})
    with open(os.path.join(base, 'triplet.json'), 'w') as f:
        json.dump(d, f, indent=2)
    return t3


def _cfg(base, out, **kw):
    from s2p_tpu_torch import config as tconfig
    d = tconfig.read_config_file(os.path.join(base, 'triplet.json'))
    d['out_dir'] = os.path.join(base, out)
    d['roi'] = dict(d['roi'], h=d['roi']['h'] * ROI_ROWS // 2)
    d.update(kw)
    return d


def _jax_main(user_cfg, start_from):
    """The JAX package's main with its compile cache in the run's tree;
    the variable, the JAX package's configuration and SIFT's mode are put
    back after it."""
    import jax
    from s2p_tpu import device as jdevice
    from s2p_tpu.ops import sift as jsift
    keys = ('jax_compilation_cache_dir',
            'jax_persistent_cache_min_compile_time_secs')
    cache = os.path.join(os.path.dirname(user_cfg['out_dir']), 'jax_cache')
    saved = ({k: getattr(jax.config, k) for k in keys},
             os.environ.get('S2P_TPU_JAX_CACHE'), jdevice._configured,
             jsift._DEVICE_MODE)
    os.environ['S2P_TPU_JAX_CACHE'] = cache
    jdevice._configured = False
    try:
        jdevice.configure(cache)
        jpipe.main(user_cfg, start_from=start_from)
    finally:
        for k, v in saved[0].items():
            jax.config.update(k, v)
        if saved[1] is None:
            os.environ.pop('S2P_TPU_JAX_CACHE', None)
        else:
            os.environ['S2P_TPU_JAX_CACHE'] = saved[1]
        jdevice._configured = saved[2]
        jsift.set_device_mode(saved[3])


def _tiles_of(out):
    return sorted(glob.glob(os.path.join(out, 'tiles', '*', '*')))


@pytest.fixture(scope='module')
def triplet(tmp_path_factory):
    """The triplet scene: test_torch_scene.py's images, a third one and
    ROI_ROWS rows of its 2 x 2 tiles of 180 px, through the port's
    ``main`` with device="cpu" (stages 1 -> 7, tree ``torch``; each
    pair's height map is kept as stage 5a wrote it, under ``torch5a``,
    before 5d despeckles it).  Then, on copies of that tree, stage 5
    onward by the JAX package's ``main(start_from=5)`` (``jax5``: the
    same stage-4 files as the port's own stage 5), both packages'
    ``main(start_from=5)`` with ``clean_intermediate`` (``jaxc``,
    ``torchc``), and the JAX package's stage 5a alone (``jax5a``)."""
    from s2p_tpu import tiling as jtiling

    base = os.path.join(str(tmp_path_factory.mktemp('triplet')), 'base')
    _render_triplet(base)
    runs = {'base': base, 'secs': {}, 'times': {}}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        runs['secs'][name] = time.perf_counter() - t0

    driver = tpipe.disparity_to_height_all

    def stage_5a(cfg, tiles_pairs, **kw):
        driver(cfg, tiles_pairs, **kw)
        for t, i in tiles_pairs:
            rel = os.path.relpath(os.path.join(t['dir'], f'pair_{i}'),
                                  cfg.out_dir)
            os.makedirs(os.path.join(base, 'torch5a', rel))
            shutil.copy(os.path.join(cfg.out_dir, rel, 'height_map.tif'),
                        os.path.join(base, 'torch5a', rel))
    tpipe.disparity_to_height_all = stage_5a
    try:
        timed('torch', lambda: tpipe.main(_cfg(base, 'torch'), device='cpu',
                                          stage_times=runs['times']))
    finally:
        tpipe.disparity_to_height_all = driver
    src = os.path.join(base, 'torch')
    for name in ('jax5', 'jaxc', 'torchc', 'jax5a'):
        shutil.copytree(src, os.path.join(base, name))
    timed('jax5', lambda: _jax_main(_cfg(base, 'jax5'), 5))
    timed('jaxc', lambda: _jax_main(_cfg(base, 'jaxc',
                                         clean_intermediate=True), 5))
    runs['timesc'] = {}
    timed('torchc', lambda: tpipe.main(_cfg(base, 'torchc',
                                            clean_intermediate=True),
                                       start_from=5, device='cpu',
                                       stage_times=runs['timesc']))
    jcfg = jpipe.build_cfg(_cfg(base, 'jax5a'))
    tw, th = jtiling.adjust_tile_size(jcfg)
    tiles = jtiling.tiles_full_info(jcfg, tw, th, os.path.join(
        jcfg.out_dir, 'tiles.txt'))
    timed('jax5a', lambda: jpipe.disparity_to_height_all(
        jcfg, [(t, i) for i in (1, 2) for t in tiles]))
    runs['cfg'] = tpipe.build_cfg(_cfg(base, 'torch'))
    runs['pairs'] = [(dict(t, dir=t['dir'].replace(jcfg.out_dir, src)), i)
                     for i in (1, 2) for t in tiles]
    print('triplet runs (s): ' + ', '.join(
        f'{k} {v:.1f}' for k, v in runs['secs'].items()))
    print('stages of the full run (s): ' + ', '.join(
        f"{k.split(')')[0]} {v:.2f}" for k, v in runs['times'].items()))
    return runs


def _both(runs, a, b, rel):
    return (os.path.join(runs['base'], a, rel),
            os.path.join(runs['base'], b, rel))


def test_triplet_config_runs_to_a_dsm(triplet):
    """Three images no longer raise: main writes dsm.tif, each pair's
    files in every tile, and times 5a-5d under their labels."""
    out = os.path.join(triplet['base'], 'torch')
    assert os.path.exists(os.path.join(out, 'dsm.tif'))
    tiles = _tiles_of(out)
    assert len(tiles) == 2 * ROI_ROWS
    for t in tiles:
        for i in (1, 2):
            assert os.path.exists(os.path.join(t, f'pair_{i}',
                                               'height_map.tif'))
        assert os.path.exists(os.path.join(t, 'local_mean_heights.txt'))
        assert tgeotiff.read(os.path.join(t, 'height_map.tif')).shape == \
            (TILE, TILE)
    labels = [k.split(')')[0] for k in triplet['times']]
    assert labels == ['1', '2', '3', '4', '5a', '5b', '5c', '5d', '5', '6',
                      '7']
    for i in (1, 2):
        assert os.path.exists(os.path.join(
            out, f'global_mean_height_pair_{i}.txt'))


def test_triplet_stage_5a_against_jax(triplet):
    """Each pair's height map of stage 5a: the same NaN set, altitudes
    within ALT_TOL_M; the batch's shape buckets the JAX package's."""
    worst, n = 0.0, 0
    for t in _tiles_of(os.path.join(triplet['base'], 'torch5a')):
        rel = os.path.relpath(t, os.path.join(triplet['base'], 'torch5a'))
        for i in (1, 2):
            a, b = _both(triplet, 'jax5a', 'torch5a',
                         os.path.join(rel, f'pair_{i}', 'height_map.tif'))
            x, y = jgeotiff.read(a), tgeotiff.read(b)
            assert x.shape == y.shape and y.dtype == np.float32
            assert np.array_equal(np.isnan(x), np.isnan(y))
            fin = np.isfinite(y)
            assert fin.mean() > 0.5
            worst = max(worst, float(np.abs(x[fin] - y[fin]).max()))
            n += 1
    # the buckets of the batch: (padded grid, padded mask, has dy) of
    # every tile pair, by each package's own prep of the same job
    keys = {}
    for name, tri in (('jax', jtri), ('torch', ttri)):
        keys[name] = []
        for t, i in triplet['pairs']:
            d = os.path.join(t['dir'], f'pair_{i}')
            x, y, w, h = t['coordinates']
            cam = triplet['cfg'].images
            job = tri.height_map_job(
                x, y, w, h, cam[0].rpcm, cam[i].rpcm,
                np.loadtxt(os.path.join(d, 'H_ref.txt')),
                np.loadtxt(os.path.join(d, 'H_sec.txt')),
                tgeotiff.read(os.path.join(d, 'rectified_disp.tif')),
                tgeotiff.read_png(os.path.join(d, 'rectified_mask.png')),
                tgeotiff.read_png(os.path.join(t['dir'], 'mask.png')),
                A=np.eye(3))
            dev, _ = tri._prep_triangulation(
                *[job[k] for k in ('rpc1', 'rpc2', 'H1', 'H2', 'disp',
                                   'mask_rect', 'img_bbx', 'mask_orig')])
            keys[name].append((dev['dx'].shape, dev['mask_orig'].shape,
                               dev['dy'] is not None))
    assert keys['torch'] == keys['jax']
    n_t = len(keys['torch']) // 2
    shared = sum(a == b for a, b in zip(keys['torch'][:n_t],
                                        keys['torch'][n_t:]))
    print(f'stage 5a: {n} height maps, altitudes within {worst:.3g} m; '
          f"{len(set(keys['torch']))} shape buckets, both pairs in one "
          f'bucket for {shared} of {n_t} tiles')
    assert worst <= ALT_TOL_M


def test_triplet_mean_heights_against_jax(triplet):
    """5b and 5c on the same stage-4 tree: the local and global mean
    heights within ALT_TOL_M."""
    worst = 0.0
    for t in _tiles_of(os.path.join(triplet['base'], 'torch')):
        rel = os.path.relpath(t, os.path.join(triplet['base'], 'torch'))
        a, b = _both(triplet, 'jax5', 'torch',
                     os.path.join(rel, 'local_mean_heights.txt'))
        x, y = np.loadtxt(a), np.loadtxt(b)
        assert x.shape == y.shape == (2,) and np.isfinite(y).all()
        worst = max(worst, float(np.abs(x - y).max()))
    g = []
    for i in (1, 2):
        a, b = _both(triplet, 'jax5', 'torch',
                     f'global_mean_height_pair_{i}.txt')
        g.append((float(np.loadtxt(a)), float(np.loadtxt(b))))
    d = max(abs(x - y) for x, y in g)
    print(f'mean heights: local within {worst:.3g} m, global within '
          f'{d:.3g} m: {g}')
    assert worst <= ALT_TOL_M and d <= ALT_TOL_M


def _nan_state(runs, rel):
    """(share of pixels NaN in one run only, largest |difference| where
    both are finite, the port's finite share) of a map in the JAX
    package's run from stage 5 and the port's run, on the same stage-4
    files."""
    a, b = _both(runs, 'jax5', 'torch', rel)
    x, y = jgeotiff.read(a), tgeotiff.read(b)
    assert x.shape == y.shape
    differ = float((np.isnan(x) != np.isnan(y)).mean())
    fin = np.isfinite(x) & np.isfinite(y)
    return differ, float(np.abs(x[fin] - y[fin]).max()), \
        float(np.isfinite(y).mean())


def test_triplet_fused_height_maps_against_jax(triplet):
    """5d on the same stage-4 tree: the fused height_map.tif and each
    pair's despeckled map, the share of pixels whose NaN state differs
    (printed, at most NAN_STATE_SHARE) and the values within ALT_TOL_M
    where both are finite."""
    root = os.path.join(triplet['base'], 'torch')
    for t in _tiles_of(root):
        rel = os.path.relpath(t, root)
        for name in ('height_map.tif', 'pair_1/height_map.tif',
                     'pair_2/height_map.tif'):
            differ, d, share = _nan_state(triplet, os.path.join(rel, name))
            print(f'{rel}/{name}: {share:.4f} finite, NaN state differs on '
                  f'{differ:.5f} of the pixels, values within {d:.3g} m')
            assert differ <= NAN_STATE_SHARE and d <= ALT_TOL_M
            assert share > 0.5


def test_triplet_dsm_within_the_triplet_tolerances(triplet):
    from test_end2end import compare_dsm
    a, b = _both(triplet, 'jax5', 'torch', 'dsm.tif')
    x, y = jgeotiff.read_with_nans(a), tgeotiff.read_with_nans(b)
    print(f'dsm.tif from stage 5: {np.isfinite(y).sum()} valid cells '
          f'against {np.isfinite(x).sum()}, shape {y.shape}')
    assert np.isfinite(y).mean() > 0.5
    compare_dsm(y, x, 0.05, 2)


def test_triplet_cloud_at_the_scene_altitude(triplet):
    """The port's own fused clouds (the full run) against the rendered
    ground: median and 90th percentile of |z - H0| within
    CLOUD_ALT_TOL_M."""
    z = np.concatenate([tply.read_ply(os.path.join(t, 'cloud.ply'))[0][:, 2]
                        for t in _tiles_of(os.path.join(triplet['base'],
                                                        'torch'))])
    err = np.abs(z - H0)
    med, p90 = float(np.median(err)), float(np.percentile(err, 90))
    print(f'fused clouds: {len(z)} points, |z - {H0}| median {med:.3f} m, '
          f'90th percentile {p90:.3f} m')
    assert len(z) > 0.5 * len(_tiles_of(os.path.join(
        triplet['base'], 'torch'))) * TILE * TILE
    assert med <= CLOUD_ALT_TOL_M[0] and p90 <= CLOUD_ALT_TOL_M[1]


def test_triplet_resume_from_5_reproduces_the_dsm(triplet):
    """``main(start_from=5)`` (with ``clean_intermediate``, which changes
    no result) writes the full run's dsm.tif bitwise."""
    a, b = _both(triplet, 'torch', 'torchc', 'dsm.tif')
    _same(tgeotiff.read_with_nans(b), tgeotiff.read_with_nans(a))
    assert [k.split(')')[0] for k in triplet['timesc']] == \
        ['5a', '5b', '5c', '5d', '5', '6', '7']


@pytest.mark.parametrize('clean', [False, True], ids=['keep', 'clean'])
def test_triplet_file_sets_equal_jax(triplet, clean):
    """The port's run leaves the JAX package's file set from stage 5 on
    the same tree, per tile and per scene, with and without
    clean_intermediate."""
    a, b = _both(triplet, 'jaxc' if clean else 'jax5',
                 'torchc' if clean else 'torch', '')
    # the JAX package's compile cache lives beside its runs, not in them
    files = _tree_files(b)
    assert _tree_files(a) == files
    tile = os.path.relpath(_tiles_of(b)[0], b)
    left = {os.path.relpath(f, tile) for f in files if f.startswith(tile)}
    gone = {'height_map.tif', 'mask.png', 'pair_1/height_map.tif',
            'pair_1/H_ref.txt', 'pair_1/rectified_disp.tif'}
    assert not left & gone if clean else gone <= left
    print(f"{'clean' if clean else 'keep'}: {len(files)} files; a tile "
          f'keeps {sorted(left)}')


def test_single_tile_disparity_to_height_equals_the_batch(triplet, tmp_path):
    """``disparity_to_height`` of one tile pair writes the batch's
    ``height_map.tif`` (as stage 5a wrote it in the full run)."""
    src = os.path.join(triplet['base'], 'torch')
    out = str(tmp_path / 'one')
    shutil.copytree(src, out)
    cfg = dataclasses.replace(triplet['cfg'], out_dir=out)
    tile, i = triplet['pairs'][-1]
    tile = dict(tile, dir=tile['dir'].replace(src, out))
    tpipe.disparity_to_height(cfg, tile, i, device='cpu')
    rel = os.path.join(os.path.relpath(tile['dir'], out), f'pair_{i}',
                       'height_map.tif')
    assert _read(os.path.join(out, rel)) == \
        _read(os.path.join(triplet['base'], 'torch5a', rel))
