"""The port's entry, ``s2p_tpu_torch.pipeline.main(..., device="cpu")``,
against ``s2p_tpu.pipeline.main`` on one pair scene, from a config file
with relative paths to two GeoTIFFs that carry their cameras in the RPC
tag (written by the JAX package's writer).

The scene is ``test_torch_stage1.py``'s, widened to an ROI of 360 x 360 px
in 2 x 2 tiles of 180 px, so that every tile has neighbours: image 1 is
seeded smoothed noise, image 2 shows the ground at H0 through the second
camera with a pointing error of POINTING px across the epipolar lines.
The cameras are ``test_torch_triangulation.py``'s, their image offsets
moved to the ROI's centre (in float32 the RPC chain rounds less there).
Both packages run their device SIFT route (``sift_device`` 'device').

What is held, and how:
  * up to stage 3: the scene's ``config.json`` (parsed, out_dir replaced)
    and ``tiles.txt``, each tile's ``config.json`` and ``mask.png``, and
    ``pointing.txt`` byte for byte; the SIFT matches by
    ``test_torch_stage1.py``'s criterion (a match or two differ, so the
    scene's global pointing and each tile's ``H_sec.txt`` differ in their
    last printed digits: held within stated tolerances and printed);
    then stages 2 and 3 of the port on the JAX run's stage-1 files:
    ``global_pointing_pair_1.txt``, ``H_ref.txt``, ``H_sec.txt`` and
    ``disp_min_max.txt`` byte for byte, the rectified images within
    RECT_TOL of the JAX run (jitted there, op by op here);
  * stages 4 to 7 with ``start_from=4`` on a copy of the JAX run's tree:
    stage 4's files bitwise, the clouds within ALT_TOL and XY_TOL m;
  * stages 6 and 7 with ``start_from=6`` on a copy of the JAX run's tree:
    every ``dsm.tif`` and ``confidence.tif`` bitwise under both packages'
    readers, their profiles equal;
  * end to end: the two ``dsm.tif`` at the reference's pair tolerances
    (``tests/test_end2end.py`` ``compare_dsm``);
  * ``main`` from stage 4 with ``mgm_multi`` and ``mgm_multi_lsd``:
    ``dsm.tif`` within stated bounds of the mgm run's, and ``mgm_multi``'s
    stage-4 files byte for byte against the JAX package's driver;
  * ``main`` from stage 2 in two OS processes over a gloo group, with
    ``clean_intermediate`` on: disjoint blocks of tiles that cover
    ``tiles.txt``, and the one-process ``dsm.tif`` bitwise;
  * ``main`` from stage 4 with ``sgbm``: stage 4's files against the JAX
    package's per-tile stage 4 on the same stage-3 files, no confidence
    file, a ``dsm.tif``;
  * ``main``'s resume contracts and its refusals.

``pytest -s`` prints the measured figures.
"""

import dataclasses
import filecmp
import glob
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from s2p_tpu import config as jconfig
from s2p_tpu import device as jdevice
from s2p_tpu import pipeline as jpipe
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu.geo import ply as jply
from s2p_tpu.ops import sift as jsift
from s2p_tpu_torch import config as tconfig
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch import tiling as ttiling
from s2p_tpu_torch.geo import geotiff as tgeotiff
from s2p_tpu_torch.ops import sift as tsift

from test_end2end import compare_dsm
from test_torch_sift import one_thread  # noqa: F401 (autouse fixture)
from test_torch_triangulation import cameras

H0 = 500.0
POINTING = 0.7
SHAPE = (560, 660)
ROI = {'x': 150, 'y': 110, 'w': 360, 'h': 360}
TILE = 180
STAGE3 = ('H_ref.txt', 'H_sec.txt', 'disp_min_max.txt')
STAGE4 = ('rectified_disp.tif', 'rectified_disp_confidence.tif')
MATCH_SHARE, MATCH_TOL, COUNT_SHARE = 0.99, 0.01, 0.01
H_TOL = 1e-3          # entries of H_sec, full chain (px)
GLOBAL_TOL = 1e-5     # entries of the global pointing, full chain
RECT_TOL = 0.1
ALT_TOL, XY_TOL = 2e-3, 1e-3


def _cams():
    """(JAX cameras, port cameras), image offsets at the ROI's centre."""
    j1, j2, _, _ = cameras(same_rows=True)
    cx, cy = ROI['x'] + ROI['w'] / 2, ROI['y'] + ROI['h'] / 2
    js = [dataclasses.replace(j, col_offset=cx, row_offset=cy)
          for j in (j1, j2)]
    return js, [state.rpc_from_state(dataclasses.asdict(j)) for j in js]


def _render(root):
    """The two RPC-tagged images and a config file per package (relative
    paths, out_dir ``jax`` or ``torch``)."""
    (j1, j2), (t1, t2) = _cams()
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
    jgeotiff.write(os.path.join(root, 'img_1.tif'), img1, rpc=j1)
    jgeotiff.write(os.path.join(root, 'img_2.tif'), img2, rpc=j2)
    for name in ('jax', 'torch'):
        with open(os.path.join(root, f'{name}.json'), 'w') as f:
            json.dump({'out_dir': name,
                       'images': [{'img': 'img_1.tif'}, {'img': 'img_2.tif'}],
                       'roi': ROI, 'tile_size': TILE,
                       'rpc_alt_range_scale_factor': 0.2,
                       'sift_device': 'device', 'use_srtm': False,
                       'out_geoid': False}, f, indent=2)


def _user_cfg(base, name, out=None):
    d = tconfig.read_config_file(os.path.join(base, f'{name}.json'))
    if out is not None:
        d['out_dir'] = out
    return d


def _tiles(out):
    return sorted(glob.glob(os.path.join(out, 'tiles', '*', '*')))


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == 'f')


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    """The scene, the JAX run, the port's run, and the port's stages 4-7
    and 6-7 on copies of the JAX run's tree."""
    root = tmp_path_factory.mktemp('scene')
    base = str(root / 'base')
    _render(base)
    # the JAX run's compile cache goes to a temporary directory; the
    # variable, the JAX package's configuration and SIFT's mode are put
    # back after it
    import jax
    keys = ('jax_compilation_cache_dir',
            'jax_persistent_cache_min_compile_time_secs')
    saved = ({k: getattr(jax.config, k) for k in keys},
             os.environ.get('S2P_TPU_JAX_CACHE'), jdevice._configured,
             jsift._DEVICE_MODE)
    os.environ['S2P_TPU_JAX_CACHE'] = str(root / 'jax_cache')
    jdevice._configured = False
    try:
        jdevice.configure(str(root / 'jax_cache'))
        jpipe.main(jconfig.read_config_file(os.path.join(base, 'jax.json')))
    finally:
        for k, v in saved[0].items():
            jax.config.update(k, v)
        if saved[1] is None:
            os.environ.pop('S2P_TPU_JAX_CACHE', None)
        else:
            os.environ['S2P_TPU_JAX_CACHE'] = saved[1]
        jdevice._configured = saved[2]
        jsift.set_device_mode(saved[3])
    tpipe.main(_user_cfg(base, 'torch'), device='cpu')
    runs = {'base': base, 'jax': os.path.join(base, 'jax'),
            'torch': os.path.join(base, 'torch')}
    for k in (4, 6):
        out = os.path.join(base, f'from_{k}')
        shutil.copytree(runs['jax'], out)
        tpipe.main(_user_cfg(base, 'jax', out), start_from=k, device='cpu')
        runs[k] = out
    return runs


def test_scene_files_up_to_stage_3(scene):
    jroot, troot = scene['jax'], scene['torch']
    cj = json.load(open(os.path.join(jroot, 'config.json')))
    ct = json.load(open(os.path.join(troot, 'config.json')))
    assert cj.pop('out_dir') == jroot and ct.pop('out_dir') == troot
    assert cj == ct
    assert _read(os.path.join(jroot, 'tiles.txt')) == \
        _read(os.path.join(troot, 'tiles.txt'))
    jt, tt = _tiles(jroot), _tiles(troot)
    assert [os.path.relpath(t, jroot) for t in jt] == \
        [os.path.relpath(t, troot) for t in tt] and len(jt) == 4
    worst_h = worst_rect = 0.0
    for a, b in zip(jt, tt):
        assert json.load(open(os.path.join(a, 'config.json'))) == \
            json.load(open(os.path.join(b, 'config.json')))
        _same(tgeotiff.read_png(os.path.join(b, 'mask.png')),
              jgeotiff.read_png(os.path.join(a, 'mask.png')))
        pa, pb = (os.path.join(t, 'pair_1') for t in (a, b))
        assert _read(os.path.join(pa, 'pointing.txt')) == \
            _read(os.path.join(pb, 'pointing.txt'))
        got, want = (np.loadtxt(os.path.join(p, 'sift_matches.txt'))
                     for p in (pb, pa))
        d, _ = cKDTree(want).query(got, k=1, p=np.inf)
        assert abs(len(got) - len(want)) <= COUNT_SHARE * len(want)
        assert (d <= MATCH_TOL).mean() >= MATCH_SHARE
        hd = max(np.abs(np.loadtxt(os.path.join(pa, n))
                        - np.loadtxt(os.path.join(pb, n))).max()
                 for n in STAGE3)
        worst_h = max(worst_h, hd)
        rd = max(np.nanmax(np.abs(tgeotiff.read(os.path.join(pb, n))
                                  - jgeotiff.read(os.path.join(pa, n))))
                 for n in ('rectified_ref.tif', 'rectified_sec.tif'))
        worst_rect = max(worst_rect, rd)
        print(f'{os.path.relpath(a, jroot)}: {len(got)} matches against '
              f'{len(want)}, {(d <= MATCH_TOL).mean():.4f} within '
              f'{MATCH_TOL} px; stage-3 text files within {hd:.3g}; '
              f'rectified images within {rd:.3g}')
    g = np.abs(np.loadtxt(os.path.join(jroot, 'global_pointing_pair_1.txt'))
               - np.loadtxt(os.path.join(troot,
                                         'global_pointing_pair_1.txt'))).max()
    print(f'full chain: global pointing within {g:.3g}, H and ranges '
          f'within {worst_h:.3g}, rectified images within {worst_rect:.3g}')
    assert g <= GLOBAL_TOL and worst_h <= H_TOL and worst_rect <= RECT_TOL


def test_stages_2_and_3_on_the_jax_stage_1_files(scene, tmp_path):
    """The port's stages 2 and 3 on a copy of the JAX run's tree, its
    stage-1 files: the text files byte for byte, the images within
    RECT_TOL."""
    out = str(tmp_path / 'from_2')
    shutil.copytree(scene['jax'], out)
    cfg = tpipe.build_cfg(_user_cfg(scene['base'], 'jax', out))
    tw, th = ttiling.adjust_tile_size(cfg)
    tiles = ttiling.tiles_full_info(cfg, tw, th,
                                    os.path.join(out, 'tiles.txt'))
    tpipe.global_pointing_correction(cfg, tiles)
    tpipe.rectification_all(cfg, [(t, 1) for t in tiles], device='cpu')
    assert filecmp.cmp(os.path.join(out, 'global_pointing_pair_1.txt'),
                       os.path.join(scene['jax'],
                                    'global_pointing_pair_1.txt'),
                       shallow=False)
    worst = 0.0
    for a, b in zip(_tiles(scene['jax']), _tiles(out)):
        for n in STAGE3:
            assert _read(os.path.join(a, 'pair_1', n)) == \
                _read(os.path.join(b, 'pair_1', n)), n
        for n in ('rectified_ref.tif', 'rectified_sec.tif'):
            x = jgeotiff.read(os.path.join(a, 'pair_1', n))
            y = tgeotiff.read(os.path.join(b, 'pair_1', n))
            assert x.shape == y.shape
            assert np.array_equal(np.isnan(x), np.isnan(y))
            worst = max(worst, float(np.nanmax(np.abs(x - y))))
    print(f'stage 3 on the same stage-1 files: rectified images within '
          f'{worst:.3g}')
    assert worst <= RECT_TOL


def test_stages_4_to_7_on_the_jax_stage_3_files(scene):
    worst = np.zeros(3)
    for a, b in zip(_tiles(scene['jax']), _tiles(scene[4])):
        for n in STAGE4:
            _same(tgeotiff.read(os.path.join(b, 'pair_1', n)),
                  jgeotiff.read(os.path.join(a, 'pair_1', n)))
        _same(tgeotiff.read_png(os.path.join(b, 'pair_1',
                                             'rectified_mask.png')),
              jgeotiff.read_png(os.path.join(a, 'pair_1',
                                             'rectified_mask.png')))
        pa, _ = jply.read_ply(os.path.join(a, 'cloud.ply'))
        pb, _ = jply.read_ply(os.path.join(b, 'cloud.ply'))
        # the PLY keeps the finite points: equal counts, the same pixels
        assert pa.shape == pb.shape
        worst = np.maximum(worst, np.abs(pa[:, :3] - pb[:, :3]).max(0))
        _same(pa[:, 3:], pb[:, 3:])
    print(f'stage 5 on the same stage-4 files: x, y and altitude within '
          f'{worst.tolist()} m')
    assert worst[0] <= XY_TOL and worst[1] <= XY_TOL and worst[2] <= ALT_TOL


def _profiles_equal(path):
    pj, pt = jgeotiff.read_profile(path), tgeotiff.read_profile(path)
    assert (pj.width, pj.height, pj.dtype, pj.transform) == \
        (pt.width, pt.height, pt.dtype, pt.transform)
    assert pj.crs.epsg == pt.crs.epsg and np.isnan(pj.nodata) \
        and np.isnan(pt.nodata)
    return pj


def test_stages_6_and_7_bitwise_on_the_jax_clouds(scene):
    jroot, troot = scene['jax'], scene[6]
    pairs = [(os.path.join(a, n), os.path.join(b, n))
             for a, b in zip(_tiles(jroot), _tiles(troot))
             for n in ('dsm.tif', 'confidence.tif')]
    pairs += [(os.path.join(jroot, n), os.path.join(troot, n))
              for n in ('dsm.tif', 'confidence.tif')]
    for a, b in pairs:
        want = jgeotiff.read_with_nans(a)
        for read in (jgeotiff.read_with_nans, tgeotiff.read_with_nans):
            _same(read(b), want)
        pa, pb = _profiles_equal(a), _profiles_equal(b)
        assert (pa.width, pa.height, pa.dtype, pa.transform,
                pa.crs.epsg) == (pb.width, pb.height, pb.dtype,
                                 pb.transform, pb.crs.epsg)
    prof = tgeotiff.read_profile(os.path.join(troot, 'dsm.tif'))
    assert prof.crs.epsg == 32740 and prof.transform[0] == 4.0


def test_end_to_end_dsm_within_the_pair_tolerances(scene):
    a = jgeotiff.read_with_nans(os.path.join(scene['jax'], 'dsm.tif'))
    b = tgeotiff.read_with_nans(os.path.join(scene['torch'], 'dsm.tif'))
    print(f'end to end: {np.isfinite(b).sum()} valid cells against '
          f'{np.isfinite(a).sum()}, shape {b.shape}')
    assert np.isfinite(b).mean() > 0.5
    compare_dsm(b, a, 0.025, 1)


def test_seamless_global_dsm(scene):
    """The mosaic equals one rasterization of all the tiles' clouds."""
    from s2p_tpu_torch.ops import rasterize
    clouds = [os.path.join(t, 'cloud.ply') for t in _tiles(scene['torch'])]
    raster, _ = rasterize.plyflatten_from_plyfiles_list(clouds, 4.0)
    _same(tgeotiff.read_with_nans(os.path.join(scene['torch'], 'dsm.tif')),
          raster[:, :, 0])


def test_resume_from_5_reproduces_the_dsm(scene, tmp_path):
    """``start_from=5`` on a tree the port finished from stage 4."""
    out = str(tmp_path / 'resumed')
    shutil.copytree(scene[4], out)
    times = {}
    tpipe.main(_user_cfg(scene['base'], 'jax', out), start_from=5,
               device='cpu', stage_times=times)
    _same(tgeotiff.read_with_nans(os.path.join(out, 'dsm.tif')),
          tgeotiff.read_with_nans(os.path.join(scene[4], 'dsm.tif')))
    assert set(times) == {'5) triangulating tiles...',
                                      '6) computing DSM by tile...',
                                      '7) computing global DSM...'}


def test_resume_after_clean_intermediate_raises(scene, tmp_path):
    out = tmp_path / 'cleaned'
    shutil.copytree(scene['torch'], out)
    for p in glob.glob(str(out / 'tiles' / '*' / '*' / 'pair_1'
                           / 'rectified_disp.tif')):
        os.remove(p)
    with pytest.raises(RuntimeError, match='clean_intermediate'):
        tpipe.main(_user_cfg(scene['base'], 'torch', str(out)),
                   start_from=5, device='cpu')


def test_resume_on_a_fresh_dir_raises(scene, tmp_path):
    with pytest.raises(AssertionError, match='tiles.txt'):
        tpipe.main(_user_cfg(scene['base'], 'torch', str(tmp_path / 'new')),
                   start_from=5, device='cpu')


@pytest.mark.parametrize('change,match', [
    (dict(sift_device='host'), None),
    (dict(matching_algorithm='sgm'), 'unknown matching algorithm'),
    (dict(matching_algorithm='micmac'), 'MicMac')])
def test_refused_up_front(scene, tmp_path, monkeypatch, change, match):
    """What no engine runs (an unknown matcher, ``micmac``) raises before
    anything is written.  ``sift_device='host'``, which raised before its
    route was ported, passes the checks, and ``main`` sets SIFT's route
    as the JAX package's ``main`` does on the same config (stage 1 itself
    is stubbed here: ``test_torch_stage1.py`` holds its files)."""
    d = _user_cfg(scene['base'], 'torch', str(tmp_path / 'out'))
    d.update(change)
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            tpipe.main(d, device='cpu')
        assert not os.path.exists(tmp_path / 'out')
        return

    class Stop(Exception):
        pass

    modes = {}

    def stop(name, module):
        def stub(*a, **k):
            modes[name] = module._DEVICE_MODE
            raise Stop
        return stub

    monkeypatch.setattr(tpipe, 'pointing_correction_all',
                        stop('torch', tsift))
    monkeypatch.setattr(jpipe, 'pointing_correction_all', stop('jax', jsift))
    # no compile cache or device warm-up for a run that stops at stage 1
    monkeypatch.setattr(jdevice, 'configure', lambda *a, **k: None)
    monkeypatch.setattr(jdevice, 'warm_transfer_async', lambda: None)
    jd = _user_cfg(scene['base'], 'jax', str(tmp_path / 'jax_out'))
    jd.update(change)
    try:
        with pytest.raises(Stop):
            tpipe.main(d, device='cpu')
        with pytest.raises(Stop):
            jpipe.main(jd)
    finally:
        tsift.set_device_mode('auto')
        jsift.set_device_mode('auto')
    assert modes == {'torch': 'host', 'jax': 'host'}


@pytest.mark.parametrize('algo', ['mgm_multi', 'mgm_multi_lsd'])
def test_cascade_matchers_through_main(scene, tmp_path, algo):
    """``main`` from stage 4 with the cascade matchers on a copy of the
    JAX run's tree writes ``dsm.tif``, within the JAX package's mgm_multi
    sanity bounds of the mgm run's (``tests/test_end2end.py``: |mean|
    0.05 m, p99 2 m, valid counts within 5%); with ``mgm_multi`` its
    stage-4 files equal the JAX package's batch driver's on the same
    stage-3 files."""
    out = str(tmp_path / algo)
    shutil.copytree(scene['jax'], out)
    d = _user_cfg(scene['base'], 'jax', out)
    d['matching_algorithm'] = algo
    tpipe.main(d, start_from=4, device='cpu')
    if algo == 'mgm_multi':
        ref = str(tmp_path / 'jax_stage4')
        shutil.copytree(scene['jax'], ref)
        jpipe.stereo_matching_all(
            jconfig.Config(out_dir=ref, matching_algorithm=algo),
            [({'dir': t}, 1) for t in _tiles(ref)])
        for a, b in zip(_tiles(ref), _tiles(out)):
            for n in STAGE4:
                assert _read(os.path.join(a, 'pair_1', n)) == \
                    _read(os.path.join(b, 'pair_1', n)), n
            _same(tgeotiff.read_png(os.path.join(b, 'pair_1',
                                                 'rectified_mask.png')),
                  jgeotiff.read_png(os.path.join(a, 'pair_1',
                                                 'rectified_mask.png')))
    got = tgeotiff.read_with_nans(os.path.join(out, 'dsm.tif'))
    want = tgeotiff.read_with_nans(os.path.join(scene[4], 'dsm.tif'))
    assert got.shape == want.shape and np.isfinite(got).mean() > 0.5
    np.testing.assert_allclose(np.isfinite(got).sum(),
                               np.isfinite(want).sum(), rtol=0.05)
    diff = (got - want)[np.isfinite(got - want)]
    print(f'{algo} against mgm: mean {diff.mean():.4g} m, p99 '
          f'{np.percentile(np.abs(diff), 99):.4g} m')
    assert abs(diff.mean()) <= 0.05
    assert np.percentile(np.abs(diff), 99) <= 2.0


_MAIN_WORKER = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[4])
torch.set_num_threads(1)
from s2p_tpu_torch import pipeline
from s2p_tpu_torch.parallel import distributed as dist
port, k, cfg_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init(f'localhost:{port}', 2, k)
cfg = json.load(open(cfg_path))
times = {}
pipeline.main(cfg, start_from=2, device='cpu', stage_times=times)
with open(cfg['out_dir'] + '/tiles.txt') as f:
    tiles = [line.strip() for line in f if line.strip()]
with open(cfg['out_dir'] + f'/worker_tiles_{k}.json', 'w') as f:
    json.dump({'tiles': dist.partition_tiles(tiles), 'times': times}, f)
"""


def test_two_processes_give_the_one_process_dsm(scene, tmp_path):
    """``main`` from stage 2 in two OS processes (gloo over a free
    localhost port) on a copy of the one-process run's tree, with
    ``clean_intermediate`` on: the blocks are disjoint and cover the
    tiling, both processes work, and ``dsm.tif`` equals the one-process
    run's bitwise."""
    out = str(tmp_path / 'two')
    shutil.copytree(scene['torch'], out)
    os.remove(os.path.join(out, 'dsm.tif'))
    d = _user_cfg(scene['base'], 'torch', out)
    d['clean_intermediate'] = True
    cfg_path = str(tmp_path / 'two.json')
    with open(cfg_path, 'w') as f:
        json.dump(d, f)
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _MAIN_WORKER, str(port), str(k), cfg_path,
         root], cwd=root, env=dict(os.environ, OMP_NUM_THREADS='1'),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for k in (0, 1)]
    logs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for k, p in enumerate(procs):
        assert p.returncode == 0, f'process {k} failed:\n{logs[k][-4000:]}'
    parts = [json.load(open(os.path.join(out, f'worker_tiles_{k}.json')))
             for k in (0, 1)]
    with open(os.path.join(out, 'tiles.txt')) as f:
        tiles = [line.strip() for line in f if line.strip()]
    a, b = parts[0]['tiles'], parts[1]['tiles']
    assert a and b and not set(a) & set(b)
    assert sorted(a + b) == sorted(tiles) and len(tiles) == 4
    for k, part in enumerate(parts):
        print(f'process {k}: tiles {part["tiles"]}, stage seconds '
              f'{ {n[:2]: round(t, 2) for n, t in part["times"].items()} }')
    _same(tgeotiff.read_with_nans(os.path.join(out, 'dsm.tif')),
          tgeotiff.read_with_nans(os.path.join(scene['torch'], 'dsm.tif')))
    # the sweeps of clean_intermediate ran in both processes
    for t in _tiles(out):
        assert not os.path.exists(os.path.join(t, 'pair_1', 'pointing.txt'))
        assert not os.path.exists(os.path.join(t, 'pair_1',
                                               'rectified_disp.tif'))


def test_sgbm_through_main(scene, tmp_path):
    """``main`` from stage 4 with ``sgbm`` on a copy of the JAX run's
    tree: stage 4's disparity and mask equal the JAX package's per-tile
    stage 4 (``stereo_matching_all``) on the same stage-3 files, no
    confidence file is written (the matcher has none), and ``dsm.tif``
    is."""
    out = str(tmp_path / 'sgbm')
    shutil.copytree(scene['jax'], out)
    d = _user_cfg(scene['base'], 'jax', out)
    d['matching_algorithm'] = 'sgbm'
    for t in _tiles(out):
        os.remove(os.path.join(t, 'pair_1', STAGE4[1]))
    times = {}
    tpipe.main(d, start_from=4, device='cpu', stage_times=times)
    ref = str(tmp_path / 'jax_stage4')
    shutil.copytree(scene['jax'], ref)
    for t in _tiles(ref):
        os.remove(os.path.join(t, 'pair_1', STAGE4[1]))
    jpipe.stereo_matching_all(
        jconfig.Config(out_dir=ref, matching_algorithm='sgbm'),
        [({'dir': t}, 1) for t in _tiles(ref)])
    for a, b in zip(_tiles(ref), _tiles(out)):
        assert _read(os.path.join(a, 'pair_1', STAGE4[0])) == \
            _read(os.path.join(b, 'pair_1', STAGE4[0]))
        _same(tgeotiff.read_png(os.path.join(b, 'pair_1',
                                             'rectified_mask.png')),
              jgeotiff.read_png(os.path.join(a, 'pair_1',
                                             'rectified_mask.png')))
        for t in (a, b):
            assert not os.path.exists(os.path.join(t, 'pair_1', STAGE4[1]))
    got = tgeotiff.read_with_nans(os.path.join(out, 'dsm.tif'))
    assert np.isfinite(got).mean() > 0.3
    print(f'sgbm through main: stage 4 '
          f'{times["4) running stereo matching..."]:.2f} s, '
          f'{np.isfinite(got).mean():.3f} of dsm.tif valid')


def test_main_without_a_device_needs_cuda(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tpipe.main(_user_cfg(scene['base'], 'torch', str(tmp_path / 'o')))
    assert not os.path.exists(tmp_path / 'o')


def test_single_tile_disparity_to_ply_equals_the_batch(scene, tmp_path):
    """``disparity_to_ply`` of one tile writes the batch's ``cloud.ply``;
    with the tile's stage-4 files gone it raises."""
    out = str(tmp_path / 'one')
    shutil.copytree(scene[4], out)
    cfg = tpipe.build_cfg(_user_cfg(scene['base'], 'jax', out))
    tw, th = ttiling.adjust_tile_size(cfg)
    tiles = ttiling.tiles_full_info(cfg, tw, th,
                                    os.path.join(out, 'tiles.txt'))
    os.remove(os.path.join(tiles[1]['dir'], 'cloud.ply'))
    tpipe.disparity_to_ply(cfg, tiles[1], device='cpu')
    assert _read(os.path.join(tiles[1]['dir'], 'cloud.ply')) == \
        _read(os.path.join(_tiles(scene[4])[1], 'cloud.ply'))
    os.remove(os.path.join(tiles[2]['dir'], 'pair_1', 'rectified_disp.tif'))
    with pytest.raises(OSError):
        tpipe.disparity_to_ply(cfg, tiles[2], device='cpu')
