"""The port's stage 4 (device="cpu") against the JAX package's on the same
tile files, and the host pieces it runs: range policy, rejection mask,
erosion, configuration state, TIFF and PNG IO."""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

from s2p_tpu import pipeline as jpipe
from s2p_tpu.config import Config as JConfig
from s2p_tpu.core import masking as jmasking
from s2p_tpu.core import matching as jmatching
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch.core import masking as tmasking
from s2p_tpu_torch.core import matching as tmatching
from s2p_tpu_torch.geo import geotiff as tgeotiff

_OUTPUTS = ('rectified_disp.tif', 'rectified_mask.png',
            'rectified_disp_confidence.tif')


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _tiles(root, specs):
    """Rectified tile files written with the JAX package's writer."""
    tiles = []
    for k, (h, w, d, dmin, dmax) in enumerate(specs):
        rng = np.random.RandomState(k)
        tex = rng.rand(h, w + 8).astype(np.float32) * 200
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3
        xs = np.arange(w + 8, dtype=np.float32)
        ref = np.stack([np.interp(xs + d, xs, row) for row in tex])[:, :w]
        sec = tex[:, :w - k].copy()
        ref = ref.astype(np.float32)
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


def test_stereo_matching_all_matches_jax(tmp_path):
    # two tiles share the (64, 128, 16) bucket, the third is alone in
    # (64, 64, 32)
    specs = [(58, 90, 3.0, -3.2, 9.5), (50, 80, 2.0, -6, 5),
             (30, 60, 4.0, -2, 20)]
    jroot, troot = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    jtiles, ttiles = _tiles(jroot, specs), _tiles(troot, specs)
    jcfg = JConfig(out_dir=str(tmp_path))
    jpipe.stereo_matching_all(jcfg, jtiles)
    tpipe.stereo_matching_all(state.config_from_state(jcfg.to_dict()),
                              ttiles, device='cpu')
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
                _same(read(jp), ref)
        disp = tgeotiff.read(os.path.join(tt['dir'], 'pair_1', _OUTPUTS[0]))
        assert np.isfinite(disp).mean() > 0.5


@pytest.mark.parametrize('width,dmin,dmax,max_range', [
    (100, -10.4, 20.6, None), (50, -80.0, 60.0, None), (100, -3, 3, None),
    (100, -10.0, 30.5, 40), (100, -10.0, 30.5, 30)])
def test_clamp_disparity_range_matches(width, dmin, dmax, max_range):
    jcfg = JConfig(max_disp_range=max_range)
    tcfg = state.config_from_state(jcfg.to_dict())
    try:
        ref = jmatching.clamp_disparity_range(jcfg, width, dmin, dmax)
    except jmatching.MaxDisparityRangeError as e:
        with pytest.raises(tmatching.MaxDisparityRangeError, match=str(e)
                           .replace('[', r'\[').replace(']', r'\]')):
            tmatching.clamp_disparity_range(tcfg, width, dmin, dmax)
        return
    assert tmatching.clamp_disparity_range(tcfg, width, dmin, dmax) == ref


def test_finalize_disparity_matches():
    rng = np.random.RandomState(5)
    disp = (rng.rand(20, 31) * 12 - 4).astype(np.float32)
    disp[rng.rand(20, 31) < 0.2] = np.nan
    im1 = rng.rand(20, 31).astype(np.float32)
    im2 = rng.rand(20, 29).astype(np.float32)
    im1[:, :3] = np.nan
    im2[:, 10:12] = np.nan
    valid = np.isfinite(disp)
    ref = jmatching.finalize_disparity(disp, valid, im1, im2)
    ours = tmatching.finalize_disparity(disp, valid, im1, im2)
    for a, b in zip(ours, ref):
        _same(a, b)


@pytest.mark.parametrize('radius', [1, 2, 3])
def test_erosion_matches(radius):
    mask = np.random.RandomState(radius).rand(25, 33) < 0.8
    _same(tmasking.erosion(mask, radius), jmasking.erosion(mask, radius))


def test_config_state_carries_across():
    jcfg = JConfig(tile_size=640, msk_erosion=3, mgm_nb_directions=4,
                   stereo_regularity_multiplier=1.5,
                   mgm_leftright_control=0, max_disp_range=200)
    tcfg = state.config_from_state(jcfg.to_dict())
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    jv = dataclasses.asdict(jmatching.mgm_variant_from_cfg(jcfg))
    jv.pop('backend')
    assert dataclasses.asdict(tmatching.mgm_variant_from_cfg(tcfg)) == jv


@pytest.mark.parametrize('n_images', [2, 3])
def test_clean_intermediate_removes_dead_inputs(tmp_path, n_images):
    """Pair mode keeps rectified_ref.tif for stage 5; triplets drop it."""
    tiles = _tiles(str(tmp_path), [(20, 40, 2.0, -2, 6)])
    cfg = state.config_from_state({
        'clean_intermediate': True,
        'images': [{'img': f'im{i}.tif'} for i in range(n_images)]})
    tpipe.stereo_matching_all(cfg, tiles, device='cpu')
    left = sorted(os.listdir(os.path.join(tiles[0][0]['dir'], 'pair_1')))
    assert left == sorted(_OUTPUTS + (('rectified_ref.tif',)
                                      if n_images == 2 else ()))


def test_every_matcher_through_stage_4(tmp_path):
    """``hirschmuller02``, ``msmw`` and ``tvl1``, which raised before they
    were ported, write the JAX package's stage-4 files on the same tile
    (no confidence file; the maps by the criteria of ``test_torch_msmw
    .py`` and ``test_torch_tvl1.py``); ``micmac`` and an unknown name
    raise before any tile runs, as in the JAX package; ``sgbm``, which
    raised before it was ported, writes the JAX package's files on the
    same tiles (no confidence file: the matcher has none)."""
    from test_torch_msmw import check_msmw
    from test_torch_tvl1 import check_tvl1

    specs = [(30, 52, 2.0, -3, 6)]
    for algo, check in (('hirschmuller02', check_msmw), ('msmw', check_msmw),
                        ('tvl1', check_tvl1)):
        jroot, troot = (str(tmp_path / algo / n) for n in ('jax', 'torch'))
        jtiles, ttiles = _tiles(jroot, specs), _tiles(troot, specs)
        jcfg = JConfig(out_dir=str(tmp_path), matching_algorithm=algo)
        jpipe.stereo_matching_all(jcfg, jtiles)
        tpipe.stereo_matching_all(state.config_from_state(jcfg.to_dict()),
                                  ttiles, device='cpu')
        jd, td = (os.path.join(t[0][0]['dir'], 'pair_1')
                  for t in (jtiles, ttiles))
        assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
        assert _OUTPUTS[2] not in os.listdir(td)
        check(*(((g.read(os.path.join(d, _OUTPUTS[0])),
                  g.read_png(os.path.join(d, _OUTPUTS[1])) > 0))
                for g, d in ((tgeotiff, td), (jgeotiff, jd))), algo)
    for algo, match in (('micmac', 'MicMac'),
                        ('sgm', 'unknown matching algorithm')):
        with pytest.raises(NotImplementedError, match=match):
            tpipe.stereo_matching_all(
                state.config_from_state({'matching_algorithm': algo}), [],
                device='cpu')
    jroot, troot = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    jtiles, ttiles = _tiles(jroot, specs), _tiles(troot, specs)
    jcfg = JConfig(out_dir=str(tmp_path), matching_algorithm='sgbm')
    jpipe.stereo_matching_all(jcfg, jtiles)
    tpipe.stereo_matching_all(state.config_from_state(jcfg.to_dict()),
                              ttiles, device='cpu')
    for (jt, _), (tt, _) in zip(jtiles, ttiles):
        jd, td = (os.path.join(t['dir'], 'pair_1') for t in (jt, tt))
        assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
        assert _OUTPUTS[2] not in os.listdir(td)
        _same(tgeotiff.read(os.path.join(td, _OUTPUTS[0])),
              jgeotiff.read(os.path.join(jd, _OUTPUTS[0])))
        _same(tgeotiff.read_png(os.path.join(td, _OUTPUTS[1])),
              jgeotiff.read_png(os.path.join(jd, _OUTPUTS[1])))
        assert np.isfinite(tgeotiff.read(os.path.join(td, _OUTPUTS[0]))) \
            .mean() > 0.3


def test_png_round_trips_through_pil(tmp_path):
    rng = np.random.RandomState(2)
    img = ((rng.rand(37, 53) > 0.4) * 255).astype(np.uint8)
    img[5:9] = rng.randint(0, 256, size=(4, 53))
    path = str(tmp_path / 'ours.png')
    tgeotiff.write_png(path, img)
    _same(np.array(Image.open(path)), img)
    _same(tgeotiff.read_png(path), img)
    # PIL chooses its own row filters: the reader undoes all five
    path = str(tmp_path / 'pil.png')
    smooth = (np.add.outer(np.arange(37), np.arange(53)) * 3 % 256) \
        .astype(np.uint8)
    for arr in (img, smooth, rng.randint(0, 256, (37, 53)).astype(np.uint8)):
        Image.fromarray(arr).save(path)
        _same(tgeotiff.read_png(path), arr)
    tgeotiff.write_png(path, img > 0)
    _same(tgeotiff.read_png(path), (img > 0).astype(np.uint8) * 255)


@pytest.mark.parametrize('dtype', [np.float32, np.uint8, np.int16,
                                   np.float64])
def test_tiff_io_matches_jax(tmp_path, dtype):
    rng = np.random.RandomState(np.dtype(dtype).itemsize)
    arr = (rng.rand(70, 45) * 100).astype(dtype)
    if arr.dtype.kind == 'f':
        arr[3:5, 7] = np.nan
    ours, ref = str(tmp_path / 'ours.tif'), str(tmp_path / 'ref.tif')
    tgeotiff.write(ours, arr, nodata=float('nan'))
    jgeotiff.write(ref, arr, nodata=float('nan'))
    with open(ours, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()
    _same(tgeotiff.read(ours), arr)
    # the reader also takes the JAX package's deflated tiles
    jgeotiff.write(ref, arr, compress='deflate', tiled=True)
    _same(tgeotiff.read(ref), arr)
