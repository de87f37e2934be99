"""The port's ``utils/`` against the JAX package's on the same inputs: a
finished run's tree like ``tests/test_utils_tools.py``'s ``mini_run`` (2
tiles with clouds, height maps and an RPC-tagged reference image), an
RPC-tagged GeoTIFF to rescale and an NITF blob with an RPC00B TRE.

LAS files, mosaics and rescaled images are compared byte for byte (the
port's GeoTIFF writer writes the JAX package's bytes), SVG and KML text
equal, arrays bitwise, the RPC from the TRE field by field.
"""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu.geo import ply as jply
from s2p_tpu.utils import exporters as jexp
from s2p_tpu.utils import mosaic as jmosaic
from s2p_tpu.utils import ntf as jntf
from s2p_tpu.utils import scale as jscale
from s2p_tpu.utils import tilemap as jtilemap
from s2p_tpu_torch import utils as tutils
from s2p_tpu_torch.geo import rpc_io as trpc_io
from s2p_tpu_torch.utils import exporters as texp
from s2p_tpu_torch.utils import mosaic as tmosaic
from s2p_tpu_torch.utils import ntf as tntf
from s2p_tpu_torch.utils import scale as tscale
from s2p_tpu_torch.utils import tilemap as ttilemap
from test_torch_triangulation import jax_rpc

_FIELDS = ('row_offset', 'col_offset', 'lat_offset', 'lon_offset',
           'alt_offset', 'row_scale', 'col_scale', 'lat_scale', 'lon_scale',
           'alt_scale', 'row_num', 'row_den', 'col_num', 'col_den')


def _bytes(path):
    with open(path, 'rb') as f:
        return f.read()


def _text(path):
    with open(path) as f:
        return f.read()


def _rpc():
    return dataclasses.replace(jax_rpc(1, 0.02), col_offset=20.0,
                               row_offset=15.0)


@pytest.fixture
def mini_run(tmp_path):
    """A finished run's tree: a 2 x 1 tile grid with clouds (one with
    colours, one without), height maps (the second tile's with NaN and a
    nodata value), and the reference image named by the tiles' configs,
    by its RPC tag for the first tile and by an RPC dict for the second."""
    ref = str(tmp_path / 'ref.tif')
    jgeotiff.write(ref, np.zeros((40, 60), np.float32), rpc=_rpc())
    rpc_dict = _rpc().to_dict()
    tiles = []
    for k in range(2):
        d = tmp_path / 'tiles' / 'row_0' / f'col_{k}'
        (d / 'pair_1').mkdir(parents=True)
        roi = {'x': 10 + 20 * k, 'y': 5, 'w': 20, 'h': 15}
        img = {'img': ref} if k == 0 else {'img': ref, 'rpc': rpc_dict}
        (d / 'config.json').write_text(json.dumps({
            'roi': roi, 'images': [img],
            'tile': {'coordinates': [roi['x'], roi['y'], roi['w'],
                                     roi['h']]}}))
        rng = np.random.RandomState(k)
        xyz = np.column_stack([rng.uniform(3e5, 3.1e5, 40),
                               rng.uniform(7.6e6, 7.61e6, 40),
                               rng.uniform(10, 20, 40)])
        colors = rng.randint(0, 255, (40, 3)).astype(np.uint8) if k == 0 \
            else None
        jply.write_ply(str(d / 'cloud.ply'), xyz, colors=colors,
                       comments=['projection: UTM 40S'])
        hmap = rng.uniform(0, 50, (15, 20)).astype(np.float32)
        if k:
            hmap[3:6, 4:9] = np.nan
            hmap[0, 0] = -9999
        jgeotiff.write(str(d / 'pair_1' / 'height_map.tif'), hmap,
                       nodata=-9999.0 if k else None)
        tiles.append(os.path.relpath(d / 'config.json', tmp_path))
    (tmp_path / 'tiles.txt').write_text('\n'.join(tiles) + '\n')
    return tmp_path


def test_package_exports_the_same_modules():
    for name in ('exporters', 'mosaic', 'scale', 'tilemap'):
        assert hasattr(tutils, name)


def test_mosaic_equals_jax(mini_run):
    tiles = str(mini_run / 'tiles.txt')
    outs = [str(mini_run / f'mosaic_{p}.tif') for p in ('jax', 'port')]
    want = jmosaic.main(tiles, outs[0], 'pair_1/height_map.tif')
    got = tmosaic.main(tiles, outs[1], 'pair_1/height_map.tif')
    assert got.dtype == want.dtype == np.float32 and got.shape == (15, 40)
    assert got.tobytes() == want.tobytes()
    assert np.isnan(got[5, 25]) and np.isnan(got[0, 20])
    assert _bytes(outs[0]) == _bytes(outs[1])
    # a missing tile is skipped with a warning by both
    os.remove(mini_run / 'tiles' / 'row_0' / 'col_1' / 'pair_1' /
              'height_map.tif')
    for mod, out in ((jmosaic, outs[0]), (tmosaic, outs[1])):
        with pytest.warns(UserWarning, match='missing tile'):
            mod.main(tiles, out, 'pair_1/height_map.tif')
    assert _bytes(outs[0]) == _bytes(outs[1])
    assert tmosaic.global_extent([{'roi': {'x': 3, 'y': 4, 'w': 5,
                                           'h': 6}}]) == (3, 4, 5, 6)


def test_tilemaps_equal_jax(mini_run):
    tiles = str(mini_run / 'tiles.txt')
    for fn, kw in (('svg_tilemap', {}), ('svg_tilemap', {'scale': 0.5}),
                   ('kml_tilemap', {}), ('kml_tilemap', {'alt': 120.0})):
        ext = fn[:3]
        getattr(jtilemap, fn)(tiles, str(mini_run / f'j.{ext}'), **kw)
        getattr(ttilemap, fn)(tiles, str(mini_run / f't.{ext}'), **kw)
        got = _text(mini_run / f't.{ext}')
        assert got == _text(mini_run / f'j.{ext}')
        assert got.count('<rect' if ext == 'svg' else '<Placemark') == 2


def test_clouds_and_las_equal_jax(mini_run, tmp_path, monkeypatch):
    want = jexp.gather_cloud(str(mini_run))
    got = texp.gather_cloud(str(mini_run))
    assert got.shape == (80, 6) and got.tobytes() == want.tobytes()
    for pts, name in ((got, 'rgb'), (got[:, :3], 'xyz')):
        jexp.write_las(str(tmp_path / f'j_{name}.las'), pts)
        texp.write_las(str(tmp_path / f't_{name}.las'), pts)
        raw = _bytes(tmp_path / f't_{name}.las')
        assert raw == _bytes(tmp_path / f'j_{name}.las')
        assert raw[:4] == b'LASF' and int.from_bytes(raw[107:111],
                                                     'little') == 80
        assert len(raw) == 227 + 26 * 80
    # the converters are not on PATH: both export LAS and warn
    monkeypatch.setenv('PATH', str(tmp_path / 'no_converters'))
    for fn, conv in (('export_potree', 'PotreeConverter'),
                     ('export_lidarviewer', 'LidarPreprocessor')):
        paths = []
        for mod, tag in ((jexp, 'j'), (texp, 't')):
            with pytest.warns(UserWarning, match=conv):
                paths.append(getattr(mod, fn)(
                    str(mini_run), str(tmp_path / f'{tag}_{fn}')))
        assert os.path.basename(paths[1]) == 'cloud.las'
        assert _bytes(paths[0]) == _bytes(paths[1])
    with pytest.raises(FileNotFoundError):
        texp.gather_cloud(str(tmp_path / 'no_run'))


@pytest.mark.parametrize('z', [0.5, 1.5])
def test_scale_image_and_rpc_equals_jax(tmp_path, z):
    rng = np.random.RandomState(4)
    img = (rng.rand(30, 41) * 1000).astype(np.float32)
    src = str(tmp_path / 'src.tif')
    jgeotiff.write(src, img, rpc=_rpc(), nodata=-1.0)
    outs = [str(tmp_path / f'{p}.tif') for p in ('j', 't')]
    jscale.scale_image_and_rpc(src, outs[0], z)
    tscale.scale_image_and_rpc(src, outs[1], z)
    assert _bytes(outs[0]) == _bytes(outs[1])
    got = jgeotiff.read(outs[1])
    assert got.shape == (round(30 * z), round(41 * z))
    assert got.tobytes() == jgeotiff.read(outs[0]).tobytes()
    assert jgeotiff.read_profile(outs[1]).rpc_tag == \
        jgeotiff.read_profile(outs[0]).rpc_tag
    rpc = trpc_io.rpc_from_geotiff(outs[1])
    assert rpc.col_offset == 20.0 * z and rpc.row_scale == 5000.0 * z
    scaled = tscale.scale_rpc(trpc_io.rpc_from_geotiff(src), z)
    want = jscale.scale_rpc(_rpc(), z)
    for f in _FIELDS:
        assert np.array_equal(getattr(scaled, f), getattr(want, f)), f


def _rpc00b(values):
    """An RPC00B TRE: SUCCESS, ERR_BIAS, ERR_RAND, then the offsets and
    scales and the 80 coefficients in their fixed widths."""
    widths = (6, 5, 8, 9, 5, 6, 5, 8, 9, 5)
    fmts = ('{:06.0f}', '{:05.0f}', '{:+08.4f}', '{:+09.4f}', '{:+05.0f}',
            '{:06.0f}', '{:05.0f}', '{:+08.4f}', '{:+09.4f}', '{:+05.0f}')
    head = ''.join(f.format(v) for f, v in zip(fmts, values[:10]))
    assert len(head) == sum(widths)
    coeffs = ''.join(f'{v:+.6E}'.replace('E+0', 'E+').replace('E-0', 'E-')
                     for v in values[10:])
    assert len(coeffs) == 80 * 12
    return ('1' + '0001.00' + '0000.50' + head + coeffs).encode()


def test_rpc_from_ntf_equals_jax(tmp_path):
    rng = np.random.RandomState(8)
    offsets = [20000, 17000, -21.0417, 55.3986, 350, 20500, 17500, 0.1023,
               0.1218, 500]
    coeffs = rng.uniform(-1, 1, 80) * 10.0 ** rng.randint(-7, 1, 80)
    coeffs[[0, 20, 40, 60]] = 1.0
    tre = _rpc00b(offsets + list(coeffs))
    blob = (b'NITF02.10' + b' ' * 300 + b'RPC00B' + b'%05d' % len(tre) + tre
            + b'\0' * 64)
    path = str(tmp_path / 'img.ntf')
    with open(path, 'wb') as f:
        f.write(blob)
    got, want = tntf.rpc_from_ntf(path), jntf.rpc_from_ntf(path)
    for f in _FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.row_offset, got.col_offset, got.lat_offset, got.lon_offset,
            got.alt_offset) == (20000, 17000, -21.0417, 55.3986, 350)
    text = [float(tre[15 + 66 + 12 * k:15 + 66 + 12 * (k + 1)])
            for k in range(80)]
    assert np.array_equal(np.concatenate([got.row_num, got.row_den,
                                          got.col_num, got.col_den]), text)
    np.testing.assert_allclose(text, coeffs, rtol=1e-6)
    with open(str(tmp_path / 'plain.ntf'), 'wb') as f:
        f.write(b'NITF02.10' + b' ' * 100)
    with pytest.raises(ValueError, match='RPC00B'):
        tntf.rpc_from_ntf(str(tmp_path / 'plain.ntf'))
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        tntf.rpc_from_rpc00b(tre)
