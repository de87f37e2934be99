"""The port's GeoTIFF reader (``geo/geotiff.py``: the profile, windowed
reads, strips and tiles, deflate, LZW and PackBits, the predictors)
against the JAX package's reader.

The compressed files come from PIL's libtiff encoder, which the JAX
package's writer does not use, so both readers decode a third party's
streams; each decode must also give back the array that was written.
"""

import numpy as np
import pytest
from PIL import Image

from s2p_tpu.geo import crs as jcrs
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu_torch.geo import geotiff as tgeotiff


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == 'f')


def _array(dtype, h=57, w=83, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(h, w) * 200
    # smooth ramps compress; a band of noise keeps every code path busy
    a[: h // 2] = np.add.outer(np.arange(h // 2), np.arange(w)) % 200
    return a.astype(dtype)


@pytest.mark.parametrize('compression,dtype,predictor', [
    ('tiff_lzw', np.uint8, None), ('tiff_lzw', np.uint16, 2),
    ('tiff_lzw', np.float32, 3), ('packbits', np.uint8, None),
    ('packbits', np.uint16, None), ('tiff_adobe_deflate', np.float32, 3),
    ('tiff_adobe_deflate', np.int32, 2)],
    ids=lambda v: getattr(v, '__name__', str(v)))
def test_compressed_files_equal_jax(tmp_path, compression, dtype, predictor):
    arr = _array(dtype)
    path = str(tmp_path / 'c.tif')
    info = {} if predictor is None else {317: predictor}
    Image.fromarray(arr).save(path, compression=compression, tiffinfo=info)
    got = tgeotiff.read(path)
    _same(got, arr)
    if predictor != 3:
        # the JAX package's reader decodes the floating-point predictor
        # wrongly (it reverses each value's bytes twice)
        _same(got, jgeotiff.read(path))
    if predictor is not None:
        assert tgeotiff._Tiff(path).tags[317] == predictor


@pytest.mark.parametrize('tiled', [False, True], ids=['strips', 'tiles'])
@pytest.mark.parametrize('compress', [None, 'deflate'])
def test_georeferenced_profile_and_windows_equal_jax(tmp_path, tiled,
                                                     compress):
    """The JAX package's writer (strips or 256 x 256 tiles, deflate or
    not, three bands or one): the profile and windowed, clipped and
    boundless reads."""
    arr = _array(np.float32, h=300, w=270)
    arr[5:9, 10:20] = -9999.0
    rgb = np.stack([arr, arr * 2, arr + 1], axis=-1)
    for k, a in enumerate((arr, rgb)):
        path = str(tmp_path / f'g{k}.tif')
        jgeotiff.write(path, a, crs=jcrs.CRS('epsg:32740'),
                       transform=(0.5, 0.0, 350000.0, 0.0, -0.5, 7680000.0),
                       nodata=-9999.0, compress=compress, tiled=tiled)
        tp, jp = tgeotiff.read_profile(path), jgeotiff.read_profile(path)
        for f in ('width', 'height', 'count', 'dtype', 'transform', 'nodata',
                  'rpc_tag', 'shape'):
            assert getattr(tp, f) == getattr(jp, f), f
        assert tp.crs.to_epsg() == jp.crs.to_epsg() == 32740
        _same(tgeotiff.read(path), jgeotiff.read(path))
        for window in ((10, 20, 50, 40), (250, 280, 40, 40), (0, 0, 1, 1),
                       (-5, -3, 20, 10)):
            _same(tgeotiff.read(path, window=window),
                  jgeotiff.read(path, window=window))
            _same(tgeotiff.read(path, window=window, boundless=True,
                                fill_value=0),
                  jgeotiff.read(path, window=window, boundless=True,
                                fill_value=0))
        _same(tgeotiff.read(path, window=(-5, -3, 20, 10), boundless=True,
                            fill_value=7),
              jgeotiff.read(path, window=(-5, -3, 20, 10), boundless=True,
                            fill_value=7))
    _same(tgeotiff.read_with_nans(str(tmp_path / 'g0.tif')),
          jgeotiff.read_with_nans(str(tmp_path / 'g0.tif')))
    assert np.isnan(tgeotiff.read_with_nans(str(tmp_path / 'g0.tif'))).sum() \
        == 40


def test_lonlat_profile_and_plain_files(tmp_path):
    """A geographic CRS, a file with no geo tags, and a nodata of NaN."""
    arr = _array(np.int16)
    path = str(tmp_path / 'll.tif')
    jgeotiff.write(path, arr, crs=jcrs.CRS(4326),
                   transform=(0.001, 0.0, 55.28, 0.0, -0.001, -20.9))
    tp, jp = tgeotiff.read_profile(path), jgeotiff.read_profile(path)
    assert tp.crs.to_epsg() == jp.crs.to_epsg() == 4326
    assert tp.transform == jp.transform and tp.nodata is None
    path = str(tmp_path / 'plain.tif')
    tgeotiff.write(path, arr.astype(np.float32), nodata=float('nan'))
    tp = tgeotiff.read_profile(path)
    assert tp.crs is None and tp.transform is None and np.isnan(tp.nodata)
    assert (tp.width, tp.height, tp.count, tp.dtype) == (83, 57, 1, 'float32')
    _same(tgeotiff.read_with_nans(path), arr.astype(np.float32))


def test_packbits_and_lzw_decoders_equal_jax(tmp_path):
    """The decoders alone: PackBits literal and repeat runs and the no-op
    byte on a hand-made stream; LZW on each strip of a PIL file, past the
    12-bit code width's table resets."""
    pb = bytes([2, 1, 2, 3, 0xFD, 9, 0x80, 0, 7])
    assert tgeotiff._packbits_decode(pb, 100) == \
        jgeotiff._packbits_decode(pb, 100) == bytes([1, 2, 3, 9, 9, 9, 9, 7])
    rng = np.random.RandomState(3)
    arr = rng.randint(0, 256, (64, 700)).astype(np.uint8)
    path = str(tmp_path / 'lzw.tif')
    Image.fromarray(arr).save(path, compression='tiff_lzw')
    t = tgeotiff._Tiff(path)
    offs = tgeotiff._as_tuple(t.tags[273])
    cnts = tgeotiff._as_tuple(t.tags[279])
    for o, c in zip(offs, cnts):
        raw = t.data[o:o + c]
        assert tgeotiff._lzw_decode(raw, 1 << 30) == \
            jgeotiff._lzw_decode(raw, 1 << 30)
    _same(tgeotiff.read(path), arr)
    with pytest.raises(ValueError, match='clear code'):
        tgeotiff._lzw_decode(bytes([0x00, 0x40, 0x00]), 10)
