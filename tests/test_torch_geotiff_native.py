"""The port's native TIFF window reader (``geo/geotiff_native.py`` over
``native/tiffio.cpp``) against the port's Python decoder and the JAX
package's ``geotiff.read``.

The library must build with the host's C++ compiler and load: a failure
here is a failure, not a skip.  Every windowed read must equal the Python
path bitwise, and ``geotiff.read`` must take the native path for the
layouts the native reader handles.  The layouts it refuses (LZW, planar
samples, the floating-point predictor, sample formats it does not know)
must fall to the Python path, not return undecoded bytes: the JAX
package's native reader returns such bytes for a float32 file with
predictor 3, and that result is recorded below as evidence.
"""

import os
import struct

import numpy as np
import pytest
from PIL import Image

from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu.geo import geotiff_native as jnative
from s2p_tpu_torch.geo import geotiff, geotiff_native

H, W = 300, 517
# windows inside, across each border and corner, the whole raster with a
# margin, and tiny ones at tile corners
WINDOWS = [(0, 0, 64, 64), (100, 37, 200, 129), (400, 250, 117, 50),
           (0, 290, 517, 10), (-30, -20, 100, 60), (480, 280, 80, 40),
           (-7, 150, 20, 5), (510, 100, 30, 9), (200, -11, 40, 20),
           (60, 295, 33, 12), (-10, -10, W + 20, H + 20), (255, 255, 3, 3)]
# windows that miss the raster (the JAX package's native reader copies a
# negative length for the first, so it is held against the port's Python
# path alone)
OUTSIDE = [(-50, 10, 20, 5), (600, 10, 20, 5), (10, -50, 5, 20),
           (10, 400, 5, 20)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _python_read(path, window, boundless):
    """``geotiff.read``'s Python path: the whole raster, then the window."""
    arr = geotiff._Tiff(path).read_array()
    arr = arr[:, :, 0] if arr.shape[2] == 1 else arr
    x, y, w, h = window
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, arr.shape[1]), min(y + h, arr.shape[0])
    if not boundless:
        return arr[y0:y1, x0:x1]
    out = np.zeros((h, w) + arr.shape[2:], arr.dtype)
    if x0 < x1 and y0 < y1:
        out[y0 - y:y1 - y, x0 - x:x1 - x] = arr[y0:y1, x0:x1]
    return out


def _patch_short(path, tag, value, typ=3):
    """Rewrite the inline single value of ``tag`` in a little-endian
    classic TIFF's first IFD as a SHORT (3) or a LONG (4)."""
    with open(path, 'r+b') as f:
        data = bytearray(f.read())
        off, = struct.unpack('<I', data[4:8])
        n, = struct.unpack('<H', data[off:off + 2])
        for i in range(n):
            e = off + 2 + 12 * i
            t, old, cnt = struct.unpack('<HHI', data[e:e + 8])
            if t == tag:
                assert old in (3, 4) and cnt == 1
                data[e + 2:e + 4] = struct.pack('<H', typ)
                data[e + 8:e + 12] = struct.pack(
                    '<HH' if typ == 3 else '<I',
                    *((value, 0) if typ == 3 else (value,)))
                break
        else:
            raise KeyError(tag)
        f.seek(0)
        f.write(data)


def test_library_builds_and_loads():
    assert geotiff_native.available()
    d = geotiff_native.build_dir()
    assert d.startswith(os.path.join(os.path.dirname(geotiff.__file__)[:-4],
                                     '_build'))
    assert os.path.exists(os.path.join(d, 'libtiffio.so'))
    # a second build of the same source is a lookup
    assert geotiff_native.build() == os.path.join(d, 'libtiffio.so')


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / 'tiffio.cpp'
    bad.write_text('int broken( {\n')
    monkeypatch.setattr(geotiff_native, '_SOURCE', str(bad))
    monkeypatch.setattr(geotiff_native, '_BUILD', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='failed to build') as e:
        geotiff_native.build()
    assert 'tiffio.cpp' in str(e.value) and 'error' in str(e.value)


@pytest.mark.parametrize('dtype', [np.uint16, np.float32],
                         ids=['uint16', 'float32'])
@pytest.mark.parametrize('compress', [None, 'deflate'])
@pytest.mark.parametrize('tiled', [False, True], ids=['strips', 'tiles'])
def test_windows_equal_python_and_jax(tmp_path, tiled, compress, dtype):
    rng = np.random.RandomState(7)
    arr = (rng.rand(H, W) * 60000).astype(dtype)
    path = str(tmp_path / 'f.tif')
    geotiff.write(path, arr, compress=compress, tiled=tiled)
    for window in WINDOWS:
        for boundless in (False, True):
            got = geotiff.read(path, window=window, boundless=boundless)
            _same(got, _python_read(path, window, boundless))
            _same(got, jgeotiff.read(path, window=window,
                                     boundless=boundless))
    for window in OUTSIDE:
        _same(geotiff.read(path, window=window, boundless=True),
              np.zeros(window[:1:-1], dtype))
        _same(geotiff.read(path, window=window),
              _python_read(path, window, False))


@pytest.mark.parametrize('dtype', [np.uint8, np.int16, np.int32, np.uint64,
                                   np.float16, np.float64],
                         ids=lambda d: d.__name__)
def test_sample_types_and_bands(tmp_path, dtype):
    """Every sample width, one band and three, tiles and strips, against
    the Python path (the native reader's output before any fallback)."""
    rng = np.random.RandomState(3)
    for bands, tiled in ((1, True), (3, False), (3, True)):
        arr = (rng.rand(H, W, bands) * 100).astype(dtype)
        path = str(tmp_path / f'b{bands}{tiled}.tif')
        geotiff.write(path, arr if bands > 1 else arr[:, :, 0],
                      compress='deflate', tiled=tiled)
        for window in WINDOWS[:6]:
            got = geotiff_native.read_window(path, *window)
            assert got is not None
            _same(got, _python_read(path, window, True))


def test_read_goes_through_the_native_path(tmp_path, monkeypatch):
    arr = np.arange(200 * 300, dtype=np.float32).reshape(200, 300)
    path = str(tmp_path / 'routed.tif')
    geotiff.write(path, arr, tiled=True)
    calls = []
    orig = geotiff_native.read_window

    def spy(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    monkeypatch.setattr(geotiff_native, 'read_window', spy)
    _same(geotiff.read(path, window=(40, 30, 64, 32)), arr[30:62, 40:104])
    # a boundless read goes native only with fill_value 0
    out = geotiff.read(path, window=(-4, -2, 8, 4), boundless=True)
    assert len(calls) == 2 and calls[0][1] == {'clip': True}
    _same(out[2:, 4:], arr[:2, :4])
    assert (out[:2] == 0).all() and (out[:, :4] == 0).all()
    out = geotiff.read(path, window=(-4, -2, 8, 4), boundless=True,
                       fill_value=-1)
    assert len(calls) == 2 and (out[:2] == -1).all()
    geotiff.read(path)
    assert len(calls) == 2


def test_floating_point_predictor_is_read_right(tmp_path):
    """A float32 file with predictor 3 (Pillow, deflate), read through a
    30 x 20 window, equals the array that was written: the native reader
    refuses it and the Python path decodes it.  The JAX package's native
    reader returns the undifferenced bytes."""
    rng = np.random.RandomState(0)
    arr = (rng.rand(57, 83) * 200).astype(np.float32)
    path = str(tmp_path / 'p3.tif')
    Image.fromarray(arr).save(path, compression='tiff_adobe_deflate',
                              tiffinfo={317: 3})
    window = (20, 10, 30, 20)
    assert geotiff_native.read_window(path, *window) is None
    _same(geotiff.read(path, window=window), arr[10:30, 20:50])
    jax_native = jnative.read_window(path, *window)
    with np.errstate(invalid='ignore', over='ignore'):
        err = np.abs(jax_native.astype(np.float64) - arr[10:30, 20:50])
    assert not np.array_equal(jax_native, arr[10:30, 20:50])
    assert np.nanmax(err) > 1e30 or not np.isfinite(jax_native).all()


def test_refused_layouts_fall_to_python(tmp_path):
    """LZW, planar samples and an unknown sample format: the native reader
    refuses each, and ``read`` gives the Python path's window."""
    rng = np.random.RandomState(1)
    arr = (rng.rand(57, 83) * 60000).astype(np.uint16)
    lzw = str(tmp_path / 'lzw.tif')
    Image.fromarray(arr).save(lzw, compression='tiff_lzw', tiffinfo={317: 2})
    # three planes of 110 x 300, one strip each, as planar configuration 2
    planes = (rng.rand(3 * 110, 300) * 60000).astype(np.uint16)
    planar = str(tmp_path / 'planar.tif')
    geotiff.write(planar, planes)
    assert geotiff._Tiff(planar).tags[278] == 110
    for tag, value in ((257, 110), (277, 3), (284, 2)):
        _patch_short(planar, tag, value)
    void = str(tmp_path / 'void.tif')
    geotiff.write(void, arr)
    _patch_short(void, 339, 4)
    for path, want in ((lzw, arr), (void, arr),
                       (planar, np.stack(np.split(planes, 3), axis=2))):
        _same(geotiff.read(path), want)
        for window in ((5, 7, 30, 20), (-5, -5, 100, 70)):
            assert geotiff_native.read_window(path, *window) is None
            for boundless in (False, True):
                _same(geotiff.read(path, window=window, boundless=boundless),
                      _python_read(path, window, boundless))


def test_layouts_the_jax_native_reader_gets_wrong(tmp_path):
    """Big-endian samples, the padding rows of a bottom tile, a strip tag
    larger than the raster and float32 with predictor 2 (libtiff sums its
    differences as 32-bit integers): the native reader equals the Python
    path and the written array.  The JAX package's native reader returns
    unswapped bytes for the first and the padding for the second."""
    rng = np.random.RandomState(2)
    # big-endian, uncompressed (Pillow writes 'I;16B' so)
    for dt in ('>u2',):
        arr = (rng.rand(40, 30) * 60000).astype(dt)
        path = str(tmp_path / 'be.tif')
        Image.fromarray(arr).save(path)
        with open(path, 'rb') as f:
            assert f.read(2) == b'MM'
        want = arr.astype(arr.dtype.newbyteorder('='))
        _same(geotiff_native.read_window(path, 0, 0, 30, 40), want)
        _same(geotiff.read(path, window=(-3, 5, 20, 50), boundless=True),
              _python_read(path, (-3, 5, 20, 50), True))
        assert not np.array_equal(jnative.read_window(path, 0, 0, 30, 40),
                                  want)
    # a 512-row tiled file cut to 300 rows: rows 300-511 are padding
    full = (rng.rand(512, 300) * 60000 + 1).astype(np.uint16)
    path = str(tmp_path / 'pad.tif')
    geotiff.write(path, full, tiled=True)
    _patch_short(path, 257, 300)
    window = (10, 280, 50, 40)
    got = geotiff.read(path, window=window, boundless=True)
    _same(got, _python_read(path, window, True))
    assert (got[20:] == 0).all() and (got[:20] == full[280:300, 10:60]).all()
    assert (jnative.read_window(path, *window)[20:] != 0).any()
    # RowsPerStrip past the raster
    arr = (rng.rand(50, 40) * 60000).astype(np.uint16)
    path = str(tmp_path / 'rps.tif')
    geotiff.write(path, arr)
    _patch_short(path, 278, 2 ** 32 - 1, typ=4)
    _same(geotiff.read(path, window=(3, 4, 10, 12)), arr[4:16, 3:13])
    _same(geotiff_native.read_window(path, 0, 0, 40, 50), arr)
    # float32 with predictor 2 (Pillow, deflate)
    arr = (rng.rand(57, 83) * 200).astype(np.float32)
    path = str(tmp_path / 'p2.tif')
    Image.fromarray(arr).save(path, compression='tiff_adobe_deflate',
                              tiffinfo={317: 2})
    _same(geotiff.read(path), arr)
    _same(geotiff_native.read_window(path, 0, 0, 83, 57), arr)
    _same(geotiff.read(path, window=(20, 10, 30, 20)), arr[10:30, 20:50])


def _write_predicted(path, arr, rows=16):
    """A deflate strip TIFF of ``arr`` with predictor 2: each row's samples
    differenced as unsigned integers of their width, as libtiff writes."""
    import zlib
    h, w = arr.shape
    u = arr.view(arr.dtype.str.replace('f', 'u').replace('i', 'u'))
    diff = u.copy()
    diff[:, 1:] = u[:, 1:] - u[:, :-1]
    chunks = [zlib.compress(diff[y:y + rows].tobytes())
              for y in range(0, h, rows)]
    sf = {'u': 1, 'i': 2, 'f': 3}[arr.dtype.kind]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8 * arr.itemsize]),
               (259, 3, [8]), (262, 3, [1]), (273, 4, None), (277, 3, [1]),
               (278, 4, [rows]), (279, 4, [len(c) for c in chunks]),
               (284, 3, [1]), (317, 3, [2]), (339, 3, [sf])]
    heap = 8 + 2 + 12 * len(entries) + 4
    offs = list(np.cumsum([heap + 8 * len(chunks)]
                          + [len(c) for c in chunks[:-1]]))
    out = bytearray(b'II*\0' + struct.pack('<IH', 8, len(entries)))
    for tag, typ, vals in entries:
        vals = offs if tag == 273 else vals
        if len(vals) == 1:
            val = struct.pack('<H' if typ == 3 else '<I', int(vals[0]))
        else:
            val = struct.pack('<I', heap + (0 if tag == 273 else
                                            4 * len(chunks)))
        out += struct.pack('<HHI', tag, typ, len(vals)) + val.ljust(4, b'\0')
    out += struct.pack('<I', 0)
    out += struct.pack(f'<{2 * len(chunks)}I', *map(int, offs),
                       *[len(c) for c in chunks])
    for c in chunks:
        out += c
    with open(path, 'wb') as f:
        f.write(bytes(out))


@pytest.mark.parametrize('dtype', [np.float64, np.uint64, np.float16,
                                   np.int32, np.float32],
                         ids=lambda d: d.__name__)
def test_predictor_2_on_every_sample_width(tmp_path, dtype):
    """Predictor 2 summed as unsigned integers of the sample's width, floats
    included, natively and in Python: both give the written array."""
    rng = np.random.RandomState(9)
    arr = (rng.rand(37, 53) * 1000 - 300).astype(dtype)
    path = str(tmp_path / 'p2.tif')
    _write_predicted(path, arr)
    assert geotiff._Tiff(path).tags[317] == 2
    _same(geotiff._Tiff(path).read_array()[:, :, 0], arr)
    _same(geotiff_native.read_window(path, 0, 0, 53, 37), arr)
    _same(geotiff.read(path, window=(-5, 20, 30, 30), boundless=True),
          _python_read(path, (-5, 20, 30, 30), True))
