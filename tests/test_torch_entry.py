"""The port's scene entry, host side, against the JAX package: the config
file and its JSON dump, RPC loading (the Ikonos, RPB and DIMAP texts and
the GeoTIFF tag, both ways), the GeoTIFF writer's georeferencing, the PNG
reader, GML and raster tile masks, the tiling, stage 6's rasterizer,
stage 7's mosaic, ``build_cfg`` and the command line."""

import dataclasses
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image, ImageDraw

from s2p_tpu import cli as jcli
from s2p_tpu import config as jconfig
from s2p_tpu import pipeline as jpipe
from s2p_tpu import tiling as jtiling
from s2p_tpu.core import masking as jmasking
from s2p_tpu.geo import crs as jcrs
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu.geo import rpc_io as jrpc_io
from s2p_tpu.ops import rasterize as jrasterize
from s2p_tpu_torch import cli as tcli
from s2p_tpu_torch import config as tconfig
from s2p_tpu_torch import pipeline as tpipe
from s2p_tpu_torch import state
from s2p_tpu_torch import tiling as ttiling
from s2p_tpu_torch.core import masking as tmasking
from s2p_tpu_torch.geo import crs as tcrs
from s2p_tpu_torch.geo import geotiff as tgeotiff
from s2p_tpu_torch.geo import rpc_io as trpc_io
from s2p_tpu_torch.ops import rasterize as trasterize

from test_torch_triangulation import jax_rpc

_RPC_FIELDS = ('col_num', 'col_den', 'row_num', 'row_den', 'lon_offset',
               'lon_scale', 'lat_offset', 'lat_scale', 'alt_offset',
               'alt_scale', 'col_offset', 'col_scale', 'row_offset',
               'row_scale')


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == 'f')


def _same_rpc(j, t):
    for f in _RPC_FIELDS:
        assert np.array_equal(np.asarray(getattr(j, f), np.float64),
                              np.asarray(getattr(t, f), np.float64)), f


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


# --------------------------------------------------------------------- #
# RPC loading
# --------------------------------------------------------------------- #

def _ikonos_text(r):
    names = [('LINE_OFF', r.row_offset), ('SAMP_OFF', r.col_offset),
             ('LAT_OFF', r.lat_offset), ('LONG_OFF', r.lon_offset),
             ('HEIGHT_OFF', r.alt_offset), ('LINE_SCALE', r.row_scale),
             ('SAMP_SCALE', r.col_scale), ('LAT_SCALE', r.lat_scale),
             ('LONG_SCALE', r.lon_scale), ('HEIGHT_SCALE', r.alt_scale)]
    lines = [f'{k}: {v:+.8f} units' for k, v in names]
    for key, c in (('LINE_NUM_COEFF', r.row_num), ('LINE_DEN_COEFF',
                                                    r.row_den),
                   ('SAMP_NUM_COEFF', r.col_num), ('SAMP_DEN_COEFF',
                                                   r.col_den)):
        lines += [f'{key}_{i + 1}: {v:+.12E}' for i, v in enumerate(c)]
    return '\n'.join(lines) + '\n'


def _rpb_text(r):
    names = [('lineOffset', r.row_offset), ('sampOffset', r.col_offset),
             ('latOffset', r.lat_offset), ('longOffset', r.lon_offset),
             ('heightOffset', r.alt_offset), ('lineScale', r.row_scale),
             ('sampScale', r.col_scale), ('latScale', r.lat_scale),
             ('longScale', r.lon_scale), ('heightScale', r.alt_scale)]
    lines = ['satId = "WV02";', 'BEGIN_GROUP = IMAGE', '\terrBias = -1.0;']
    lines += [f'\t{k} = {v:+.8f};' for k, v in names]
    for key, c in (('lineNumCoef', r.row_num), ('lineDenCoef', r.row_den),
                   ('sampNumCoef', r.col_num), ('sampDenCoef', r.col_den)):
        vals = ',\n\t\t\t'.join(f'{v:+.12E}' for v in c)
        lines.append(f'\t{key} = (\n\t\t\t{vals});')
    lines += ['END_GROUP = IMAGE', 'END;']
    return '\n'.join(lines) + '\n'


def _dimap_text(r):
    scal = [('LINE_OFF', r.row_offset + 1), ('SAMP_OFF', r.col_offset + 1),
            ('LAT_OFF', r.lat_offset), ('LONG_OFF', r.lon_offset),
            ('HEIGHT_OFF', r.alt_offset), ('LINE_SCALE', r.row_scale),
            ('SAMP_SCALE', r.col_scale), ('LAT_SCALE', r.lat_scale),
            ('LONG_SCALE', r.lon_scale), ('HEIGHT_SCALE', r.alt_scale)]
    coef = ''.join(
        f'<{key}_{i + 1}>{v:.15E}</{key}_{i + 1}>'
        for key, c in (('SAMP_NUM_COEFF', r.col_num),
                       ('SAMP_DEN_COEFF', r.col_den),
                       ('LINE_NUM_COEFF', r.row_num),
                       ('LINE_DEN_COEFF', r.row_den))
        for i, v in enumerate(c))
    sc = ''.join(f'<{k}>{v!r}</{k}>' for k, v in scal)
    return (f'<?xml version="1.0"?><Dimap_Document><Rational_Function_Model>'
            f'<Global_RFM><Inverse_Model>{coef}</Inverse_Model>'
            f'<RFM_Validity>{sc}</RFM_Validity></Global_RFM>'
            f'</Rational_Function_Model></Dimap_Document>')


@pytest.mark.parametrize('fmt', ['ikonos', 'rpb', 'dimap'])
def test_rpc_text_parsers_equal_jax(tmp_path, fmt):
    r = jax_rpc(3, 0.02)
    text = {'ikonos': _ikonos_text, 'rpb': _rpb_text,
            'dimap': _dimap_text}[fmt](r)
    path = str(tmp_path / f'cam.{fmt}')
    with open(path, 'w') as f:
        f.write(text)
    j, t = jrpc_io.load_rpc(path), trpc_io.load_rpc(path)
    _same_rpc(j, t)
    # the values survive the text to the printed precision
    assert abs(t.col_offset - r.col_offset) < 1e-6
    np.testing.assert_allclose(t.row_num, r.row_num, rtol=1e-11,
                               atol=1e-20)


def test_rpc_parsers_refuse_what_jax_refuses(tmp_path):
    path = str(tmp_path / 'cam.txt')
    with open(path, 'w') as f:
        f.write(_ikonos_text(jax_rpc(3, 0.02)).replace('SAMP_SCALE', 'X'))
    for mod in (jrpc_io, trpc_io):
        with pytest.raises(ValueError, match='SAMP_SCALE'):
            mod.rpc_from_rpc_file(path)


def test_rpc_dict_round_trip_equals_jax():
    r = jax_rpc(4, -0.015)
    t = state.rpc_from_state(dataclasses.asdict(r))
    assert t.to_dict() == r.to_dict()
    _same_rpc(r, trpc_io.load_rpc(r.to_dict()))
    _same_rpc(r, type(t).from_dict(r.to_dict()))


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_rpc_geotiff_tag_round_trip(tmp_path, writer):
    """An RPC written into a GeoTIFF's tag by either package reads back
    equal through both, and the two writers write the same bytes."""
    r = jax_rpc(5, 0.02)
    t = state.rpc_from_state(dataclasses.asdict(r))
    img = np.random.RandomState(0).rand(31, 45).astype(np.float32)
    jp, tp = str(tmp_path / 'j.tif'), str(tmp_path / 't.tif')
    jgeotiff.write(jp, img, rpc=r)
    tgeotiff.write(tp, img, rpc=t)
    assert _read(jp) == _read(tp)
    path = jp if writer == 'jax' else tp
    _same_rpc(jrpc_io.rpc_from_geotiff(path), trpc_io.rpc_from_geotiff(path))
    _same_rpc(r, trpc_io.rpc_from_geotiff(path))
    assert tgeotiff.read_tag(path, 50844) == jgeotiff.read_tag(path, 50844)
    _same(trpc_io.rpc_to_tag_values(t), jrpc_io.rpc_to_tag_values(r))


def test_rpc_from_untagged_geotiff_refuses(tmp_path):
    path = str(tmp_path / 'plain.tif')
    tgeotiff.write(path, np.zeros((4, 4), np.float32))
    for mod in (jrpc_io, trpc_io):
        with pytest.raises(ValueError, match='no RPC tag'):
            mod.rpc_from_geotiff(path)


# --------------------------------------------------------------------- #
# GeoTIFF writer
# --------------------------------------------------------------------- #

_WRITES = [
    dict(),
    dict(nodata=float('nan')),
    dict(nodata=-9999.0, compress='deflate', tiled=True),
    dict(transform=(4.0, 0.0, 333432.0, 0.0, -4.0, 7677136.0),
         crs='epsg:32740', nodata=float('nan'), compress='deflate',
         tiled=True),
    dict(transform=(0.5, 0.0, 10.0, 0.0, -0.5, 20.0),
         crs='epsg:32631+5773'),
    dict(transform=(1e-4, 0.0, 55.4, 0.0, -1e-4, -21.0), crs=4326,
         tags={'AREA_OR_POINT': 'Area', 'note': 'x'}),
]


@pytest.mark.parametrize('shape,dtype', [((37, 53), np.float32),
                                         ((300, 520), np.float32),
                                         ((260, 270, 3), np.uint8),
                                         ((20, 30), np.int16),
                                         ((9, 11), np.float64)])
@pytest.mark.parametrize('k', range(len(_WRITES)))
def test_geotiff_writer_equals_jax(tmp_path, shape, dtype, k):
    """Byte for byte what the JAX package writes; both readers read the
    port's file back to the array and to equal profiles."""
    kw = dict(_WRITES[k])
    a = (np.random.RandomState(k).rand(*shape) * 100).astype(dtype)
    jp, tp = str(tmp_path / 'j.tif'), str(tmp_path / 't.tif')
    jkw = dict(kw, crs=jcrs.CRS(kw['crs'])) if 'crs' in kw else kw
    tkw = dict(kw, crs=tcrs.CRS(kw['crs'])) if 'crs' in kw else kw
    jgeotiff.write(jp, a, **jkw)
    tgeotiff.write(tp, a, **tkw)
    assert _read(jp) == _read(tp)
    _same(tgeotiff.read(tp), a)
    _same(jgeotiff.read(tp), a)
    pj, pt = jgeotiff.read_profile(tp), tgeotiff.read_profile(tp)
    for f in ('width', 'height', 'count', 'dtype', 'transform', 'rpc_tag'):
        assert getattr(pj, f) == getattr(pt, f), f
    assert str(pj.nodata) == str(pt.nodata)
    assert (pj.crs is None) == (pt.crs is None)
    if pj.crs is not None:
        assert pj.crs.epsg == pt.crs.epsg


def test_geotiff_writer_takes_the_profile(tmp_path):
    prof = tgeotiff.Profile(width=5, height=4, crs=tcrs.CRS(32740),
                            transform=(2.0, 0.0, 100.0, 0.0, -2.0, 50.0),
                            nodata=float('nan'))
    a = np.arange(20, dtype=np.float32).reshape(4, 5)
    path = str(tmp_path / 'p.tif')
    tgeotiff.write(path, a, profile=prof.copy(nodata=-1.0))
    got = tgeotiff.read_profile(path)
    assert got.transform == prof.transform and got.nodata == -1.0
    assert got.crs.epsg == 32740


# --------------------------------------------------------------------- #
# PNG reader
# --------------------------------------------------------------------- #

def _png(path, rows, w, h, depth, color, rng):
    """A PNG of the given bytes, each row under a random filter type."""
    def chunk(k, p):
        return (struct.pack('>I', len(p)) + k + p
                + struct.pack('>I', zlib.crc32(k + p) & 0xFFFFFFFF))

    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    bpp = max(1, nch * depth // 8)
    stride = rows.shape[1]
    out, prior = [], np.zeros(stride, int)
    for y in range(h):
        ft = rng.randint(5)
        cur = rows[y].astype(int)
        f = np.zeros(stride, int)
        for x in range(stride):
            left = cur[x - bpp] if x >= bpp else 0
            up = prior[x]
            ul = prior[x - bpp] if x >= bpp else 0
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            paeth = left if pa <= pb and pa <= pc else (up if pb <= pc
                                                        else ul)
            f[x] = (cur[x] - [0, left, up, (left + up) >> 1, paeth][ft]) \
                & 255
        out.append(bytes([ft]) + bytes(f.astype(np.uint8)))
        prior = cur
    data = (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, color, 0,
                                         0, 0)))
    if color == 3:
        data += chunk(b'PLTE', bytes(rng.randint(0, 256, 3 << depth)
                                     .astype(np.uint8)))
    data += chunk(b'IDAT', zlib.compress(b''.join(out))) \
        + chunk(b'IEND', b'')
    with open(path, 'wb') as f:
        f.write(data)


@pytest.mark.parametrize('color,depth', [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (3, 1), (3, 2), (3, 4), (3, 8),
    (2, 8), (2, 16), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_png_reader_equals_pil(tmp_path, color, depth):
    """Every non-interlaced layout, every row filter: the array PIL (the
    JAX package's reader) gives."""
    rng = np.random.RandomState(color * 100 + depth)
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for h, w in ((5, 7), (13, 33), (1, 1)):
        rows = rng.randint(0, 256, (h, -(-w * nch * depth // 8))) \
            .astype(np.uint8)
        path = str(tmp_path / f'{h}.png')
        _png(path, rows, w, h, depth, color, rng)
        _same(tgeotiff.read_png(path), np.array(Image.open(path)))
        _same(tgeotiff.read_png(path), jgeotiff.read_png(path))


def test_png_reader_refuses_interlaced(tmp_path):
    path = str(tmp_path / 'i.png')
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(path)
    data = bytearray(_read(path))
    data[28] = 1                                   # IHDR's interlace byte
    data[29:33] = struct.pack('>I', zlib.crc32(bytes(data[12:29]))
                              & 0xFFFFFFFF)
    with open(path, 'wb') as f:
        f.write(bytes(data))
    with pytest.raises(NotImplementedError, match='interlace 1'):
        tgeotiff.read_png(path)


# --------------------------------------------------------------------- #
# Tile masks
# --------------------------------------------------------------------- #

def _pil_fill(polys, w, h, off):
    img = Image.new('1', (w, h), 0)
    d = ImageDraw.Draw(img)
    for pts in polys:
        d.polygon([(x - off[0], y - off[1]) for x, y in pts], fill=1)
    return np.array(img, dtype=bool)


_FILL_KINDS = ['integer', 'float', 'offset', 'simple', 'crossing', 'dense',
               'retrace', 'rectilinear']


@pytest.mark.parametrize('kind', _FILL_KINDS)
def test_polygon_fill_equals_pil(kind):
    """Seeded polygons, vertices inside and outside the raster: 400
    triangles of integer or float vertices (shifted by an offset or not),
    400 simple polygons of up to 12 vertices, concave ones among them
    (vertices about a centre in angular order), 400 polygons of 4 to 7
    random vertices, whose edges cross; 40 dense rings of 200 to 2000
    vertices about a centre, whose truncated vertices repeat, as those of
    real ROI and cloud rings do; 400 polygons that come back to earlier
    vertices (next to them or not); 400 rectilinear rings with runs of
    horizontal edges.  The port's fill gives PIL's mask (the JAX
    package's) on each."""
    rng = np.random.RandomState(_FILL_KINDS.index(kind))
    for _ in range(40 if kind == 'dense' else 400):
        w, h = rng.randint(1, 50), rng.randint(1, 50)
        if kind == 'simple':
            k = rng.randint(3, 13)
            c, r = rng.uniform(-5, 55, 2), rng.uniform(1, 30, k)
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            pts = np.c_[c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)]
        elif kind == 'dense':
            w, h = rng.randint(60, 140, 2)
            k = rng.randint(200, 2001)
            c, r = rng.uniform(20, 120, 2), rng.uniform(5, 60)
            r = r * (1 + 0.2 * rng.standard_normal(k))
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            pts = np.c_[c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)]
        elif kind == 'retrace':
            pts = list(rng.randint(-3, 40, (rng.randint(3, 8), 2)))
            for _ in range(rng.randint(1, 3)):
                pts.insert(rng.randint(len(pts) + 1),
                           pts[rng.randint(len(pts))])
            pts = np.array(pts, float)
        elif kind == 'rectilinear':
            x, y = rng.randint(-3, 45, 2)
            pts = []
            for _ in range(rng.randint(2, 10)):
                pts.append((x, y))
                for _ in range(rng.randint(1, 3)):
                    x = rng.randint(-3, 45)
                    pts.append((x, y))
                y = rng.randint(-3, 45)
            pts = np.array(pts, float)
        elif kind == 'crossing':
            pts = rng.uniform(-10, 50, (rng.randint(4, 8), 2))
        else:
            pts = rng.uniform(-10, 50, (3, 2))
        if kind == 'integer':
            pts = np.round(pts)
        off = tuple(rng.uniform(-3, 3, 2)) if kind == 'offset' else (0, 0)
        polys = [[tuple(p) for p in pts]]
        _same(tmasking.rasterize_polygons(polys, w, h, off),
              _pil_fill(polys, w, h, off))


_GML = """<?xml version="1.0" encoding="UTF-8"?>
<ogr:FeatureCollection xmlns:gml="http://www.opengis.net/gml">
 <gml:featureMember><ogr:m><ogr:geometryProperty><gml:Polygon>
  <gml:outerBoundaryIs><gml:LinearRing>
   <gml:coordinates>12.5,3.25 58.0,9.75 61.5,44.0 30.25,52.5 8.0,30.0 12.5,3.25</gml:coordinates>
  </gml:LinearRing></gml:outerBoundaryIs></gml:Polygon></ogr:geometryProperty></ogr:m></gml:featureMember>
 <gml:featureMember><ogr:m><ogr:geometryProperty><gml:Polygon>
  <gml:exterior><gml:LinearRing>
   <gml:posList>70 20 95 22 90 60 72 48 70 20</gml:posList>
  </gml:LinearRing></gml:exterior></gml:Polygon></ogr:geometryProperty></ogr:m></gml:featureMember>
</ogr:FeatureCollection>
"""

_CLOUDS = """<gml:FeatureCollection xmlns:gml="http://www.opengis.net/gml">
<gml:posList>20 15 40 15 40 35 20 35</gml:posList>
<gml:posList>80 30 84.5 30 82.25 41.75</gml:posList>
</gml:FeatureCollection>
"""


@pytest.mark.parametrize('window', [(0, 0, 100, 70), (10, 5, 40, 30),
                                    (-5, -8, 50, 40), (60, 10, 60, 60)])
def test_gml_tile_masks_equal_jax(tmp_path, window):
    roi, cld = str(tmp_path / 'roi.gml'), str(tmp_path / 'cld.gml')
    with open(roi, 'w') as f:
        f.write(_GML)
    with open(cld, 'w') as f:
        f.write(_CLOUDS)
    assert tmasking.read_gml_polygons(roi) == jmasking.read_gml_polygons(roi)
    assert tmasking.read_gml_polygons(cld) == jmasking.read_gml_polygons(cld)
    for kw in (dict(roi_gml=roi), dict(cld_gml=cld),
               dict(roi_gml=roi, cld_gml=cld, img_shape=(64, 90),
                    border_margin=3)):
        _same(tmasking.image_tile_mask(*window, **kw),
              jmasking.image_tile_mask(*window, **kw))


@pytest.mark.parametrize('ext', ['png', 'tif'])
@pytest.mark.parametrize('window', [(0, 0, 30, 20), (20, 10, 30, 30),
                                    (-6, -4, 12, 10), (50, 50, 5, 5)])
def test_raster_mask_window_equals_jax(tmp_path, ext, window):
    rng = np.random.RandomState(0)
    m = (rng.rand(40, 45) > 0.3).astype(np.uint8) * 255
    path = str(tmp_path / f'wat.{ext}')
    if ext == 'png':
        Image.fromarray(m).save(path)
    else:
        jgeotiff.write(path, m)
    _same(tmasking.image_tile_mask(*window, raster_mask=path,
                                   img_shape=(40, 45)),
          jmasking.image_tile_mask(*window, raster_mask=path,
                                   img_shape=(40, 45)))


# --------------------------------------------------------------------- #
# Tiling
# --------------------------------------------------------------------- #

@pytest.mark.parametrize('roi,tile', [
    ((0, 0, 1000, 1000), 800), ((17, 33, 2401, 1599), 800),
    ((150, 110, 400, 400), 200), ((5, 7, 199, 611), 300),
    ((3, 1, 90, 50), 800), ((0, 0, 1201, 401), 400)])
def test_tile_grid_equals_jax(roi, tile):
    x, y, w, h = roi
    d = {'roi': {'x': x, 'y': y, 'w': w, 'h': h}, 'tile_size': tile}
    tw, th = ttiling.adjust_tile_size(tconfig.Config(**d))
    assert (tw, th) == jtiling.adjust_tile_size(jconfig.Config(**d))
    assert ttiling.compute_tiles_coordinates(x, y, w, h, tw, th) == \
        jtiling.compute_tiles_coordinates(x, y, w, h, tw, th)
    coords, nbr = ttiling.compute_tiles_coordinates(x, y, w, h, tw, th)
    for c in coords:
        assert ttiling.get_tile_dir(*c) == jtiling.get_tile_dir(*c)
        t = ttiling.create_tile(tconfig.Config(out_dir='/o'), c, nbr)
        assert t == jtiling.create_tile(jconfig.Config(out_dir='/o'), c,
                                        nbr)


def test_rectangles_intersect_equals_jax():
    rng = np.random.RandomState(0)
    for _ in range(300):
        r, s = rng.randint(-5, 10, 4), rng.randint(-5, 10, 4)
        assert ttiling.rectangles_intersect(r, s) == \
            jtiling.rectangles_intersect(r, s)


# --------------------------------------------------------------------- #
# Stage 6's rasterizer and stage 7's mosaic
# --------------------------------------------------------------------- #

def _cloud(seed, n=4000, x0=333400.0, y0=7677000.0):
    rng = np.random.RandomState(seed)
    pts = np.empty((n, 7))
    pts[:, 0] = x0 + rng.rand(n) * 90
    pts[:, 1] = y0 + rng.rand(n) * 70
    pts[:, 2] = 300 + rng.randn(n)
    pts[:, 3:6] = rng.randint(0, 256, (n, 3))
    pts[:, 6] = rng.rand(n)
    pts[rng.rand(n) < 0.02, 2] = np.nan
    return pts


@pytest.mark.parametrize('radius,sigma', [(0, None), (1, None), (1, 2.5),
                                          (2, 0.7)])
def test_plyflatten_equals_jax_bitwise(radius, sigma):
    pts = _cloud(0)
    grid = trasterize.grid_from_roi(pts[:, 0].min(), pts[:, 1].min(),
                                    pts[:, 0].max(), pts[:, 1].max(), 4.0)
    assert grid == jrasterize.grid_from_roi(
        pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max(),
        4.0)
    xoff, yoff, xs, ys = grid
    _same(trasterize.plyflatten(pts, xoff, yoff, 4.0, xs, ys, radius, sigma),
          jrasterize.plyflatten(pts, xoff, yoff, 4.0, xs, ys, radius, sigma))


def _write_clouds(root, n_clouds):
    from s2p_tpu.geo import ply as jply
    paths = []
    for k in range(n_clouds):
        pts = _cloud(k, x0=333400.0 + 40 * k)
        p = os.path.join(root, f'c{k}.ply')
        jply.write_ply(p, pts[:, :3], colors=pts[:, 3:6].astype(np.uint8),
                       extra=pts[:, 6].astype(np.float32),
                       extra_names=['confidence'],
                       comments=['projection: CRS epsg:32740'])
        paths.append(p)
    return paths


@pytest.mark.parametrize('roi', [None, (333404.0, 7677072.0, 20, 15)])
def test_plyflatten_from_plyfiles_equals_jax(tmp_path, roi):
    paths = _write_clouds(str(tmp_path), 3)
    rj, pj = jrasterize.plyflatten_from_plyfiles_list(paths, 4.0, roi=roi,
                                                      radius=1)
    rt, pt = trasterize.plyflatten_from_plyfiles_list(paths, 4.0, roi=roi,
                                                      radius=1)
    _same(rt, rj)
    assert (pt.width, pt.height, pt.count, pt.transform) == \
        (pj.width, pj.height, pj.count, pj.transform)
    assert pt.crs.epsg == pj.crs.epsg == 32740


@pytest.mark.parametrize('bounds', [None, (333396.0, 7676996.0, 333512.0,
                                           7677060.0)])
def test_merge_rasters_equals_jax(tmp_path, bounds):
    """Three overlapping tile rasters with gaps, 'first' wins: the mosaic
    and its file, byte for byte."""
    rng = np.random.RandomState(0)
    paths = []
    for k, (x, y, w, h) in enumerate([(333400.0, 7677072.0, 12, 10),
                                      (333432.0, 7677064.0, 15, 9),
                                      (333380.0, 7677040.0, 9, 14)]):
        a = (300 + rng.randn(h, w)).astype(np.float32)
        a[rng.rand(h, w) < 0.2] = np.nan
        p = str(tmp_path / f't{k}.tif')
        jgeotiff.write(p, a, crs=jcrs.CRS(32740),
                       transform=(4.0, 0.0, x, 0.0, -4.0, y),
                       nodata=float('nan'))
        paths.append(p)
    jo, to = str(tmp_path / 'j.tif'), str(tmp_path / 't.tif')
    _same(tpipe._merge_rasters(paths, to, 4.0, bounds),
          jpipe._merge_rasters(paths, jo, 4.0, bounds))
    assert _read(jo) == _read(to)


# --------------------------------------------------------------------- #
# The config, build_cfg and the command line
# --------------------------------------------------------------------- #

def _config_file(tmp_path):
    r1, r2 = jax_rpc(1, 0.02), jax_rpc(2, -0.015)
    img = np.zeros((60, 80), np.float32)
    for name, r in (('a.tif', r1), ('b.tif', r2)):
        jgeotiff.write(str(tmp_path / name), img, rpc=r)
    with open(tmp_path / 'cam.json', 'w') as f:
        json.dump(r2.to_dict(), f)
    cfg = {'out_dir': 'out', 'images': [{'img': 'a.tif'},
                                        {'img': 'b.tif', 'clr': 'c.tif'}],
           'roi': {'x': 3.5, 'y': 2.2, 'w': 40.1, 'h': 30},
           'tile_size': 20, '3d_filtering_r': 5.0, 'dsm_sigma': None,
           'roi_geojson': 'roi.geojson', 'exogenous_dem': '/abs/dem.tif'}
    path = str(tmp_path / 'config.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    return path


def test_read_config_file_and_dump_equal_jax(tmp_path):
    path = _config_file(tmp_path)
    assert tconfig.read_config_file(path) == jconfig.read_config_file(path)
    d = tconfig.read_config_file(path)
    assert d['out_dir'] == str(tmp_path / 'out')
    assert d['images'][1]['clr'] == str(tmp_path / 'c.tif')
    assert d['exogenous_dem'] == '/abs/dem.tif'
    del d['roi_geojson'], d['exogenous_dem']
    tc = tpipe.build_cfg(dict(d, images=[dict(i) for i in d['images']]))
    jc = jpipe.build_cfg(dict(d, images=[dict(i) for i in d['images']]))
    assert tc.roi == jc.roi == {'x': 3, 'y': 2, 'w': 41, 'h': 30}
    assert (tc.out_crs, tc.gsd) == (jc.out_crs, jc.gsd)
    for a, b in zip(tc.images, jc.images):
        _same_rpc(b.rpcm, a.rpcm)
    assert tc.to_dict() == json.loads(json.dumps(
        jc.to_dict(), default=jconfig._json_default))
    tc.dump_json(str(tmp_path / 't.json'))
    jc.dump_json(str(tmp_path / 'j.json'))
    assert _read(str(tmp_path / 't.json')) == _read(str(tmp_path / 'j.json'))


@pytest.mark.parametrize('geojson', ['polygon', 'feature', 'collection'])
def test_build_cfg_from_roi_geojson_equals_jax(tmp_path, geojson):
    """The ``roi_geojson`` route (no SRTM): the ROI, the CRS and, at stage
    7, the mosaic's bounds come from the polygon."""
    path = _config_file(tmp_path)
    d = tconfig.read_config_file(path)
    del d['roi'], d['exogenous_dem']
    cam = tpipe.build_cfg(dict(d, roi={'x': 0, 'y': 0, 'w': 1, 'h': 1},
                               roi_geojson=None)).images[0].rpcm
    lon, lat = cam.localization(np.array([5, 60, 55, 8]),
                                np.array([4, 6, 50, 45]), cam.alt_offset)
    poly = {'type': 'Polygon', 'coordinates': [np.c_[lon, lat].tolist()]}
    obj = {'polygon': poly,
           'feature': {'type': 'Feature', 'geometry': poly},
           'collection': {'type': 'FeatureCollection', 'features': [
               {'type': 'Feature', 'geometry': poly}]}}[geojson]
    with open(d['roi_geojson'], 'w') as f:
        json.dump(obj, f)
    for src in (d['roi_geojson'], obj):
        tc = tpipe.build_cfg(dict(d, roi_geojson=src, out_geoid=True))
        jc = jpipe.build_cfg(dict(d, roi_geojson=src, out_geoid=True))
        assert tc.roi == jc.roi
        assert tc.out_crs == jc.out_crs and tc.out_crs.endswith('+5773')
        _same(tpipe.read_lon_lat_poly_from_geojson(src),
              jpipe.read_lon_lat_poly_from_geojson(src))


@pytest.mark.parametrize('user_cfg,match', [
    ({'images': [{'img': 'a.tif'}]}, 'missing paths'),
    ({'images': [{'img': 'a.tif'}, {'img': 'b.tif'}],
      'roi': {'x': 1, 'y': 2}}, 'incomplete roi')])
def test_build_cfg_refusals_equal_jax(tmp_path, user_cfg, match):
    _config_file(tmp_path)
    images = [dict(i, img=str(tmp_path / i['img']))
              for i in user_cfg['images']]
    for mod in (tpipe, jpipe):
        with pytest.raises(ValueError, match=match):
            mod.build_cfg(dict(user_cfg, images=images))


@pytest.mark.parametrize('argv', [['cfg.json'], ['cfg.json', '--start_from',
                                                 '6']])
def test_cli_arguments_equal_jax(tmp_path, monkeypatch, argv):
    """Both command lines hand the same config and stage to their
    ``pipeline.main`` and back the config up beside the output."""
    path = _config_file(tmp_path)
    calls = []

    def fake(user_cfg, start_from=0):
        os.makedirs(user_cfg['out_dir'], exist_ok=True)
        calls.append((user_cfg, start_from))

    monkeypatch.setattr(jpipe, 'main', fake)
    monkeypatch.setattr(tpipe, 'main', fake)
    args = [path] + argv[1:]
    monkeypatch.setattr(sys, 'argv', ['s2p_tpu'] + args)
    jcli.main()
    tcli.main(args)
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[1][1] == (int(argv[-1]) if len(argv) > 1 else 0)
    assert _read(os.path.join(calls[1][0]['out_dir'],
                              'config.json.orig')) == _read(path)


def test_cli_exits_cleanly_on_a_stage_timeout(tmp_path, monkeypatch):
    path = _config_file(tmp_path)
    exits = []

    def timed_out(user_cfg, start_from=0):
        raise tpipe.runner.TimeoutError_('stage 4: a tile timed out')

    def exit_(code):
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(tpipe, 'main', timed_out)
    monkeypatch.setattr(os, '_exit', exit_)
    with pytest.raises(SystemExit):
        tcli.main([path])
    assert exits == [1]


def test_stage_banner_times_and_profiles(tmp_path, monkeypatch, capsys):
    """``_stage`` prints the banner and the elapsed time, keeps the time,
    and under S2P_TPU_PROFILE writes a torch.profiler trace."""
    times = {}
    monkeypatch.delenv('S2P_TPU_PROFILE', raising=False)
    with tpipe._stage('2) correcting pointing globally...', times):
        pass
    monkeypatch.setenv('S2P_TPU_PROFILE', str(tmp_path / 'prof'))
    with tpipe._stage('6) computing DSM by tile...', times):
        np.add.at(np.zeros(4), [0, 1, 1], 1.0)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == '2) correcting pointing globally...'
    assert out[1].startswith('elapsed time: ') and out[3].startswith(
        'elapsed time: ')
    assert set(times) == {'2) correcting pointing globally...',
                          '6) computing DSM by tile...'}
    trace = tmp_path / 'prof' / '6__computing_DSM_by_tile.json'
    assert json.loads(trace.read_text())['traceEvents'] is not None
