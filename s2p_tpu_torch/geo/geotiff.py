"""TIFF and PNG raster IO in numpy and zlib alone.

Stage 3 reads the input images (and an exogenous DEM's window) and
writes the rectified pair as float32 TIFF; stage 4 reads that pair and
writes the disparity and confidence maps as float32 TIFF and the
validity mask as an 8-bit grey PNG; stages 6 and 7 write the tile and
scene DSMs as georeferenced float32 GeoTIFFs.  The port's machines have
no PIL, rasterio or GDAL, so this module carries the subset it needs:

  * TIFF read (the JAX package's pure-Python reader): classic TIFF and
    BigTIFF, first IFD, strips or tiles, chunky or planar samples, any
    integer or float sample type, compression none, deflate, PackBits or
    LZW, the horizontal and the floating-point predictor, the profile (geo
    transform, EPSG CRS, nodata, RPC tag), any tag's raw value
    (:func:`read_tag`); windowed reads go through the native decoder of
    :mod:`geotiff_native`, which touches only the chunks that meet the
    window, for the layouts it takes;
  * TIFF write: ``s2p_tpu.geo.geotiff.write``'s layout (strips, or
    256 x 256 tiles; deflate through zlib or none; the geo transform,
    the GeoKeys of a UTM or geographic CRS, the GDAL nodata and metadata
    tags and the RPC tag), byte for byte what that function writes.  It
    writes no predictor;
  * PNG write of 8-bit grey and RGB images, and PNG read of the non-interlaced
    layouts a mask comes in (grey of 1 to 16 bits, palette indices, and
    grey-alpha, RGB and RGBA of 8 or 16 bits), as PIL returns them: the
    reader undoes all five PNG row filters, so it reads files written by
    other encoders.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from . import geotiff_native

_T_WIDTH, _T_HEIGHT = 256, 257
_T_BPS, _T_COMPRESSION, _T_PHOTO = 258, 259, 262
_T_STRIP_OFFSETS, _T_SPP, _T_ROWS_PER_STRIP, _T_STRIP_COUNTS = 273, 277, 278, 279
_T_PLANAR, _T_PREDICTOR = 284, 317
_T_TILE_W, _T_TILE_H, _T_TILE_OFFSETS, _T_TILE_COUNTS = 322, 323, 324, 325
_T_SAMPLE_FORMAT = 339
_T_PIXEL_SCALE, _T_TIEPOINT = 33550, 33922
_T_GEO_KEYS, _T_GEO_ASCII = 34735, 34737
_T_GDAL_METADATA, _T_GDAL_NODATA = 42112, 42113
_T_RPC = 50844

_TYPE_FMT = {1: 'B', 2: 'c', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 7: 'B',
             8: 'h', 9: 'i', 10: 'ii', 11: 'f', 12: 'd', 16: 'Q', 17: 'q'}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8, 16: 8, 17: 8}


@dataclasses.dataclass
class Profile:
    """Raster metadata, the moral equivalent of a rasterio profile."""
    width: int
    height: int
    count: int = 1
    dtype: str = 'float32'
    crs: object = None           # geo.crs.CRS or None
    transform: tuple = None      # (a, b, c, d, e, f): x = c + a*col + b*row
    nodata: float = None
    rpc_tag: tuple = None

    @property
    def shape(self):
        return (self.height, self.width)

    def copy(self, **kw):
        return dataclasses.replace(self, **kw)


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


class _Tiff:
    """TIFF container parser (classic and BigTIFF, first IFD only)."""

    def __init__(self, path):
        with open(path, 'rb') as f:
            self.data = d = f.read()
        if d[:2] == b'II':
            self.en = '<'
        elif d[:2] == b'MM':
            self.en = '>'
        else:
            raise ValueError(f'{path} is not a TIFF file')
        magic, = struct.unpack(self.en + 'H', d[2:4])
        self.big = magic == 43
        if self.big:
            off, = struct.unpack(self.en + 'Q', d[8:16])
        else:
            off, = struct.unpack(self.en + 'I', d[4:8])
        self.tags = self._parse_ifd(off)

    def _parse_ifd(self, off):
        d, en = self.data, self.en
        if self.big:
            n, = struct.unpack(en + 'Q', d[off:off + 8])
            off += 8
            esz, cnt_fmt, inline = 20, 'Q', 8
        else:
            n, = struct.unpack(en + 'H', d[off:off + 2])
            off += 2
            esz, cnt_fmt, inline = 12, 'I', 4
        tags = {}
        for i in range(n):
            e = d[off + i * esz: off + (i + 1) * esz]
            tag, typ = struct.unpack(en + 'HH', e[:4])
            cnt, = struct.unpack(en + cnt_fmt,
                                 e[4:4 + struct.calcsize(cnt_fmt)])
            if typ not in _TYPE_FMT:
                continue
            size = _TYPE_SIZE[typ] * cnt
            payload = e[12:20] if self.big else e[8:12]
            if size <= inline:
                raw = payload[:size]
            else:
                p, = struct.unpack(en + ('Q' if self.big else 'I'), payload)
                raw = d[p:p + size]
            tags[tag] = self._decode(typ, cnt, raw)
        return tags

    def _decode(self, typ, cnt, raw):
        if typ == 2:                                   # ASCII
            return raw.split(b'\0')[0].decode('latin1')
        vals = struct.unpack(self.en + _TYPE_FMT[typ] * cnt, raw)
        if typ in (5, 10):                             # rationals
            return tuple(vals[i] / max(vals[i + 1], 1)
                         for i in range(0, len(vals), 2))
        return vals[0] if cnt == 1 else vals

    def dtype(self):
        bps = _as_tuple(self.tags.get(_T_BPS, 1))[0]
        sf = _as_tuple(self.tags.get(_T_SAMPLE_FORMAT, 1))[0]
        kind = {1: 'u', 2: 'i', 3: 'f'}.get(sf, 'u')
        return np.dtype(f'{self.en}{kind}{bps // 8}')

    def decompress(self, raw, out_size):
        comp = self.tags.get(_T_COMPRESSION, 1)
        if comp == 1:
            return raw
        if comp in (8, 32946):                         # deflate
            return zlib.decompress(raw)
        if comp == 32773:
            return _packbits_decode(raw, out_size)
        if comp == 5:
            return _lzw_decode(raw, out_size)
        raise NotImplementedError(f'TIFF compression {comp} not supported')

    def read_array(self):
        """The whole raster as (h, w, samples)."""
        t = self.tags
        w, h = t[_T_WIDTH], t[_T_HEIGHT]
        spp = t.get(_T_SPP, 1)
        dt = self.dtype()
        planar = t.get(_T_PLANAR, 1)
        pred = t.get(_T_PREDICTOR, 1)
        nplanes = spp if planar == 2 else 1
        cpp = 1 if planar == 2 else spp
        if _T_TILE_OFFSETS in t:
            cw, ch = t[_T_TILE_W], t[_T_TILE_H]
            offs, cnts = _as_tuple(t[_T_TILE_OFFSETS]), \
                _as_tuple(t[_T_TILE_COUNTS])
            grid = [(y0, x0) for y0 in range(0, h, ch)
                    for x0 in range(0, w, cw)]
        else:
            cw, ch = w, t.get(_T_ROWS_PER_STRIP, h)
            offs, cnts = _as_tuple(t[_T_STRIP_OFFSETS]), \
                _as_tuple(t[_T_STRIP_COUNTS])
            grid = [(y0, 0) for y0 in range(0, h, ch)]
        out = np.zeros((h, w, spp), dtype=dt.newbyteorder('='))
        k = 0
        for plane in range(nplanes):
            for y0, x0 in grid:
                hh, ww = min(ch, h - y0), min(cw, w - x0)
                # a strip holds only its own rows; a tile is always whole
                rows = hh if _T_TILE_OFFSETS not in t else ch
                raw = self.data[offs[k]:offs[k] + cnts[k]]
                buf = self.decompress(raw, rows * cw * cpp * dt.itemsize)
                a = np.frombuffer(buf, dtype=dt, count=rows * cw * cpp)
                a = _unpredict(a.reshape(rows, cw, cpp), pred)
                if planar == 2:
                    out[y0:y0 + hh, x0:x0 + ww, plane] = a[:hh, :ww, 0]
                else:
                    out[y0:y0 + hh, x0:x0 + ww] = a[:hh, :ww]
                k += 1
        return out


def _unpredict(a, pred):
    """Undo the TIFF predictor: 2 horizontal differences, summed as
    unsigned integers of the sample's width (libtiff's rule, floating-point
    samples included), 3 the floating-point predictor (each row's bytes
    split into planes, most significant first, then differenced).  The JAX
    package's reader sums predictor 2's float samples as floats and
    reverses the planes' byte order once more for predictor 3, which
    decodes such files wrongly; this one does not."""
    if pred == 2:
        u = a.view(a.dtype.str.replace('f', 'u')) if a.dtype.kind == 'f' \
            else a
        return np.cumsum(u, axis=1, dtype=u.dtype).view(a.dtype)
    if pred == 3:
        h, w, c = a.shape
        raw = a.view(np.uint8).reshape(h, w * c * a.itemsize)
        raw = np.cumsum(raw, axis=1, dtype=np.uint8)
        raw = raw.reshape(h, a.itemsize, w * c)
        raw = raw.transpose(0, 2, 1).copy()   # big-endian order
        return raw.view(f'>f{a.itemsize}').astype(a.dtype).reshape(h, w, c)
    return a


def _packbits_decode(raw, out_size):
    out = bytearray()
    i, n = 0, len(raw)
    while i < n and len(out) < out_size:
        b = raw[i]
        i += 1
        if b < 128:
            out += raw[i:i + b + 1]
            i += b + 1
        elif b > 128:
            out += raw[i:i + 1] * (257 - b)
            i += 1
    return bytes(out)


def _lzw_decode(raw, out_size):
    """TIFF-flavour LZW (MSB-first codes, early change)."""
    out = bytearray()
    table = prev = None
    bitpos, nbits = 0, 9
    total_bits = len(raw) * 8

    def read_code():
        nonlocal bitpos
        if bitpos + nbits > total_bits:
            return 257                                 # end of information
        byte0 = bitpos >> 3
        val = int.from_bytes(raw[byte0:byte0 + 4].ljust(4, b'\0'), 'big')
        val = (val >> (32 - nbits - (bitpos & 7))) & ((1 << nbits) - 1)
        bitpos += nbits
        return val

    while len(out) < out_size:
        code = read_code()
        if code == 256:                                # clear
            table = [bytes([i]) for i in range(256)] + [b'', b'']
            nbits, prev = 9, None
            continue
        if code == 257:
            break
        if table is None:
            raise ValueError('LZW stream does not start with a clear code')
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(out)


def read_tag(path, tag):
    """The raw value of a TIFF tag, or None."""
    return _Tiff(path).tags.get(tag)


def read_profile(path) -> Profile:
    """Size, sample type, geo transform, CRS, nodata and RPC tag."""
    t = _Tiff(path)
    tags = t.tags
    transform = None
    if _T_PIXEL_SCALE in tags and _T_TIEPOINT in tags:
        sx, sy = tags[_T_PIXEL_SCALE][0], tags[_T_PIXEL_SCALE][1]
        tp = tags[_T_TIEPOINT]
        # tiepoint: raster (i, j, k) -> model (X, Y, Z)
        i, j, X, Y = tp[0], tp[1], tp[3], tp[4]
        transform = (sx, 0.0, X - i * sx, 0.0, -sy, Y + j * sy)
    nodata = None
    if _T_GDAL_NODATA in tags:
        try:
            nodata = float(tags[_T_GDAL_NODATA])
        except ValueError:
            pass
    return Profile(width=tags[_T_WIDTH], height=tags[_T_HEIGHT],
                   count=tags.get(_T_SPP, 1),
                   dtype=str(np.dtype(t.dtype().newbyteorder('='))),
                   crs=_crs_from_geokeys(tags), transform=transform,
                   nodata=nodata, rpc_tag=tags.get(_T_RPC))


def _crs_from_geokeys(tags):
    """The EPSG CRS named by the GeoKey directory, or None."""
    from . import crs as crsmod
    gk = tags.get(_T_GEO_KEYS)
    if not gk:
        return None
    gk = _as_tuple(gk)
    epsg = None
    for i in range(4, len(gk), 4):
        key, loc, _, val = gk[i:i + 4]
        if key == 3072 and loc == 0:                   # ProjectedCSType
            epsg = val
        elif key == 2048 and loc == 0 and epsg is None:  # GeographicType
            epsg = val
    if epsg and epsg != 32767:
        try:
            return crsmod.CRS.from_epsg(epsg)
        except Exception:
            return None
    return None


def read(path, window=None, boundless=False, fill_value=0):
    """A TIFF as an (h, w) or (h, w, bands) array.

    ``window`` is an optional (x, y, w, h) pixel window, clipped to the
    raster unless ``boundless``, in which case the area outside it is
    ``fill_value``.  A windowed read goes through the native decoder
    (:func:`_read_native`) where it can; otherwise the whole raster is
    decoded, then cut."""
    if window is not None:
        arr = _read_native(path, window, boundless, fill_value)
        if arr is not None:
            return arr
    arr = _Tiff(path).read_array()
    if arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if window is None:
        return arr
    x, y, w, h = [int(v) for v in window]
    H, W = arr.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    if not boundless:
        return arr[y0:y1, x0:x1]
    out = np.full((h, w) + arr.shape[2:], fill_value, dtype=arr.dtype)
    if x0 < x1 and y0 < y1:
        out[y0 - y:y1 - y, x0 - x:x1 - x] = arr[y0:y1, x0:x1]
    return out


def _read_native(path, window, boundless, fill_value):
    """A windowed read through the native decoder, with the JAX package's
    routing: a read that is not boundless is clipped to the raster first
    (None if nothing is left); a boundless one goes native only with
    ``fill_value`` 0, since the native decoder zero-fills; None for
    whatever the native decoder refuses."""
    x, y, w, h = [int(v) for v in window]
    if not boundless:
        return geotiff_native.read_window(path, x, y, w, h, clip=True)
    if fill_value not in (0, 0.0):
        return None
    return geotiff_native.read_window(path, x, y, w, h)


def read_with_nans(path):
    """Read, with the nodata value replaced by NaN."""
    prof = read_profile(path)
    arr = read(path)
    if prof.nodata is not None and not np.isnan(prof.nodata):
        arr = arr.astype(np.float32) if arr.dtype.kind != 'f' else arr
        arr[arr == prof.nodata] = np.nan
    return arr


def _pack_tag(tag, typ, values, heap, heap_base):
    if typ == 2:
        raw = values.encode('latin1') + b'\0'
        cnt = len(raw)
    else:
        values = values if isinstance(values, tuple) else (values,)
        cnt = len(values)
        raw = struct.pack('<' + _TYPE_FMT[typ] * cnt, *values)
    if len(raw) <= 4:
        val = raw.ljust(4, b'\0')
    else:
        val = struct.pack('<I', heap_base + len(heap))
        heap += raw
        if len(heap) % 2:
            heap += b'\0'
    return struct.pack('<HHI', tag, typ, cnt) + val


def write(path, array, profile: Profile = None, crs=None, transform=None,
          nodata=None, rpc=None, compress=None, tiled=False, tags=None):
    """Write an (h, w) or (h, w, bands) array as a (Geo)TIFF.

    ``profile`` supplies the crs, transform and nodata the arguments leave
    None.  ``transform`` is (a, b, c, d, e, f) with x = c + a*col and
    y = f + e*row; ``crs`` a :class:`s2p_tpu_torch.geo.crs.CRS`, an EPSG
    code or a string such as 'epsg:32631+5773'; ``rpc`` an
    :class:`s2p_tpu_torch.geo.rpc.RPCModel` or the 92 values of the RPC
    tag; ``compress`` None or 'deflate'; ``tiled`` writes 256 x 256 tiles
    instead of strips; ``tags`` a dict written as GDAL metadata."""
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f'write takes a 2-D or 3-D array, got {arr.shape}')
    h, w, spp = arr.shape
    if profile is not None:
        crs = crs if crs is not None else profile.crs
        transform = transform if transform is not None else profile.transform
        nodata = nodata if nodata is not None else profile.nodata
    dt = arr.dtype
    arr = np.ascontiguousarray(arr, dtype=dt.newbyteorder('<'))

    if tiled:
        chunks = []
        for y0 in range(0, h, 256):
            for x0 in range(0, w, 256):
                block = np.zeros((256, 256, spp), dtype=arr.dtype)
                hh, ww = min(256, h - y0), min(256, w - x0)
                block[:hh, :ww] = arr[y0:y0 + hh, x0:x0 + ww]
                chunks.append(block.tobytes())
    else:
        rps = max(1, min(h, (1 << 16) // max(1, w * spp * dt.itemsize) + 1))
        chunks = [arr[y0:y0 + rps].tobytes() for y0 in range(0, h, rps)]
    if compress == 'deflate':
        chunks = [zlib.compress(c, 6) for c in chunks]
    elif compress is not None:
        raise NotImplementedError(f'TIFF compression {compress!r} is not '
                                  'written')

    entries = [
        (_T_WIDTH, 3, w), (_T_HEIGHT, 3, h),
        (_T_BPS, 3, (dt.itemsize * 8,) * spp),
        (_T_COMPRESSION, 3, 8 if compress == 'deflate' else 1),
        (_T_PHOTO, 3, 2 if spp >= 3 else 1), (_T_SPP, 3, spp),
        (_T_PLANAR, 3, 1),
        (_T_SAMPLE_FORMAT, 3, ({'u': 1, 'i': 2, 'f': 3}[dt.kind],) * spp),
    ]
    if spp > 3:
        entries.append((338, 3, (0,) * (spp - 3)))     # ExtraSamples
    if transform is not None:
        a, _, c, _, e, f = transform
        entries.append((_T_PIXEL_SCALE, 12, (a, -e, 0.0)))
        entries.append((_T_TIEPOINT, 12, (0.0, 0.0, 0.0, c, f, 0.0)))
    if crs is not None:
        gk, gascii = _geokeys_for_crs(crs)
        entries.append((_T_GEO_KEYS, 3, gk))
        if gascii:
            entries.append((_T_GEO_ASCII, 2, gascii))
    if nodata is not None:
        entries.append((_T_GDAL_NODATA, 2, 'nan' if np.isnan(nodata)
                        else repr(float(nodata))))
    if rpc is not None:
        if not isinstance(rpc, (tuple, list, np.ndarray)):
            from .rpc_io import rpc_to_tag_values
            rpc = rpc_to_tag_values(rpc)
        entries.append((_T_RPC, 12, tuple(float(v) for v in rpc)))
    if tags:
        entries.append((_T_GDAL_METADATA, 2, '<GDALMetadata>\n' + ''.join(
            f'  <Item name="{k}">{v}</Item>\n' for k, v in tags.items())
            + '</GDALMetadata>\n'))
    if tiled:
        entries += [(_T_TILE_W, 3, 256), (_T_TILE_H, 3, 256)]
        off_tag, cnt_tag = _T_TILE_OFFSETS, _T_TILE_COUNTS
    else:
        entries.append((_T_ROWS_PER_STRIP, 3, rps))
        off_tag, cnt_tag = _T_STRIP_OFFSETS, _T_STRIP_COUNTS
    entries += [(off_tag, 4, (0,) * len(chunks)),
                (cnt_tag, 4, tuple(len(c) for c in chunks))]
    entries.sort(key=lambda e: e[0])

    header_size = 8
    heap_base = header_size + 2 + len(entries) * 12 + 4
    # the heap's size fixes where the data starts: size it, then lay out
    heap = bytearray()
    for tag, typ, values in entries:
        _pack_tag(tag, typ, values, heap, heap_base)
    pos = heap_base + len(heap)
    offs = []
    for c in chunks:
        offs.append(pos)
        pos += len(c) + len(c) % 2
    entries = [(t, ty, tuple(offs) if t == off_tag else v)
               for t, ty, v in entries]
    heap = bytearray()
    packed = [_pack_tag(t, ty, v, heap, heap_base) for t, ty, v in entries]

    out = bytearray(b'II*\0' + struct.pack('<I', header_size))
    out += struct.pack('<H', len(entries))
    for p in packed:
        out += p
    out += struct.pack('<I', 0)
    out += heap
    for c in chunks:
        out += c
        if len(c) % 2:
            out += b'\0'
    with open(path, 'wb') as f:
        f.write(bytes(out))


def _geokeys_for_crs(crs):
    """The GeoKey directory and GeoAscii text of a CRS: a projected one
    (UTM) by its EPSG code and name, in metres, else a geographic one.  A
    vertical datum ('+5773') is not written, as the JAX package writes
    none."""
    from . import crs as crsmod
    if isinstance(crs, (str, int)):
        crs = crsmod.CRS(crs)
    name = crs.name
    keys = [(1025, 0, 1, 1)]                           # RasterPixelIsArea
    if crs.is_projected:
        keys.insert(0, (1024, 0, 1, 1))
        keys.append((1026, _T_GEO_ASCII, len(name) + 1, 0))
        keys.append((2049, _T_GEO_ASCII, 7, len(name) + 1))
        keys.append((3072, 0, 1, crs.epsg))
        keys.append((3076, 0, 1, 9001))                # metres
        gascii = name + '|WGS 84|'
    else:
        keys.insert(0, (1024, 0, 1, 2))
        keys.append((2048, 0, 1, crs.epsg or 4326))
        gascii = ''
    keys.sort(key=lambda k: k[0])
    flat = [1, 1, 0, len(keys)]
    for k in keys:
        flat.extend(k)
    return tuple(flat), gascii


# --------------------------------------------------------------------- #
# PNG
# --------------------------------------------------------------------- #

_PNG_SIG = b'\x89PNG\r\n\x1a\n'


def _png_chunk(kind, payload):
    return (struct.pack('>I', len(payload)) + kind + payload
            + struct.pack('>I', zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path, array):
    """Write a 2-D uint8 (or bool, as 0/255) array as an 8-bit grey PNG,
    or an (h, w, 3) uint8 array as an 8-bit RGB one."""
    arr = np.asarray(array)
    if arr.dtype == bool:
        arr = arr.astype(np.uint8) * 255
    rgb = arr.ndim == 3 and arr.shape[2] == 3
    if not (arr.ndim == 2 or rgb) or arr.dtype != np.uint8:
        raise ValueError(f'write_png takes a 2-D or (h, w, 3) uint8 array, '
                         f'got {arr.dtype} {arr.shape}')
    h, w = arr.shape[:2]
    rows = np.zeros((h, 1 + arr[0].size), np.uint8)  # filter byte 0 a row
    rows[:, 1:] = arr.reshape(h, -1)
    with open(path, 'wb') as f:
        f.write(_PNG_SIG
                + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8,
                                                  2 if rgb else 0, 0, 0, 0))
                + _png_chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b'IEND', b''))


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw, h, stride, bpp, path):
    """Undo the PNG row filters of ``raw`` ((h, 1 + stride) bytes, the
    filter type first in each row); ``bpp`` is the filters' byte step."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = row
        elif ftype == 1:                         # Sub
            cur = (np.cumsum(row.reshape(-1, bpp), axis=0) & 0xFF).ravel()
        elif ftype == 2:                         # Up
            cur = (row + prior) & 0xFF
        elif ftype == 3:                         # Average
            cur = np.empty(stride, np.int32)
            for x in range(stride):
                left = int(cur[x - bpp]) if x >= bpp else 0
                cur[x] = (int(row[x]) + ((left + int(prior[x])) >> 1)) & 0xFF
        elif ftype == 4:                         # Paeth
            cur = np.empty(stride, np.int32)
            for x in range(stride):
                left = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prior[x])
                c = int(prior[x - bpp]) if x >= bpp else 0
                p = left + b - c
                pa, pb, pc = abs(p - left), abs(p - b), abs(p - c)
                pred = left if pa <= pb and pa <= pc else (b if pb <= pc
                                                           else c)
                cur[x] = (int(row[x]) + pred) & 0xFF
        else:
            raise ValueError(f'{path}: bad PNG filter type {ftype}')
        out[y] = cur
        prior = cur
    return out


def read_png(path):
    """A PNG as the array PIL's ``np.array(Image.open(path))`` gives:
    grey of 1 bit as bool, of 2 and 4 bits scaled to 8-bit, of 8 bits as
    uint8 and of 16 bits as uint16, all (h, w); palette images as their
    uint8 indices; grey-alpha, RGB and RGBA as (h, w, 2, 3 or 4) uint8,
    16-bit samples cut to their high byte (16-bit grey-alpha as RGBA).
    Interlaced files are refused."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f'{path} is not a PNG file')
    i, idat, hdr = 8, [], None
    while i < len(data):
        n, = struct.unpack('>I', data[i:i + 4])
        kind, payload = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', payload)
        elif kind == b'IDAT':
            idat.append(payload)
        elif kind == b'IEND':
            break
        i += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    nch = _PNG_CHANNELS.get(color)
    if (nch is None or interlace != 0
            or depth not in ((1, 2, 4, 8, 16) if color == 0 else
                             (1, 2, 4, 8) if color == 3 else (8, 16))):
        raise NotImplementedError(
            f'{path}: PNG of bit depth {depth}, colour type {color}, '
            f'interlace {interlace} is not supported')
    bits = w * nch * depth
    stride = -(-bits // 8)
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)[
        :h * (stride + 1)].reshape(h, stride + 1)
    rows = _unfilter(raw, h, stride, max(1, nch * depth // 8), path)
    if depth < 8:
        vals = np.unpackbits(rows, axis=1)[:, :bits].reshape(h, w, depth)
        idx = (vals.astype(np.uint8) << np.arange(depth - 1, -1, -1,
                                                  dtype=np.uint8)).sum(
            axis=2, dtype=np.uint8)
        if color == 3:
            return idx
        if depth == 1:
            return idx.astype(bool)
        return (idx * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if depth == 16:
        a = rows.view('>u2').reshape(h, w, nch)
        a = a.astype(np.uint16) if color == 0 else (a >> 8).astype(np.uint8)
        if color == 4:                           # PIL opens it as RGBA
            a = a[:, :, [0, 0, 0, 1]]
    else:
        a = rows.reshape(h, w, nch)
    return a[:, :, 0] if nch == 1 else a
