"""TIFF and PNG raster IO in numpy and zlib alone.

Stage 4 reads the rectified pair as TIFF and writes the disparity and
confidence maps as float32 TIFF and the validity mask as an 8-bit grey
PNG.  The port's machines have no PIL, rasterio or GDAL, so this module
carries the subset it needs:

  * TIFF read: classic TIFF, first IFD, uncompressed strips of chunky
    samples, any integer or float sample type (the layout both packages
    write);
  * TIFF write: one band in uncompressed strips, with the GDAL nodata
    tag -- byte for byte what ``s2p_tpu.geo.geotiff.write`` writes for a
    2-D array;
  * PNG write and read of 8-bit grey images (the reader undoes all five
    PNG row filters, so it also reads files written by other encoders).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_T_WIDTH, _T_HEIGHT = 256, 257
_T_BPS, _T_COMPRESSION, _T_PHOTO = 258, 259, 262
_T_STRIP_OFFSETS, _T_SPP, _T_ROWS_PER_STRIP, _T_STRIP_COUNTS = 273, 277, 278, 279
_T_PLANAR, _T_PREDICTOR = 284, 317
_T_TILE_OFFSETS = 324
_T_SAMPLE_FORMAT = 339
_T_GDAL_NODATA = 42113

_TYPE_FMT = {1: 'B', 2: 'c', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 7: 'B',
             8: 'h', 9: 'i', 10: 'ii', 11: 'f', 12: 'd', 16: 'Q', 17: 'q'}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8, 16: 8, 17: 8}


def _tags(data):
    """(byte order, {tag: value}) of the first IFD of a classic TIFF."""
    if data[:2] == b'II':
        en = '<'
    elif data[:2] == b'MM':
        en = '>'
    else:
        raise ValueError('not a TIFF file')
    if struct.unpack(en + 'H', data[2:4])[0] != 42:
        raise NotImplementedError('only classic TIFF is supported')
    off, = struct.unpack(en + 'I', data[4:8])
    n, = struct.unpack(en + 'H', data[off:off + 2])
    tags = {}
    for i in range(n):
        e = data[off + 2 + 12 * i:off + 14 + 12 * i]
        tag, typ, cnt = struct.unpack(en + 'HHI', e[:8])
        if typ not in _TYPE_FMT:
            continue
        size = _TYPE_SIZE[typ] * cnt
        if size <= 4:
            raw = e[8:8 + size]
        else:
            p, = struct.unpack(en + 'I', e[8:12])
            raw = data[p:p + size]
        if typ == 2:
            val = raw.split(b'\0')[0].decode('latin1')
        else:
            v = struct.unpack(en + _TYPE_FMT[typ] * cnt, raw)
            if typ in (5, 10):
                v = tuple(v[j] / max(v[j + 1], 1) for j in range(0, len(v), 2))
            val = v[0] if len(v) == 1 else v
        tags[tag] = val
    return en, tags


def _first(v):
    return v[0] if isinstance(v, tuple) else v


def read(path):
    """A TIFF as an (h, w) or (h, w, bands) array."""
    with open(path, 'rb') as f:
        data = f.read()
    en, t = _tags(data)
    w, h = t[_T_WIDTH], t[_T_HEIGHT]
    spp = t.get(_T_SPP, 1)
    if (t.get(_T_COMPRESSION, 1), t.get(_T_PLANAR, 1),
            t.get(_T_PREDICTOR, 1)) != (1, 1, 1) or _T_TILE_OFFSETS in t:
        raise NotImplementedError(f'{path}: only uncompressed chunky strips '
                                  'are supported')
    kind = {1: 'u', 2: 'i', 3: 'f'}[_first(t.get(_T_SAMPLE_FORMAT, 1))]
    dt = np.dtype(f'{en}{kind}{_first(t.get(_T_BPS, 1)) // 8}')
    rps = t.get(_T_ROWS_PER_STRIP, h)
    offs, cnts = t[_T_STRIP_OFFSETS], t[_T_STRIP_COUNTS]
    offs = offs if isinstance(offs, tuple) else (offs,)
    cnts = cnts if isinstance(cnts, tuple) else (cnts,)
    out = np.zeros((h, w, spp), dtype=dt.newbyteorder('='))
    for k, (o, c) in enumerate(zip(offs, cnts)):
        y0 = k * rps
        hh = min(rps, h - y0)
        out[y0:y0 + hh] = np.frombuffer(data[o:o + c], dtype=dt,
                                        count=hh * w * spp).reshape(hh, w, spp)
    return out[:, :, 0] if spp == 1 else out


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


def write(path, array, nodata=None):
    """Write a 2-D array as a single-band strip TIFF."""
    arr = np.asarray(array)
    if arr.ndim != 2:
        raise ValueError(f'write takes a 2-D array, got {arr.shape}')
    h, w = arr.shape
    dt = arr.dtype
    arr = np.ascontiguousarray(arr, dtype=dt.newbyteorder('<'))
    rps = max(1, min(h, (1 << 16) // max(1, w * dt.itemsize) + 1))
    chunks = [arr[y0:y0 + rps].tobytes() for y0 in range(0, h, rps)]

    entries = [
        (_T_WIDTH, 3, w), (_T_HEIGHT, 3, h), (_T_BPS, 3, dt.itemsize * 8),
        (_T_COMPRESSION, 3, 1), (_T_PHOTO, 3, 1), (_T_SPP, 3, 1),
        (_T_PLANAR, 3, 1),
        (_T_SAMPLE_FORMAT, 3, {'u': 1, 'i': 2, 'f': 3}[dt.kind]),
        (_T_ROWS_PER_STRIP, 3, rps),
        (_T_STRIP_OFFSETS, 4, tuple([0] * len(chunks))),
        (_T_STRIP_COUNTS, 4, tuple(len(c) for c in chunks)),
    ]
    if nodata is not None:
        entries.append((_T_GDAL_NODATA, 2, 'nan' if np.isnan(nodata)
                        else repr(float(nodata))))
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
    entries = [(t, ty, tuple(offs) if t == _T_STRIP_OFFSETS else v)
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


# --------------------------------------------------------------------- #
# PNG, 8-bit grey
# --------------------------------------------------------------------- #

_PNG_SIG = b'\x89PNG\r\n\x1a\n'


def _png_chunk(kind, payload):
    return (struct.pack('>I', len(payload)) + kind + payload
            + struct.pack('>I', zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path, array):
    """Write a 2-D uint8 (or bool, as 0/255) array as an 8-bit grey PNG."""
    arr = np.asarray(array)
    if arr.dtype == bool:
        arr = arr.astype(np.uint8) * 255
    if arr.ndim != 2 or arr.dtype != np.uint8:
        raise ValueError(f'write_png takes a 2-D uint8 array, got '
                         f'{arr.dtype} {arr.shape}')
    h, w = arr.shape
    rows = np.zeros((h, w + 1), np.uint8)       # filter byte 0 per row
    rows[:, 1:] = arr
    with open(path, 'wb') as f:
        f.write(_PNG_SIG
                + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 0,
                                                  0, 0, 0))
                + _png_chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b'IEND', b''))


def _paeth_row(raw, prior):
    out = np.empty_like(raw, dtype=np.int32)
    left = 0
    for x in range(raw.shape[0]):
        b = int(prior[x])
        c = int(prior[x - 1]) if x else 0
        p = left + b - c
        pa, pb, pc = abs(p - left), abs(p - b), abs(p - c)
        pred = left if pa <= pb and pa <= pc else (b if pb <= pc else c)
        left = (int(raw[x]) + pred) & 0xFF
        out[x] = left
    return out


def read_png(path):
    """An 8-bit grey PNG as a 2-D uint8 array."""
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
    if (depth, color, interlace) != (8, 0, 0):
        raise NotImplementedError(f'{path}: only 8-bit grey, non-interlaced '
                                  'PNG is supported')
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8) \
        .reshape(h, w + 1)
    out = np.zeros((h, w), np.int32)
    prior = np.zeros(w, np.int32)
    for y in range(h):
        ftype, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = row
        elif ftype == 1:                         # Sub
            cur = np.cumsum(row) & 0xFF
        elif ftype == 2:                         # Up
            cur = (row + prior) & 0xFF
        elif ftype == 3:                         # Average
            cur = np.empty(w, np.int32)
            left = 0
            for x in range(w):
                left = (int(row[x]) + ((left + int(prior[x])) >> 1)) & 0xFF
                cur[x] = left
        elif ftype == 4:                         # Paeth
            cur = _paeth_row(row, prior)
        else:
            raise ValueError(f'{path}: bad PNG filter type {ftype}')
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)
