"""Tile validity masks from vector (GML) and raster sources, and the
erosion step of stage 4.

Counterpart of ``s2p_tpu/core/masking.py``.  The JAX package burns the
GML polygons with PIL's polygon fill; the port does not import PIL, so
:func:`rasterize_polygons` carries that fill (libImaging's
``polygon_generic``, vertices truncated to integers) in numpy, row by
row, with its float32 crossings and its rounding, and a non-TIFF raster
mask is read by :func:`s2p_tpu_torch.geo.geotiff.read_png`.
"""

from __future__ import annotations

import math
import re

import numpy as np

from ..geo import geotiff
from ..ops.morphology import binary_erosion


def read_gml_polygons(path):
    """Extract polygons (lists of (x, y) image coordinates) from a GML file.

    Handles the Pleiades/DIMAP mask flavour: coordinate lists appear in
    <gml:posList> or <gml:coordinates> elements.
    """
    with open(path, 'r', errors='replace') as f:
        text = f.read()
    polys = []
    for m in re.finditer(r'<gml:posList[^>]*>(.*?)</gml:posList>', text, re.S):
        vals = [float(v) for v in m.group(1).split()]
        pts = list(zip(vals[0::2], vals[1::2]))
        if len(pts) >= 3:
            polys.append(pts)
    for m in re.finditer(r'<gml:coordinates[^>]*>(.*?)</gml:coordinates>',
                         text, re.S):
        pts = []
        for pair in m.group(1).replace('\n', ' ').split():
            xy = pair.split(',')
            if len(xy) >= 2:
                pts.append((float(xy[0]), float(xy[1])))
        if len(pts) >= 3:
            polys.append(pts)
    return polys


def _round_up(f):
    """libImaging's ROUND_UP of a float32 array: floorf(f + 0.5f), or
    -floor(|f| + 0.5) in double below 0."""
    neg = -np.floor(np.abs(f).astype(np.float64) + 0.5)
    return np.where(f >= 0, np.floor(f + np.float32(0.5)), neg) \
        .astype(np.int64)


def _round_down(f):
    """libImaging's ROUND_DOWN of a float32 array: ceilf(f - 0.5f), or
    -ceil(|f| - 0.5) in double below 0."""
    neg = -np.ceil(np.abs(f).astype(np.float64) - 0.5)
    return np.where(f >= 0, np.ceil(f - np.float32(0.5)), neg) \
        .astype(np.int64)


def _roundf(v):
    """C's roundf of a float32: halves away from zero."""
    r = math.floor(abs(float(v)) + 0.5)
    return r if v >= 0 else -r


def _edges(xy):
    """The fill's edge list of one polygon of integer vertices: each edge
    [x0, y0, xmin, ymin, xmax, ymax, dx] with dx its float32 slope, a run
    of horizontal edges going one way merged into one."""
    edges = []

    def add(x0, y0, x1, y1):
        dx = 0.0 if y0 == y1 else float(np.float32(x1 - x0)
                                        / np.float32(y1 - y0))
        edges.append([x0, y0, min(x0, x1), min(y0, y1), max(x0, x1),
                      max(y0, y1), dx])

    n = len(xy)
    for i in range(n - 1):
        (x0, y0), (x1, y1) = xy[i], xy[i + 1]
        if y0 == y1 and i != 0 and y0 == xy[i - 1][1]:
            xp = xy[i - 1][0]
            if x1 > x0 > xp:
                edges[-1][4] = x1
                continue
            if x1 < x0 < xp:
                edges[-1][2] = x1
                continue
        add(x0, y0, x1, y1)
    if xy[-1] != xy[0]:
        add(*xy[-1], *xy[0])
    return edges


def _hline(mask, x0, y, x1):
    h, w = mask.shape
    if 0 <= y < h and x0 < w and x1 >= 0:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            mask[y, x0:x1 + 1] = True


def _fill_polygon(mask, xy):
    """Fill one polygon of integer vertices into the boolean ``mask``.

    libImaging's scan-line fill (``polygon_generic``, Draw.c), row by row:
    each edge's crossing (y - y0) * dx + x0 in float32; an edge ending on
    the row counts twice, unless the row is the last; an edge that starts
    on the row (or ends on the last) and whose crossing rounds to that of
    an earlier edge also at one of its ends, which reaches the next row
    (the last: the previous one), is a corner: where its crossing lies
    more than 1 px beyond both edges' crossings on that row, it moves to
    the rounded nearer of them, 1 px beyond; spans between sorted
    crossings, ends rounded half up (start) and half down (end)."""
    edges = _edges(xy)
    ymin, ymax = mask.shape[0] - 1, 0
    table = []
    for e in edges:
        ymin, ymax = min(ymin, e[3]), max(ymax, e[5])
        if e[3] == e[5]:
            _hline(mask, e[2], e[3], e[4])
            continue
        table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, mask.shape[0])
    if not table:
        return
    ints = np.array([(e[0], e[1], e[3], e[5]) for e in table], np.int64)
    ex0 = ints[:, 0].astype(np.float32)
    ey0, lo, hi = ints[:, 1], ints[:, 2], ints[:, 3]
    dx = np.array([e[6] for e in table], np.float32)
    one = np.float32(1.0)

    def at(k, y):
        return np.float32(y - ey0[k]) * dx[k] + ex0[k]

    for y in range(ymin, ymax + 1):
        act = np.flatnonzero((lo <= y) & (hi >= y))
        if not act.size:
            continue
        xs = np.float32(y - ey0[act]) * dx[act] + ex0[act]
        crossed = xs.copy()
        dup = (hi[act] == y) & (y < ymax)
        # the edges at one of their end rows with a slope: the corner
        # candidates and the earlier edges they are held against
        ends = np.flatnonzero(((lo[act] == y) | (hi[act] == y))
                              & (dx[act] != 0))
        for n, p in enumerate(ends):
            if dup[p]:
                continue
            i, x = act[p], crossed[p]
            adj = y - 1 if y == hi[i] else y + 1
            for q in ends[:n]:
                k = act[q]
                if (_roundf(x) != _roundf(crossed[q])
                        or not lo[k] <= adj <= hi[k]):
                    continue
                a, b = at(i, adj), at(k, adj)
                if x > a + one and x > b + one:
                    xs[p] = np.float32(_roundf(max(a, b))) + one
                elif x < a - one and x < b - one:
                    xs[p] = np.float32(_roundf(min(a, b))) - one
                break
        xs = np.sort(np.concatenate([xs, xs[dup]]))
        for x0, x1 in zip(_round_up(xs[0::2]), _round_down(xs[1::2])):
            _hline(mask, int(x0), y, int(x1))


def rasterize_polygons(polys, w, h, offset=(0, 0)):
    """Burn polygons into a (h, w) boolean mask (True inside).

    The fill of the JAX package's PIL call (``ImageDraw.polygon(...,
    fill=1)`` on a 1-bit image), vertex coordinates shifted by
    ``offset`` and truncated to integers."""
    mask = np.zeros((int(h), int(w)), dtype=bool)
    ox, oy = offset
    for pts in polys:
        xy = [(int(x - ox), int(y - oy)) for x, y in pts]
        if xy:
            _fill_polygon(mask, xy)
    return mask


def image_tile_mask(x, y, w, h, roi_gml=None, cld_gml=None, raster_mask=None,
                    img_shape=None, border_margin=10):
    """Validity mask of a tile: ROI polygons AND NOT clouds AND raster mask
    AND image-border margin."""
    x, y, w, h = map(int, (x, y, w, h))
    mask = np.ones((h, w), dtype=bool)

    if roi_gml is not None:
        polys = read_gml_polygons(roi_gml)
        mask &= rasterize_polygons(polys, w, h, offset=(x, y))
        if not mask.any():
            return mask

    if cld_gml is not None:
        polys = read_gml_polygons(cld_gml)
        mask &= ~rasterize_polygons(polys, w, h, offset=(x, y))
        if not mask.any():
            return mask

    if raster_mask is not None:
        arr = geotiff.read(raster_mask, window=(x, y, w, h), boundless=True,
                           fill_value=0) \
            if raster_mask.endswith(('.tif', '.tiff')) \
            else _read_any_window(raster_mask, x, y, w, h)
        mask &= np.asarray(arr).astype(bool)
        if not mask.any():
            return mask

    if img_shape is not None:
        hh, ww = img_shape
        b = border_margin
        rows = np.arange(y, y + h)
        cols = np.arange(x, x + w)
        inside_r = (rows >= b) & (rows < hh - b)
        inside_c = (cols >= b) & (cols < ww - b)
        mask &= inside_r[:, None] & inside_c[None, :]
    return mask


def _read_any_window(path, x, y, w, h):
    """The (x, y, w, h) window of a PNG raster mask, 0 outside it."""
    arr = geotiff.read_png(path)
    out = np.zeros((h, w) + arr.shape[2:], dtype=arr.dtype)
    y0, y1 = max(y, 0), min(y + h, arr.shape[0])
    x0, x1 = max(x, 0), min(x + w, arr.shape[1])
    if y0 < y1 and x0 < x1:
        out[y0 - y:y1 - y, x0 - x:x1 - x] = arr[y0:y1, x0:x1]
    return out


def erosion(mask, radius):
    """Disk erosion of a boolean mask."""
    return binary_erosion(mask, radius)
