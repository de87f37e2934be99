"""Debug plots of stage 1's SIFT matches, drawn in numpy.

The JAX package draws them with PIL's ``ImageDraw`` (the reference s2p
composes the crops with gdal_translate).  The port's machines have no PIL,
so this module rasterizes the same primitives by libImaging's own rules,
pixel for pixel:

  * coordinates are truncated toward zero to integers, as PIL's C layer
    casts them;
  * a 1-px line is Bresenham's from its first end, the second end drawn
    last (``ImagingDrawLine`` and the closing point of ``draw_lines``);
  * an ellipse outline of width 1 is libImaging's ``ellipseNew``: quarter
    arcs stepped on a grid of half pixels, joined into horizontal spans;
  * pixels outside the canvas are dropped, and a later primitive paints
    over an earlier one.
"""

from __future__ import annotations

import functools

import numpy as np

from ..core import rpc_geom
from ..geo import geotiff

COLORS = ((255, 0, 0), (0, 255, 0), (0, 128, 255), (255, 255, 0),
          (255, 0, 255))


def _line_pixels(x0, y0, x1, y1):
    """Every pixel of the lines (x0, y0) -> (x1, y1) (int64 arrays, one
    line per entry), Bresenham's walk from the first end along the major
    axis with its ties, then the second end.  Returns (line index, x, y)."""
    dx, dy = np.abs(x1 - x0), np.abs(y1 - y0)
    xs, ys = np.where(x1 < x0, -1, 1), np.where(y1 < y0, -1, 1)
    steep = dy >= dx            # dx == dy walks along y, as libImaging does
    major = np.where(steep, dy, dx)
    minor = np.where(steep, dx, dy)
    count = major + 1
    line = np.repeat(np.arange(len(x0)), count)
    k = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)
    maj, mnr, st = major[line], minor[line], steep[line]
    # the minor axis has moved floor((2 k minor + major) / (2 major)) times
    # before step k (0 for a line along an axis or a point)
    moved = np.where(maj > 0, (2 * k * mnr + maj) // np.maximum(2 * maj, 1),
                     0)
    x = x0[line] + xs[line] * np.where(st, moved, k)
    y = y0[line] + ys[line] * np.where(st, k, moved)
    return line, x, y


def _quarter(a, b):
    """libImaging's quarter arc of an a x b box on the grid of half pixels:
    the points (x, y) from (a, b % 2) to (a % 2, b)."""
    if a < 0 or b < 0:
        return []
    a2, b2 = a * a, b * b

    def delta(x, y):
        return abs(a2 * y * y + b2 * x * x - a2 * b2)

    cx, cy, pts = a, b % 2, []
    while True:
        pts.append((cx, cy))
        if cx == a % 2 and cy == b:
            return pts
        nx, ny = cx, cy + 2
        nd = delta(nx, ny)
        if nx > 1:
            d = delta(cx - 2, cy + 2)
            if nd > d:
                nx, ny, nd = cx - 2, cy + 2, d
            if nd > delta(cx - 2, cy):
                nx, ny = cx - 2, cy
        cx, cy = nx, ny


@functools.lru_cache(maxsize=None)
def _ellipse_offsets(a, b):
    """The pixels of a width-1 ellipse outline in an a x b box, as (dx, dy)
    offsets from its top left corner (libImaging's ``ellipseNew``: the
    outer and the inner arc, the same at width 1, walked together into
    the spans of each half-pixel row, mirrored into four quarters)."""
    outer, inner = iter(_quarter(a, b)), iter(_quarter(a, b))
    first = next(outer, None)
    if first is None:
        return np.zeros((0, 2), np.int64)          # a < 0 or b < 0
    (pr, py), pl, leftmost = first, a % 2, a % 2
    spans, finished = [], False
    while not finished:
        y, l, r = py, pl, pr
        n = next(outer, None)
        while n is not None and n[1] <= y:
            n = next(outer, None)
        if n is None:
            finished = True
        else:
            pr, py = n
        n = next(inner, None)
        while n is not None and n[1] <= y:
            l = n[0]
            n = next(inner, None)
        pl = leftmost if n is None else n[0]
        if (l > 0 or l < r) and y > 0:
            spans.append((2 if l == 0 else l, y, r))
        if y > 0:
            spans.append((-r, y, -l))
        if l > 0 or l < r:
            spans.append((2 if l == 0 else l, -y, r))
        spans.append((-r, -y, -l))
    pix = set()
    for x0, yy, x1 in spans:
        # C's truncating division; every numerator is >= 0
        lo, hi = sorted(((x0 + a) // 2, (x1 + a) // 2))
        pix.update((x, (yy + b) // 2) for x in range(lo, hi + 1))
    off = np.array(sorted(pix), np.int64).reshape(-1, 2)
    off.flags.writeable = False          # shared by every caller (cache)
    return off


def draw_matches(crop1, crop2, matches):
    """The canvas of :func:`plot_matches_low_level`: the two uint8 crops
    side by side as RGB, then for each match (x1, y1, x2, y2), in order and
    in the five colours in turn, a 1-px line from (x1, y1) to (x2 + w1, y2)
    and 5 x 5 ellipse outlines around both ends."""
    crop1, crop2 = np.asarray(crop1), np.asarray(crop2)
    h = max(crop1.shape[0], crop2.shape[0])
    w1 = crop1.shape[1]
    canvas = np.zeros((h, w1 + crop2.shape[1], 3), dtype=np.uint8)
    canvas[:crop1.shape[0], :w1] = crop1[..., None]
    canvas[:crop2.shape[0], w1:] = crop2[..., None]
    m = np.asarray(matches, dtype=np.float64).reshape(-1, 4)
    if len(m) == 0:
        return canvas
    H, W = canvas.shape[:2]
    ends = np.stack([m[:, 0], m[:, 1], m[:, 2] + w1, m[:, 3]], axis=1)
    ends = np.trunc(ends).astype(np.int64)                 # C's (int) cast
    # (order, x, y) of every painted pixel: the line of match k paints at
    # 3k, its two ellipses at 3k + 1 and 3k + 2
    line, x, y = _line_pixels(*ends.T)
    parts = [(3 * line, x, y)]
    for end, (cx, cy) in enumerate(((m[:, 0], m[:, 1]),
                                    (m[:, 2] + w1, m[:, 3]))):
        box = np.trunc(np.stack([cx - 2, cy - 2, cx + 2, cy + 2],
                                axis=1)).astype(np.int64)
        size = box[:, 2:] - box[:, :2]
        for a, b in {tuple(s) for s in size.tolist()}:
            sel = np.flatnonzero((size[:, 0] == a) & (size[:, 1] == b))
            off = _ellipse_offsets(a, b)
            parts.append((np.repeat(3 * sel + 1 + end, len(off)),
                          (box[sel, 0][:, None] + off[:, 0]).ravel(),
                          (box[sel, 1][:, None] + off[:, 1]).ravel()))
    order = np.concatenate([p[0] for p in parts])
    x = np.concatenate([p[1] for p in parts])
    y = np.concatenate([p[2] for p in parts])
    keep = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    # the last primitive to paint a pixel sets it
    last = np.full(H * W, -1, np.int64)
    np.maximum.at(last, (y * W + x)[keep], order[keep])
    painted = np.flatnonzero(last >= 0)
    colors = np.array(COLORS, np.uint8)
    canvas.reshape(-1, 3)[painted] = colors[(last[painted] // 3)
                                            % len(COLORS)]
    return canvas


def plot_matches_low_level(crop1, crop2, matches, outfile):
    """Render two uint8 crops side by side with their match segments into
    an RGB PNG (:func:`draw_matches`)."""
    geotiff.write_png(outfile, draw_matches(crop1, crop2, matches))


def plot_matches(im1, im2, rpc1, rpc2, matches, outfile, x, y, w, h):
    """Plot the matches of an ROI pair.

    Args:
        im1, im2: full image arrays.
        rpc1, rpc2: their RPC models; the ROI (x, y, w, h) of ``im1``
            gives its counterpart in ``im2``.
        matches: (n, 4) in full-image coordinates.
    """
    from ..pipeline import linear_stretching_and_quantization_8bit

    if matches is None or len(matches) == 0:
        return
    x2, y2, w2, h2 = map(int, rpc_geom.corresponding_roi(rpc1, rpc2, x, y,
                                                         w, h))
    crop1 = linear_stretching_and_quantization_8bit(
        np.asarray(im1)[y:y + h, x:x + w])
    ys0, xs0 = max(y2, 0), max(x2, 0)
    crop2 = linear_stretching_and_quantization_8bit(
        np.asarray(im2)[ys0:y2 + h2, xs0:x2 + w2])
    m = np.asarray(matches, dtype=np.float64).copy()
    m[:, 0] -= x
    m[:, 1] -= y
    m[:, 2] -= xs0
    m[:, 3] -= ys0
    plot_matches_low_level(crop1, crop2, m, outfile)
