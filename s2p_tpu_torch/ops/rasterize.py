"""Point-cloud rasterization: the ``plyflatten`` of stage 6 (the port's own
copy of ``s2p_tpu/ops/rasterize.py``'s host path, numpy only).

Splats 3D points (with colour / confidence payloads) onto a regular UTM
grid by weighted accumulation:

  * grid convention: ``xoff = floor(xmin/res)*res`` (left edge),
    ``yoff = ceil(ymax/res)*res`` (top edge); cell (i, j) covers
    x in [xoff + j*res, xoff + (j+1)*res), y in (yoff - (i+1)*res, yoff - i*res];
  * each point contributes to every cell whose center lies within ``radius``
    cells, with weight exp(-d^2 / (2 sigma^2)) of the point-to-cell-center
    distance; ``sigma=None`` means uniform weights (with radius 0 each
    cell is then the plain average of its points);
  * each output channel is the weighted average of the corresponding point
    payload column.

The accumulation is a float64 scatter-add (``np.add.at``) and the output
float32, so a tile's rasterization and the whole scene's round the same
points to the same values: the seamlessness of the mosaic rests on it.
The JAX package's ``plyflatten_jax`` device path is not ported yet.
"""

from __future__ import annotations

import numpy as np


def grid_from_roi(xmin, ymin, xmax, ymax, resolution):
    """Compute (xoff, yoff, xsize, ysize) covering the bounds, aligned to the
    resolution grid (the arithmetic of the reference s2p)."""
    r = resolution
    xoff = np.floor(xmin / r) * r
    xsize = int(1 + np.floor((xmax - xoff) / r))
    yoff = np.ceil(ymax / r) * r
    ysize = int(1 - np.floor((ymin - yoff) / r))
    return xoff, yoff, xsize, ysize


def plyflatten(points, xoff, yoff, resolution, xsize, ysize,
               radius=0, sigma=None):
    """Rasterize points onto a grid.

    Args:
        points: (n, k) array; columns 0,1 are x,y; columns 2..k are payloads
            (z, r, g, b, confidence, ...).
        xoff, yoff: top-left grid corner (x left edge, y top edge).
        resolution: cell size.
        radius: neighborhood radius in cells (0 = only the containing cell).
        sigma: gaussian spread; None = uniform weights (plain average).

    Returns:
        raster of shape (ysize, xsize, k-2): weighted average per channel,
        NaN where no point contributed.
    """
    points = np.asarray(points, dtype=np.float64)
    n, k = points.shape
    nch = k - 2
    sigma = np.inf if sigma is None else sigma

    acc = np.zeros((ysize * xsize, nch), dtype=np.float64)
    wacc = np.zeros(ysize * xsize, dtype=np.float64)

    x = points[:, 0]
    y = points[:, 1]
    payload = points[:, 2:]
    good = np.isfinite(x) & np.isfinite(y) & np.all(np.isfinite(payload), axis=1)
    x, y, payload = x[good], y[good], payload[good]

    fj = (x - xoff) / resolution
    fi = (yoff - y) / resolution
    j0 = np.floor(fj).astype(np.int64)
    i0 = np.floor(fi).astype(np.int64)

    r = int(radius)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    for dj in range(-r, r + 1):
        for di in range(-r, r + 1):
            jj = j0 + dj
            ii = i0 + di
            inb = (jj >= 0) & (jj < xsize) & (ii >= 0) & (ii < ysize)
            if not inb.any():
                continue
            # distance from point to the center of cell (ii, jj)
            cx = xoff + (jj[inb] + 0.5) * resolution
            cy = yoff - (ii[inb] + 0.5) * resolution
            d2 = (x[inb] - cx) ** 2 + (y[inb] - cy) ** 2
            wgt = np.exp(-d2 * inv2s2)
            flat = ii[inb] * xsize + jj[inb]
            np.add.at(wacc, flat, wgt)
            np.add.at(acc, flat, wgt[:, None] * payload[inb])

    with np.errstate(invalid='ignore', divide='ignore'):
        out = acc / wacc[:, None]
    out[wacc == 0] = np.nan
    # float32 output raster (the reference plyflatten's contract): the
    # accumulation stays f64, so tilewise and monolithic rasterizations of
    # the same points round to BITWISE-equal f32 values
    return out.reshape(ysize, xsize, nch).astype(np.float32)


def plyflatten_from_plyfiles_list(clouds_list, resolution, roi=None,
                                  radius=0, sigma=None):
    """Rasterize a list of PLY files.

    Args:
        clouds_list: list of paths to .ply clouds.
        resolution: cell size (same units as the cloud CRS).
        roi: optional (xoff, yoff, xsize, ysize); derived from the data extent
            when None.

    Returns:
        (raster, profile): raster of shape (ysize, xsize, nch); profile is a
        :class:`s2p_tpu_torch.geo.geotiff.Profile` with the UTM transform and CRS
        parsed from the cloud comments.
    """
    from ..geo import crs as crsmod
    from ..geo import ply as plymod
    from ..geo.geotiff import Profile

    arrays = []
    crs = None
    for path in clouds_list:
        try:
            arr, comments = plymod.read_ply(path)
        except (OSError, ValueError):
            continue
        arrays.append(arr)
        for c in comments:
            if 'projection' in c and 'CRS' in c:
                crs = c.split('CRS')[-1].strip()
    if not arrays:
        raise ValueError('no readable point cloud in the input list')
    width = max(a.shape[1] for a in arrays)
    # pad payloads to a common channel count (some tiles may lack confidence)
    arrays = [np.pad(a, ((0, 0), (0, width - a.shape[1])), constant_values=np.nan)
              if a.shape[1] < width else a for a in arrays]
    points = np.vstack(arrays)

    if roi is not None:
        xoff, yoff, xsize, ysize = roi
    else:
        xoff, yoff, xsize, ysize = grid_from_roi(
            np.nanmin(points[:, 0]), np.nanmin(points[:, 1]),
            np.nanmax(points[:, 0]), np.nanmax(points[:, 1]), resolution)

    raster = plyflatten(points, xoff, yoff, resolution, int(xsize), int(ysize),
                        radius=radius, sigma=sigma)
    profile = Profile(width=int(xsize), height=int(ysize),
                      count=raster.shape[2], dtype='float32',
                      crs=crsmod.CRS(crs) if crs else None,
                      transform=(resolution, 0.0, float(xoff),
                                 0.0, -resolution, float(yoff)),
                      nodata=float('nan'))
    return raster, profile
