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
:func:`plyflatten_device`, the counterpart of the JAX package's
``plyflatten_jax``, is the single-cell splat as a scatter-add on the
device, in the cloud's own dtype.
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


# --------------------------------------------------------------------- #
# Device scatter path (the JAX package's plyflatten_jax)
# --------------------------------------------------------------------- #

def plyflatten_device(xyzw, xoff, yoff, resolution, xsize, ysize,
                      sigma=None, device=None):
    """Single-cell (radius 0) gaussian splat as a scatter-add on the device.

    Args:
        xyzw: (n, 3+) array or tensor of x, y, payload...; invalid rows NaN.
        sigma: the gaussian's spread; None means ``resolution``.
        device: None runs on CUDA and raises without it; "cpu" runs there.

    Returns:
        (ysize, xsize, nch) tensor in ``xyzw``'s dtype, NaN where no point
        fell.  Points outside the grid and rows with a non-finite value go
        to an overflow bucket that is dropped; each cell is its points'
        payloads weighted by exp(-d^2 / (2 sigma^2)) of their distance to
        its centre, over a weight floored at 1e-30.  On the card the adds
        are atomic, so their order, and the last bits of a cell with
        several points, may change from run to run.
    """
    import torch
    from ..device import resolve

    dev = resolve(device)
    xyzw = torch.as_tensor(xyzw).to(dev)
    xoff, yoff, res = float(xoff), float(yoff), float(resolution)
    sigma = res if sigma is None else float(sigma)
    x, y, payload = xyzw[:, 0], xyzw[:, 1], xyzw[:, 2:]
    good = (torch.isfinite(x) & torch.isfinite(y)
            & torch.isfinite(payload).all(dim=1))

    # cells as integers; the clamp keeps the conversion defined and
    # changes no in-grid cell
    j0 = torch.floor((x - xoff) / res).clamp(-1, xsize).to(torch.int64)
    i0 = torch.floor((yoff - y) / res).clamp(-1, ysize).to(torch.int64)
    inb = good & (j0 >= 0) & (j0 < xsize) & (i0 >= 0) & (i0 < ysize)
    flat = torch.where(inb, i0 * xsize + j0, ysize * xsize)

    cx = xoff + (j0.to(x.dtype) + 0.5) * res
    cy = yoff - (i0.to(x.dtype) + 0.5) * res
    d2 = (x - cx) ** 2 + (y - cy) ** 2
    w = torch.where(inb, torch.exp(-d2 / (2 * sigma * sigma)),
                    torch.zeros((), dtype=x.dtype, device=dev))

    size = ysize * xsize + 1
    wacc = torch.zeros(size, dtype=x.dtype, device=dev).index_add_(0, flat, w)
    pay = torch.nan_to_num(payload) * w[:, None]
    acc = torch.zeros((size, payload.shape[1]), dtype=x.dtype,
                      device=dev).index_add_(0, flat, pay)
    out = acc[:-1] / torch.clamp(wacc[:-1], min=1e-30)[:, None]
    out = torch.where(wacc[:-1, None] > 0, out,
                      torch.full((), float('nan'), dtype=x.dtype, device=dev))
    return out.reshape(ysize, xsize, payload.shape[1])
