"""Mosaic per-tile image-grid rasters into a raster of the whole ROI.

Replaces the reference's ``utils/s2p_mosaic.py`` (GDAL VRT based): stitches
any per-tile sub-image (e.g. ``pair_1/height_map.tif``) at the ROI each
tile's ``config.json`` gives; missing tiles are skipped with a warning.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np

from ..geo import geotiff


def global_extent(tiles_cfgs):
    """Union of the tile ROIs as (x, y, w, h)."""
    xmin = ymin = np.inf
    xmax = ymax = -np.inf
    for cfg in tiles_cfgs:
        roi = cfg['roi']
        xmin = min(xmin, roi['x'])
        ymin = min(ymin, roi['y'])
        xmax = max(xmax, roi['x'] + roi['w'])
        ymax = max(ymax, roi['y'] + roi['h'])
    return int(xmin), int(ymin), int(xmax - xmin), int(ymax - ymin)


def main(tiles_file, outfile, sub_img):
    """Stitch ``sub_img`` of every tile listed in tiles.txt into ``outfile``.

    Args:
        tiles_file: path to the out_dir/tiles.txt of a finished run.
        outfile: output GeoTIFF path.
        sub_img: tile-relative raster path (e.g. 'pair_1/height_map.tif').

    Returns:
        the mosaic, float32 with NaN where no tile wrote.
    """
    outdir = os.path.dirname(os.path.abspath(tiles_file))
    with open(tiles_file) as f:
        tile_jsons = [line.strip() for line in f if line.strip()]

    cfgs = []
    dirs = []
    for tj in tile_jsons:
        p = os.path.join(outdir, tj)
        with open(p) as f:
            cfgs.append(json.load(f))
        dirs.append(os.path.dirname(p))

    x0, y0, w, h = global_extent(cfgs)
    out = np.full((h, w), np.nan, dtype=np.float32)

    for cfg, d in zip(cfgs, dirs):
        sub = os.path.join(d, sub_img)
        if not os.path.exists(sub):
            warnings.warn(f'missing tile sub-image {sub}')
            continue
        arr = geotiff.read_with_nans(sub)
        roi = cfg['roi']
        yy = roi['y'] - y0
        xx = roi['x'] - x0
        out[yy:yy + arr.shape[0], xx:xx + arr.shape[1]] = arr

    geotiff.write(outfile, out, nodata=float('nan'))
    return out
