"""ROI tiling: the tile grid, its neighbourhoods and the culling of
useless tiles (the port's own copy of ``s2p_tpu/tiling.py``).

The grid balances the tile size so that border tiles are not slivers;
each tile is a directory ``tiles/row_<y>_height_<h>/col_<x>_width_<w>``
under the output directory with its ``config.json``, its validity
``mask.png`` and a ``pair_<i>`` directory per secondary image, and it
names the directories of its 3 x 3 neighbourhood relative to itself
(``../../../tiles/...``): stages 3 and 6 read the neighbours' files
there.  Host numpy only.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .config import Config
from .core import masking, rpc_geom
from .geo import geotiff


def adjust_tile_size(cfg: Config):
    """Balance the tile size so border tiles are not slivers."""
    rw, rh = cfg.roi['w'], cfg.roi['h']
    tile_w = min(rw, cfg.tile_size)
    ntx = int(np.round(float(rw) / tile_w))
    tile_w = int(np.ceil(float(rw) / ntx))
    tile_h = min(rh, cfg.tile_size)
    nty = int(np.round(float(rh) / tile_h))
    tile_h = int(np.ceil(float(rh) / nty))
    return tile_w, tile_h


def compute_tiles_coordinates(rx, ry, rw, rh, tw, th):
    """Tile coordinate list + 3x3 neighborhood dict."""
    out = []
    neighborhood_dict = {}
    for y in np.arange(ry, ry + rh, th):
        h = min(th, ry + rh - y)
        for x in np.arange(rx, rx + rw, tw):
            w = min(tw, rx + rw - x)
            coords = (int(x), int(y), int(w), int(h))
            out.append(coords)
            neighbors = []
            for y2 in (y - th, y, y + th):
                h2 = min(th, ry + rh - y2)
                for x2 in (x - tw, x, x + tw):
                    w2 = min(tw, rx + rw - x2)
                    if rx + rw > x2 >= rx and ry + rh > y2 >= ry:
                        neighbors.append((int(x2), int(y2), int(w2), int(h2)))
            neighborhood_dict[str(coords)] = neighbors
    return out, neighborhood_dict


def get_tile_dir(x, y, w, h):
    """Relative tile directory name."""
    return os.path.join('tiles', 'row_{:07d}_height_{}'.format(y, h),
                        'col_{:07d}_width_{}'.format(x, w))


def create_tile(cfg: Config, coords, neighborhood_coords_dict):
    """Tile metadata dict."""
    tile = {'coordinates': coords,
            'dir': os.path.join(cfg.out_dir, get_tile_dir(*coords)),
            'json': os.path.join(get_tile_dir(*coords), 'config.json'),
            'neighborhood_dirs': []}
    key = str(tuple(coords))
    if cfg.neighborhood_dirs is not None:
        tile['neighborhood_dirs'] = list(cfg.neighborhood_dirs)
    elif key in neighborhood_coords_dict:
        for c2 in neighborhood_coords_dict[key]:
            tile['neighborhood_dirs'].append(
                os.path.join('../../..', get_tile_dir(*c2)))
    return tile


def rectangles_intersect(r, s):
    """Axis-aligned rectangle intersection test."""
    rx, ry, rw, rh = r
    sx, sy, sw, sh = s
    if ry + rh < sy or sy + sh < ry:
        return False
    if rx + rw < sx or sx + sw < rx:
        return False
    return True


def is_tile_all_nodata(img_path, x, y, w, h, nodata=None):
    """True when the window holds only nodata/zero pixels."""
    arr = geotiff.read(img_path, window=(x, y, w, h), boundless=True,
                       fill_value=0)
    if np.all(arr == 0):
        return True
    if nodata is not None and np.all(arr == nodata):
        return True
    return False


def is_this_tile_useful(cfg: Config, x, y, w, h, images_sizes):
    """Tile culling: data present in the reference image AND the footprint
    visible in at least one secondary image AND a non-empty mask."""
    ref = cfg.images[0]
    nodata = geotiff.read_profile(ref.img).nodata
    if is_tile_all_nodata(ref.img, x, y, w, h, nodata):
        return False, None

    rpc = ref.rpcm
    alt_kwargs = dict(exogenous_dem=cfg.exogenous_dem,
                      exogenous_dem_geoid_mode=cfg.exogenous_dem_geoid_mode,
                      use_srtm=cfg.use_srtm,
                      rpc_alt_range_scale_factor=cfg.rpc_alt_range_scale_factor)
    for img, size in zip(cfg.images[1:], images_sizes[1:]):
        coords = rpc_geom.corresponding_roi(rpc, img.rpcm, x, y, w, h,
                                            **alt_kwargs)
        if rectangles_intersect(coords, (0, 0, size[1], size[0])):
            break
    else:
        return False, None

    mask = masking.image_tile_mask(x, y, w, h, ref.roi, ref.cld, ref.wat,
                                   images_sizes[0], cfg.border_margin)
    if not mask.any():
        return False, None
    return True, mask


def tiles_full_info(cfg: Config, tw, th, tiles_txt, create_masks=False,
                    runner=None):
    """Enumerate useful tiles, create their directories, dump per-tile
    configs and masks."""
    rx, ry = cfg.roi['x'], cfg.roi['y']
    rw, rh = cfg.roi['w'], cfg.roi['h']
    tiles_coords, neighborhood_coords_dict = compute_tiles_coordinates(
        rx, ry, rw, rh, tw, th)

    tiles = []
    if create_masks or not os.path.exists(tiles_txt):
        images_sizes = []
        for img in cfg.images:
            prof = geotiff.read_profile(img.img)
            images_sizes.append((prof.height, prof.width))

        if runner is not None:
            usefulness = runner.map(
                lambda c: is_this_tile_useful(cfg, *c, images_sizes),
                tiles_coords)
        else:
            usefulness = [is_this_tile_useful(cfg, *c, images_sizes)
                          for c in tiles_coords]

        discarded = set(c for c, (ok, _) in zip(tiles_coords, usefulness)
                        if not ok)
        for k, v in neighborhood_coords_dict.items():
            neighborhood_coords_dict[k] = list(set(v) - discarded)

        for coords, (ok, mask) in zip(tiles_coords, usefulness):
            if not ok:
                continue
            tile = create_tile(cfg, coords, neighborhood_coords_dict)
            tiles.append(tile)
            os.makedirs(tile['dir'], exist_ok=True)
            for i in range(1, len(cfg.images)):
                os.makedirs(os.path.join(tile['dir'], f'pair_{i}'),
                            exist_ok=True)
            x, y, w, h = coords
            tile_cfg = cfg.replace(
                roi={'x': x, 'y': y, 'w': w, 'h': h},
                full_img=False, max_processes=1,
                neighborhood_dirs=tile['neighborhood_dirs'],
                out_dir='../../..')
            tile_cfg.dump_json(os.path.join(cfg.out_dir, tile['json']))
            geotiff.write_png(os.path.join(tile['dir'], 'mask.png'),
                              mask.astype(np.uint8))
    else:
        if len(tiles_coords) == 1:
            tiles.append(create_tile(cfg, tiles_coords[0],
                                     neighborhood_coords_dict))
        else:
            with open(tiles_txt) as f:
                for line in f:
                    p = os.path.join(cfg.out_dir, line.strip())
                    with open(p) as fc:
                        roi = json.load(fc)['roi']
                    coords = (roi['x'], roi['y'], roi['w'], roi['h'])
                    tiles.append(create_tile(cfg, coords,
                                             neighborhood_coords_dict))
    return tiles
