"""SRTM height lookup from a local tile directory (a numpy copy of
``s2p_tpu/core/srtm.py``).

The reference downloads SRTM tiles at runtime through the ``srtm4`` package
(s2p ``rpc_utils.py``:191).  This runtime is hermetic (no
network), so tiles come from a local directory of standard ``.hgt`` files
(S2P_TPU_SRTM_DIR), named like ``N21E055.hgt`` / ``S22E055.hgt``:
big-endian int16 grids of 1201x1201 (SRTM3) or 3601x3601 (SRTM1) samples,
row 0 at the NORTH edge, nodata -32768.

Heights are EGM96-geoid-referenced, exactly like srtm4's output; callers
that need ellipsoid heights add the geoid undulation
(:func:`s2p_tpu_torch.geo.crs.geoid_to_ellipsoid`), mirroring the reference's
``rpc_utils.altitude_range`` flow.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

NODATA = -32768


def _tile_name(lat_floor: int, lon_floor: int) -> str:
    ns = 'N' if lat_floor >= 0 else 'S'
    ew = 'E' if lon_floor >= 0 else 'W'
    return f'{ns}{abs(lat_floor):02d}{ew}{abs(lon_floor):03d}.hgt'


@functools.lru_cache(maxsize=16)
def _load_tile(path):
    n = os.path.getsize(path) // 2
    size = int(math.isqrt(n))
    if size * size != n:
        raise ValueError(f'not a square .hgt grid: {path}')
    return np.fromfile(path, dtype='>i2').reshape(size, size)


def lookup(directory, lons, lats):
    """Bilinear SRTM heights at (lons, lats); NaN where no tile/nodata."""
    lons = np.atleast_1d(np.asarray(lons, dtype=np.float64))
    lats = np.atleast_1d(np.asarray(lats, dtype=np.float64))
    out = np.full(lons.shape, np.nan)

    lon_f = np.floor(lons).astype(int)
    lat_f = np.floor(lats).astype(int)
    for key in set(zip(lat_f.ravel(), lon_f.ravel())):
        la, lo = int(key[0]), int(key[1])
        path = os.path.join(directory, _tile_name(la, lo))
        if not os.path.exists(path):
            continue
        grid = _load_tile(path)
        size = grid.shape[0]
        sel = (lat_f == la) & (lon_f == lo)
        # row 0 = north edge (lat la+1); (size-1) samples per degree
        fx = (lons[sel] - lo) * (size - 1)
        fy = (la + 1 - lats[sel]) * (size - 1)
        x0 = np.clip(np.floor(fx).astype(int), 0, size - 2)
        y0 = np.clip(np.floor(fy).astype(int), 0, size - 2)
        wx = fx - x0
        wy = fy - y0
        v00 = grid[y0, x0].astype(np.float64)
        v01 = grid[y0, x0 + 1].astype(np.float64)
        v10 = grid[y0 + 1, x0].astype(np.float64)
        v11 = grid[y0 + 1, x0 + 1].astype(np.float64)
        v = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
             + v10 * wy * (1 - wx) + v11 * wy * wx)
        bad = (np.abs(v00 - NODATA) < 1) | (np.abs(v01 - NODATA) < 1) \
            | (np.abs(v10 - NODATA) < 1) | (np.abs(v11 - NODATA) < 1)
        v[bad] = np.nan
        out[sel] = v
    return out
