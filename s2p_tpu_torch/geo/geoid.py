"""EGM96 geoid undulation lookup (the port's own copy of
``s2p_tpu.geo.geoid``, numpy only).

The reference s2p obtains geoid offsets through PROJ's ``us_nga_egm96_15``
grid (its ``geographiclib.py``).  No PROJ data ships with the package, so
the geoid is pluggable:

  * if the environment variable ``S2P_TPU_GEOID_GRID`` points to a PGM/GTX
    grid file, it is loaded and bilinearly interpolated,
  * otherwise the standard PROJ data directories are searched for
    ``egm96_15.gtx`` / ``us_nga_egm96_15.gtx``,
  * otherwise a built-in coarse EGM96 approximation (10-degree grid, ~1-2 m
    accuracy) is used.  Callers whose OUTPUT heights depend on the geoid
    (``out_geoid`` / compound-CRS vertical datums) pass ``strict=True``,
    which turns the coarse fallback into a hard error unless
    ``S2P_TPU_ALLOW_COARSE_GEOID=1`` explicitly overrides; search-range
    estimation keeps the warn-only behavior (a ~2 m bias there only
    widens a disparity interval).
"""

from __future__ import annotations

import os
import warnings

import numpy as np

_grid = None
_grid_loaded = False
_warned = False

# standard locations of the PROJ EGM96 15-minute grid
_DEFAULT_GRID_PATHS = (
    '/usr/share/proj/egm96_15.gtx',
    '/usr/share/proj/us_nga_egm96_15.gtx',
    '/usr/local/share/proj/egm96_15.gtx',
)

# Very coarse EGM96 undulation (meters above the WGS84 ellipsoid) sampled on
# a 10-degree grid: lat from 90 to -90 (19 rows), lon from 0 to 350 (36 cols).
# Values rounded to the meter; adequate as a documented fallback only.
_COARSE_LAT = np.linspace(90, -90, 19)
_COARSE_LON = np.arange(0, 360, 10.0)
_COARSE = np.array([
  [13]*36,
  [5, 5, 5, 6, 7, 9, 11, 13, 14, 15, 15, 14, 13, 12, 10, 9, 8, 8, 8, 8, 8, 8, 8, 8, 7, 6, 5, 4, 3, 3, 3, 3, 3, 4, 4, 5],
  [3, 3, 3, 5, 7, 9, 12, 15, 17, 18, 18, 17, 15, 12, 9, 6, 4, 3, 2, 2, 2, 3, 4, 4, 4, 3, 2, 0, -1, -2, -2, -1, 0, 1, 2, 3],
  [2, 2, 2, 4, 7, 11, 15, 19, 21, 22, 21, 18, 13, 8, 3, 0, -2, -3, -3, -2, -1, 0, 1, 2, 2, 1, -1, -3, -5, -6, -6, -4, -2, 0, 1, 2],
  [0, 0, 1, 3, 7, 13, 19, 24, 27, 27, 24, 18, 11, 4, -2, -6, -8, -8, -7, -5, -3, -1, 0, 1, 1, 0, -3, -6, -9, -11, -11, -9, -6, -3, -1, 0],
  [-2, -2, -1, 2, 8, 15, 23, 30, 33, 32, 27, 19, 9, 0, -7, -12, -14, -13, -11, -8, -5, -2, 0, 1, 1, -1, -4, -9, -13, -16, -16, -13, -9, -5, -3, -2],
  [-3, -3, -1, 3, 10, 19, 29, 37, 40, 38, 31, 20, 8, -3, -12, -18, -20, -19, -15, -11, -6, -2, 0, 2, 2, 0, -5, -11, -17, -21, -21, -18, -13, -8, -5, -3],
  [-2, -2, 0, 5, 13, 24, 35, 44, 47, 43, 34, 21, 6, -7, -17, -24, -26, -24, -19, -13, -7, -2, 1, 3, 3, 0, -6, -13, -20, -25, -26, -22, -16, -10, -6, -3],
  [0, 1, 3, 9, 18, 30, 42, 51, 53, 48, 36, 21, 4, -11, -23, -30, -32, -29, -23, -15, -8, -2, 2, 5, 5, 2, -5, -14, -23, -29, -30, -26, -19, -12, -6, -2],
  [5, 6, 9, 15, 25, 37, 49, 57, 58, 51, 37, 19, 1, -16, -29, -36, -38, -34, -26, -17, -9, -2, 3, 6, 7, 4, -4, -14, -24, -31, -33, -29, -22, -14, -7, -2],
  [10, 12, 15, 22, 32, 44, 55, 62, 61, 52, 36, 16, -4, -22, -35, -43, -44, -39, -30, -20, -10, -2, 4, 8, 9, 6, -2, -13, -24, -33, -35, -32, -25, -16, -8, -2],
  [13, 16, 20, 27, 38, 49, 59, 64, 62, 51, 33, 12, -9, -28, -42, -49, -50, -44, -34, -22, -11, -2, 5, 10, 11, 8, 0, -11, -23, -32, -36, -34, -27, -18, -9, -2],
  [13, 17, 22, 30, 41, 52, 61, 65, 60, 48, 29, 7, -15, -34, -48, -55, -55, -48, -37, -24, -12, -1, 6, 12, 13, 10, 2, -9, -21, -31, -36, -35, -28, -19, -10, -2],
  [10, 14, 20, 29, 40, 51, 60, 62, 56, 43, 23, 0, -21, -40, -53, -59, -58, -51, -39, -25, -12, -1, 7, 13, 15, 12, 4, -7, -19, -29, -35, -34, -29, -20, -11, -3],
  [5, 9, 15, 25, 36, 47, 55, 57, 50, 36, 16, -6, -27, -45, -57, -62, -60, -52, -40, -26, -12, 0, 8, 14, 16, 13, 6, -5, -16, -27, -33, -33, -28, -21, -12, -4],
  [-1, 3, 9, 18, 29, 40, 48, 49, 42, 28, 8, -13, -33, -49, -60, -64, -61, -53, -40, -26, -12, 1, 9, 15, 17, 14, 7, -3, -14, -24, -31, -32, -28, -21, -13, -6],
  [-6, -3, 2, 11, 21, 31, 38, 39, 32, 18, -1, -21, -39, -53, -62, -65, -61, -52, -40, -26, -12, 1, 10, 16, 17, 15, 8, -2, -12, -22, -28, -30, -27, -21, -14, -9],
  [-10, -8, -4, 3, 12, 21, 27, 28, 21, 8, -9, -27, -43, -55, -62, -63, -59, -50, -38, -25, -12, 0, 9, 14, 16, 13, 7, -2, -11, -20, -26, -28, -26, -21, -15, -12],
  [-30]*36,
], dtype=np.float64)


def _load_grid():
    global _grid, _grid_loaded
    if _grid_loaded:
        return _grid
    paths = [os.environ.get('S2P_TPU_GEOID_GRID')] + list(_DEFAULT_GRID_PATHS)
    for path in paths:
        if path and os.path.exists(path):
            _grid = _read_pgm_or_gtx(path)
            break
    _grid_loaded = True
    return _grid


def _read_pgm_or_gtx(path):
    """Load a geoid grid: PROJ .pgm (world PGM with offset/scale comments)
    or NOAA .gtx format.  Returns (lats_desc, lons, values)."""
    if path.endswith('.gtx'):
        # GTX header: 4 big-endian float64 (lat0, lon0, dlat, dlon) at
        # bytes 0-32, then 2 big-endian int32 (nrows, ncols) at bytes 32-40;
        # row 0 is the SOUTH edge (lat ascending)
        with open(path, 'rb') as f:
            hdr = np.frombuffer(f.read(32), dtype='>f8', count=4)
            lat0, lon0, dlat, dlon = hdr
            nrows, ncols = np.frombuffer(f.read(8), dtype='>i4', count=2)
            vals = np.frombuffer(f.read(nrows * ncols * 4), dtype='>f4')
        vals = vals.reshape(nrows, ncols).astype(np.float64)
        lats = lat0 + np.arange(nrows) * dlat       # ascending
        lons = lon0 + np.arange(ncols) * dlon
        return lats[::-1], lons, vals[::-1]          # store lat-descending
    # PGM (P5) with PROJ header comments
    with open(path, 'rb') as f:
        data = f.read()
    if not data.startswith(b'P5'):
        raise ValueError(f'unsupported geoid grid format: {path}')
    # parse header tokens and comments
    offset, scale = -108.0, 0.003  # PROJ egm96 defaults
    pos = 2
    fields = []
    while len(fields) < 3:
        eol = data.index(b'\n', pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.strip().startswith(b'#'):
            if b'Offset' in line:
                offset = float(line.split()[-1])
            if b'Scale' in line:
                scale = float(line.split()[-1])
            continue
        fields += line.split()
    ncols, nrows, maxval = int(fields[0]), int(fields[1]), int(fields[2])
    dt = '>u2' if maxval > 255 else 'u1'
    vals = np.frombuffer(data[pos:pos + nrows * ncols * np.dtype(dt).itemsize], dtype=dt)
    vals = vals.reshape(nrows, ncols).astype(np.float64) * scale + offset
    lats = np.linspace(90, -90, nrows)
    lons = np.linspace(0, 360, ncols, endpoint=False)
    return lats, lons, vals


def geoid_above_ellipsoid(lat, lon, strict=False):
    """EGM96 undulation N such that h_ellipsoid = h_geoid + N.

    Args:
        strict: when True (output heights depend on the result), the coarse
            built-in fallback is a hard error instead of a warning, unless
            ``S2P_TPU_ALLOW_COARSE_GEOID=1``.
    """
    global _warned
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.mod(np.asarray(lon, dtype=np.float64), 360.0)

    grid = _load_grid()
    if grid is not None:
        lats, lons, vals = grid
    else:
        if strict and os.environ.get('S2P_TPU_ALLOW_COARSE_GEOID') != '1':
            raise RuntimeError(
                'geoid-referenced output heights requested but no EGM96 grid '
                'is available (searched S2P_TPU_GEOID_GRID and {}); the '
                'built-in fallback has ~2 m error. Install a PROJ '
                'egm96_15.gtx grid or set S2P_TPU_ALLOW_COARSE_GEOID=1 to '
                'accept the bias.'.format(', '.join(_DEFAULT_GRID_PATHS)))
        if not _warned:
            warnings.warn('no EGM96 grid configured (set S2P_TPU_GEOID_GRID); '
                          'using coarse built-in approximation (~2 m accuracy)')
            _warned = True
        lats, lons, vals = _COARSE_LAT, _COARSE_LON, _COARSE

    # bilinear interpolation on the (lat-descending, lon-periodic) grid;
    # NaN coordinates (invalid triangulated points) pass through as NaN
    # without tripping integer-cast warnings
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    bad = ~(np.isfinite(lat) & np.isfinite(lon))
    nrows, ncols = vals.shape
    dlat = lats[0] - lats[1]
    dlon = lons[1] - lons[0]
    fi = np.where(bad, 0.0, (lats[0] - lat) / dlat)
    fj = np.where(bad, 0.0, (lon - lons[0]) / dlon)
    i0 = np.clip(np.floor(fi).astype(int), 0, nrows - 2)
    j0 = np.floor(fj).astype(int) % ncols
    j1 = (j0 + 1) % ncols
    wi = np.clip(fi - i0, 0.0, 1.0)
    wj = fj - np.floor(fj)
    v00 = vals[i0, j0]
    v01 = vals[i0, j1]
    v10 = vals[i0 + 1, j0]
    v11 = vals[i0 + 1, j1]
    out = (v00 * (1 - wi) * (1 - wj) + v01 * (1 - wi) * wj
           + v10 * wi * (1 - wj) + v11 * wi * wj)
    return np.where(bad, np.nan, out)
