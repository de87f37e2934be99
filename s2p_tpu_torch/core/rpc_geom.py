"""RPC-space geometry utilities: ROIs, altitude ranges, virtual matches.

A numpy copy of ``s2p_tpu/core/rpc_geom.py`` on the port's RPC model, CRS
and GeoTIFF reader: functional parity with the reference s2p
``rpc_utils.py`` (cited per function), with the global ``cfg`` dict
replaced by explicit arguments.  Everything here is host-side float64 on
small point sets.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..geo import crs as crsmod
from ..geo import geotiff


def find_corresponding_point(model_a, model_b, x, y, z):
    """Map image-a pixels (x, y) at altitude z into image b.

    Parity: reference rpc_utils.py:20-38.
    """
    lon, lat = model_a.localization(x, y, z)
    xp, yp = model_b.projection(lon, lat, z)
    return xp, yp, z


def geodesic_bounding_box(rpc, x, y, w, h):
    """(lon_min, lon_max, lat_min, lat_max) seen by an image ROI.

    Parity: reference rpc_utils.py:42-74 (corners at coarse altitude extrema).
    """
    m = rpc.alt_offset - rpc.alt_scale
    M = rpc.alt_offset + rpc.alt_scale
    cols = np.array([x, x, x, x, x + w, x + w, x + w, x + w], dtype=np.float64)
    rows = np.array([y, y, y + h, y + h, y, y, y + h, y + h], dtype=np.float64)
    alts = np.array([m, M, m, M, m, M, m, M], dtype=np.float64)
    lon, lat = rpc.localization(cols, rows, alts)
    return np.min(lon), np.max(lon), np.min(lat), np.max(lat)


def altitude_range_coarse(rpc, scale_factor=1.0):
    """Coarse altitude validity range from the RPC normalization.

    Parity: reference rpc_utils.py:76-90.
    """
    return (rpc.alt_offset - scale_factor * rpc.alt_scale,
            rpc.alt_offset + scale_factor * rpc.alt_scale)


def min_max_heights_from_bbx(im, lon_m, lon_M, lat_m, lat_M, rpc,
                             exogenous_dem_geoid_mode=True,
                             rpc_alt_range_scale_factor=1.0):
    """Height range of a DEM raster over a geodetic bounding box.

    Parity: reference rpc_utils.py:93-151.
    """
    prof = geotiff.read_profile(im)
    dem_crs = prof.crs or crsmod.CRS(4326)
    xs, ys = crsmod.transform([lon_m, lon_M], [lat_m, lat_M], 4326, dem_crs)

    a, b, c, d, e, f = prof.transform
    # invert the (axis-aligned) geo transform to pixels
    px = (np.asarray(xs) - c) / a
    py = (np.asarray(ys) - f) / e

    px_min, px_max = int(np.amin(px)), int(np.amax(px)) + 1
    py_min, py_max = int(np.amin(py)), int(np.amax(py)) + 1
    x0 = np.clip(px_min, 0, prof.width - 1)
    y0 = np.clip(py_min, 0, prof.height - 1)
    w = np.clip(px_max - px_min + 1 - (x0 - px_min), 0, prof.width - 1 - x0)
    h = np.clip(py_max - py_min + 1 - (y0 - py_min), 0, prof.height - 1 - y0)

    if w != 0 and h != 0:
        arr = geotiff.read(im, window=(x0, y0, w, h)).astype(float)
        arr[arr == -32768] = np.nan
        if prof.nodata is not None and not np.isnan(prof.nodata):
            arr[arr == prof.nodata] = np.nan
        hmin, hmax = np.nanmin(arr), np.nanmax(arr)
        if exogenous_dem_geoid_mode:
            off = crsmod.geoid_to_ellipsoid((lat_m + lat_M) / 2, (lon_m + lon_M) / 2, 0)
            hmin += off
            hmax += off
        return hmin, hmax
    warnings.warn('min_max_heights_from_bbx: access window out of range, '
                  'returning coarse range from rpc')
    return altitude_range_coarse(rpc, rpc_alt_range_scale_factor)


def altitude_range(rpc, x, y, w, h, margin_top=0, margin_bottom=0,
                   exogenous_dem=None, exogenous_dem_geoid_mode=True,
                   use_srtm=False, srtm=None, rpc_alt_range_scale_factor=1.0):
    """Altitude range of the world points imaged in an ROI.

    Uses the exogenous DEM when given, an SRTM provider when configured,
    otherwise the coarse RPC range (margins apply only in the DEM branches).
    Parity: reference rpc_utils.py:153-199.
    """
    lon_m, lon_M, lat_m, lat_M = geodesic_bounding_box(rpc, x, y, w, h)
    if exogenous_dem is not None:
        h_m, h_M = min_max_heights_from_bbx(
            exogenous_dem, lon_m, lon_M, lat_m, lat_M, rpc,
            exogenous_dem_geoid_mode, rpc_alt_range_scale_factor)
        return h_m + margin_bottom, h_M + margin_top
    if use_srtm:
        provider = srtm or _srtm_provider()
        if provider is not None:
            s = 0.001 / 12  # SRTM90 spacing
            lons, lats = np.meshgrid(np.arange(lon_m, lon_M, s),
                                     np.arange(lat_m, lat_M, s))
            alts = provider(lons.ravel(), lats.ravel())
            return float(np.min(alts)) + margin_bottom, float(np.max(alts)) + margin_top
        warnings.warn('use_srtm requested but no SRTM provider is available; '
                      'falling back to the coarse RPC altitude range')
    return altitude_range_coarse(rpc, rpc_alt_range_scale_factor)


def _srtm_provider():
    """Return an srtm lookup f(lons, lats)->alts if one is available.

    The hermetic runtime has no network access, so SRTM tiles can only come
    from a local directory pointed at by ``S2P_TPU_SRTM_DIR`` (hgt files).
    """
    import os
    d = os.environ.get('S2P_TPU_SRTM_DIR')
    if not d or not os.path.isdir(d):
        return None
    from . import srtm
    return lambda lons, lats: srtm.lookup(d, lons, lats)


def utm_zone(rpc, x, y, w, h):
    """UTM zone of the ROI center. Parity: reference rpc_utils.py:201-222."""
    lon, lat = rpc.localization(x + 0.5 * w, y + 0.5 * h, rpc.alt_offset)
    return crsmod.compute_utm_zone(float(lon), float(lat))


def roi_process(rpc, ll_poly, use_srtm=False, exogenous_dem=None,
                exogenous_dem_geoid_mode=True, srtm=None):
    """(lon, lat) polygon -> rectangular image ROI dict.

    Parity: reference rpc_utils.py:224-257.
    """
    if use_srtm and exogenous_dem is not None:
        raise ValueError('use_srtm and exogenous_dem are mutually exclusive')

    ll_poly = np.asarray(ll_poly, dtype=np.float64)
    lon, lat = ll_poly.mean(axis=0)
    if exogenous_dem is not None:
        prof = geotiff.read_profile(exogenous_dem)
        dem_crs = prof.crs or crsmod.CRS(4326)
        xs, ys = crsmod.transform(lon, lat, 4326, dem_crs)
        a, b, c, d, e, f = prof.transform
        px = int((xs - c) / a)
        py = int((ys - f) / e)
        z = float(geotiff.read(exogenous_dem, window=(px, py, 1, 1))[0, 0])
        if exogenous_dem_geoid_mode:
            z = crsmod.geoid_to_ellipsoid(lat, lon, z)
    elif use_srtm:
        provider = srtm or _srtm_provider()
        if provider is None:
            raise RuntimeError('use_srtm requested but no SRTM data available '
                               '(set S2P_TPU_SRTM_DIR)')
        z = float(np.asarray(provider([lon], [lat]))[0])
    else:
        z = rpc.alt_offset

    cols, rows = rpc.projection(ll_poly[:, 0], ll_poly[:, 1], z)
    x, y = cols.min(), rows.min()
    return {'x': x, 'y': y, 'w': cols.max() - x, 'h': rows.max() - y}


def generate_point_mesh(col_range, row_range, alt_range):
    """3D grid of image-space sample points.

    Parity: reference rpc_utils.py:263-291 (same ordering: alt-major,
    then row, then col).
    """
    cols = np.linspace(*col_range)
    rows = np.linspace(*row_range)
    alts = np.linspace(*alt_range)
    A, R, C = np.meshgrid(alts, rows, cols, indexing='ij')
    return C.ravel(), R.ravel(), A.ravel()


def ground_control_points(rpc, x, y, w, h, m, M, n):
    """n^3 GCPs regularly sampled in the ROI x [m, M] altitude range.

    Parity: reference rpc_utils.py:293-318 (including the interior sampling
    offset of half a cell).
    """
    col_range = (x + w / (2 * n), x + (2 * n - 1) / (2 * n) * w, n)
    row_range = (y + h / (2 * n), y + (2 * n - 1) / (2 * n) * h, n)
    col, row, alt = generate_point_mesh(col_range, row_range, (m, M, n))
    lon, lat = rpc.localization(col, row, alt)
    return lon, lat, alt


def corresponding_roi(rpc1, rpc2, x, y, w, h, **alt_kwargs):
    """ROI in image 2 containing the 3D points visible in an image-1 ROI.

    Parity: reference rpc_utils.py:321-353 (rounded bounding box).
    """
    m, M = altitude_range(rpc1, x, y, w, h, 0, 0, **alt_kwargs)
    cols = np.array([x, x, x, x, x + w, x + w, x + w, x + w], dtype=np.float64)
    rows = np.array([y, y, y + h, y + h, y, y, y + h, y + h], dtype=np.float64)
    alts = np.array([m, M, m, M, m, M, m, M], dtype=np.float64)
    xx, yy, _ = find_corresponding_point(rpc1, rpc2, cols, rows, alts)
    x2, y2 = xx.min(), yy.min()
    return tuple(np.round((x2, y2, xx.max() - x2, yy.max() - y2)))


def matches_from_rpc(rpc1, rpc2, x, y, w, h, n, **alt_kwargs):
    """Virtual correspondences from the two RPCs over the ROI.

    Parity: reference rpc_utils.py:356-376 (altitude margins +100/-100).
    """
    m, M = altitude_range(rpc1, x, y, w, h, 100, -100, **alt_kwargs)
    lon, lat, alt = ground_control_points(rpc1, x, y, w, h, m, M, n)
    x1, y1 = rpc1.projection(lon, lat, alt)
    x2, y2 = rpc2.projection(lon, lat, alt)
    return np.vstack([x1, y1, x2, y2]).T


def alt_to_disp(rpc1, rpc2, x, y, alt, H1, H2, A=None):
    """Altitude -> rectified horizontal disparity at image-1 pixels (x, y).

    Parity: reference rpc_utils.py:379-416.
    """
    from ..ops.homography import points_apply_homography
    xx, yy, _ = find_corresponding_point(rpc1, rpc2, x, y, alt)
    p1 = np.vstack([x, y]).T
    p2 = np.vstack([xx, yy]).T
    if A is not None:
        p2 = points_apply_homography(np.linalg.inv(A), p2)
    p1 = points_apply_homography(H1, p1)
    p2 = points_apply_homography(H2, p2)
    return p2[:, 0] - p1[:, 0]


def altitude_range_to_disp_range(m, M, rpc1, rpc2, x, y, w, h, H1, H2, A=None,
                                 margin_top=0, margin_bottom=0):
    """Disparity extrema of the ROI corners over an altitude range.

    Parity: reference rpc_utils.py:445-474.
    """
    a = np.array([x, x, x, x, x + w, x + w, x + w, x + w], dtype=np.float64)
    b = np.array([y, y, y + h, y + h, y, y, y + h, y + h], dtype=np.float64)
    c = np.array([m, M, m, M, m, M, m, M], dtype=np.float64)
    d = alt_to_disp(rpc1, rpc2, a, b, c, H1, H2, A)
    return np.min(d), np.max(d)


def exogenous_disp_range_estimation(rpc1, rpc2, x, y, w, h, H1, H2, A=None,
                                    margin_top=0, margin_bottom=0,
                                    exogenous_dem=None, **alt_kwargs):
    """Disparity range from an exogenous DEM (None if no DEM configured).

    Parity: reference rpc_utils.py:419-442.
    """
    if exogenous_dem is None:
        return None
    m, M = altitude_range(rpc1, x, y, w, h, margin_top, margin_bottom,
                          exogenous_dem=exogenous_dem, **alt_kwargs)
    return altitude_range_to_disp_range(m, M, rpc1, rpc2, x, y, w, h, H1, H2,
                                        A, margin_top, margin_bottom)


def gsd_from_rpc(rpc, z=0):
    """Ground sampling distance (m/px) at the image center.

    Parity: reference rpc_utils.py:477-494.
    """
    c, r = rpc.col_offset, rpc.row_offset
    lon0, lat0 = rpc.localization(c, r, z)
    lon1, lat1 = rpc.localization(c + 1, r, z)
    a = np.array(crsmod.lonlat_to_geocentric(lon0, lat0, z))
    b = np.array(crsmod.lonlat_to_geocentric(lon1, lat1, z))
    return float(np.linalg.norm(b - a))
