"""Coordinate reference systems without PROJ (the port's own copy of
``s2p_tpu.geo.crs``, numpy only).

The reference s2p delegates all CRS work to pyproj (its
``geographiclib.py``); neither package depends on PROJ, so the small set
of CRS conversions the pipeline actually needs is implemented here:

  * WGS84 geographic (EPSG 4326 / 4979),
  * UTM zones (EPSG 326xx north / 327xx south) via the Karney-Krueger
    transverse Mercator series (6th order in the third flattening:
    sub-millimeter accuracy within the zone),
  * WGS84 geocentric cartesian (EPSG 4978),
  * compound "epsg:XXXX+5773" (EGM96 geoid heights), handled through
    :mod:`s2p_tpu_torch.geo.geoid`.

All transforms are vectorized numpy float64 (host side).  They are cheap
(used on point sets and small grids, never per-pixel on device).
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid
A = 6378137.0
F = 1.0 / 298.257223563
E2 = F * (2 - F)
_N = F / (2.0 - F)  # third flattening

# Rectifying radius (Krueger series in n)
_A_RECT = A / (1 + _N) * (1 + _N**2 / 4 + _N**4 / 64 + _N**6 / 256)

# Forward series coefficients alpha_j (Karney 2011, eq. 35)
_ALPHA = np.array([
    _N / 2 - 2 * _N**2 / 3 + 5 * _N**3 / 16 + 41 * _N**4 / 180
    - 127 * _N**5 / 288 + 7891 * _N**6 / 37800,
    13 * _N**2 / 48 - 3 * _N**3 / 5 + 557 * _N**4 / 1440 + 281 * _N**5 / 630
    - 1983433 * _N**6 / 1935360,
    61 * _N**3 / 240 - 103 * _N**4 / 140 + 15061 * _N**5 / 26880
    + 167603 * _N**6 / 181440,
    49561 * _N**4 / 161280 - 179 * _N**5 / 168 + 6601661 * _N**6 / 7257600,
    34729 * _N**5 / 80640 - 3418889 * _N**6 / 1995840,
    212378941 * _N**6 / 319334400,
])

# Inverse series coefficients beta_j (Karney 2011, eq. 36)
_BETA = np.array([
    _N / 2 - 2 * _N**2 / 3 + 37 * _N**3 / 96 - _N**4 / 360
    - 81 * _N**5 / 512 + 96199 * _N**6 / 604800,
    _N**2 / 48 + _N**3 / 15 - 437 * _N**4 / 1440 + 46 * _N**5 / 105
    - 1118711 * _N**6 / 3870720,
    17 * _N**3 / 480 - 37 * _N**4 / 840 - 209 * _N**5 / 4480
    + 5569 * _N**6 / 90720,
    4397 * _N**4 / 161280 - 11 * _N**5 / 504 - 830251 * _N**6 / 7257600,
    4583 * _N**5 / 161280 - 108847 * _N**6 / 3991680,
    20648693 * _N**6 / 638668800,
])

_K0 = 0.9996
_E0 = 500000.0


def utm_forward(lon, lat, zone, south):
    """(lon, lat) degrees -> (easting, northing) meters in the given zone."""
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    lam0 = np.deg2rad(zone * 6.0 - 183.0)
    lam = np.deg2rad(lon) - lam0
    phi = np.deg2rad(lat)

    s = np.sin(phi)
    e = np.sqrt(E2)
    t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))

    # complex Karney series: xi + i*eta = zeta + sum_j alpha_j sin(2j zeta)
    # with zeta = xi' + i*eta'; sin(2j zeta) via powers of exp(2i zeta)
    # (one complex exp instead of 24 transcendental arrays)
    # NaN inputs (invalid points) propagate without divide warnings
    zeta = np.where(np.isfinite(xi_p) & np.isfinite(eta_p),
                    xi_p + 1j * eta_p, 0.0 + 0.0j)
    nanmask = ~(np.isfinite(xi_p) & np.isfinite(eta_p))
    e1 = np.exp(2j * zeta)
    i1 = 1.0 / e1
    ej, ij_ = e1, i1
    corr = _ALPHA[0] * ((ej - ij_) / 2j)
    for j_ in range(1, 6):
        ej = ej * e1
        ij_ = ij_ * i1
        corr = corr + _ALPHA[j_] * ((ej - ij_) / 2j)
    z = zeta + corr
    xi = np.where(nanmask, np.nan, z.real)
    eta = np.where(nanmask, np.nan, z.imag)

    E = _E0 + _K0 * _A_RECT * eta
    Nn = _K0 * _A_RECT * xi
    if south:
        Nn = Nn + 10000000.0
    return E, Nn


def utm_inverse(E, Nn, zone, south):
    """(easting, northing) -> (lon, lat) degrees."""
    E = np.asarray(E, dtype=np.float64)
    Nn = np.asarray(Nn, dtype=np.float64)
    if south:
        Nn = Nn - 10000000.0
    xi = Nn / (_K0 * _A_RECT)
    eta = (E - _E0) / (_K0 * _A_RECT)

    # complex series (see utm_forward): xi' + i*eta' = z - sum beta_j sin(2jz)
    z = xi + 1j * eta
    e1 = np.exp(2j * z)
    i1 = 1.0 / e1
    ej, ij_ = e1, i1
    corr = _BETA[0] * ((ej - ij_) / 2j)
    for j_ in range(1, 6):
        ej = ej * e1
        ij_ = ij_ * i1
        corr = corr + _BETA[j_] * ((ej - ij_) / 2j)
    zp = z - corr
    xi_p = zp.real
    eta_p = zp.imag

    # tan of the conformal latitude
    taup = np.sin(xi_p) / np.hypot(np.sinh(eta_p), np.cos(xi_p))
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))

    # invert the conformal latitude by Newton on tau'(tau)
    e = np.sqrt(E2)
    e2m = 1.0 - E2
    tau = taup / e2m
    for _ in range(6):
        tau1 = np.hypot(1.0, tau)
        sig = np.sinh(e * np.arctanh(e * tau / tau1))
        taupa = np.hypot(1.0, sig) * tau - sig * tau1
        tau = tau + (taup - taupa) * (1.0 + e2m * tau * tau) \
            / (e2m * tau1 * np.hypot(1.0, taupa))
    phi = np.arctan(tau)

    lam0 = np.deg2rad(zone * 6.0 - 183.0)
    return np.rad2deg(lam + lam0), np.rad2deg(phi)


def lonlat_to_geocentric(lon, lat, alt):
    """WGS84 (lon, lat, alt) -> ECEF (x, y, z) meters (EPSG 4978)."""
    lon = np.deg2rad(np.asarray(lon, dtype=np.float64))
    lat = np.deg2rad(np.asarray(lat, dtype=np.float64))
    alt = np.asarray(alt, dtype=np.float64)
    s, c = np.sin(lat), np.cos(lat)
    Np = A / np.sqrt(1 - E2 * s * s)
    x = (Np + alt) * c * np.cos(lon)
    y = (Np + alt) * c * np.sin(lon)
    z = (Np * (1 - E2) + alt) * s
    return x, y, z


def compute_utm_zone(lon, lat):
    """UTM zone string for a point, e.g. '40S' (geographiclib.py:40-56)."""
    zone = int((lon + 180) // 6 + 1)
    return '{}{}'.format(zone, 'N' if lat >= 0 else 'S')


def epsg_code_from_utm_zone(utm_zone):
    """'40S' -> 32740 (geographiclib.py:59-81)."""
    zone_number = int(utm_zone[:-1])
    hemisphere = utm_zone[-1]
    if hemisphere not in ('N', 'S'):
        raise ValueError(f'unknown hemisphere {hemisphere} in utm_zone {utm_zone}')
    return (32600 if hemisphere == 'N' else 32700) + zone_number


class CRS:
    """A minimal CRS object: EPSG code + optional vertical datum.

    Accepts ints, 'epsg:32740', 'epsg:32740+5773', 'EPSG:4326', or another
    CRS.  Only the CRS kinds used by the pipeline are supported.
    """

    def __init__(self, spec):
        if isinstance(spec, CRS):
            self.epsg, self.vertical = spec.epsg, spec.vertical
        elif isinstance(spec, (int, np.integer)):
            self.epsg, self.vertical = int(spec), None
        elif isinstance(spec, str):
            s = spec.strip().lower()
            if s.startswith('epsg:'):
                s = s[5:]
            if '+' in s:
                base, vert = s.split('+', 1)
                self.epsg, self.vertical = int(base), int(vert)
            else:
                self.epsg, self.vertical = int(s), None
        elif isinstance(spec, dict) and 'init' in spec:
            self.epsg = int(str(spec['init']).split(':')[-1])
            self.vertical = None
        else:
            raise ValueError(f'unsupported CRS spec: {spec!r}')

    @classmethod
    def from_epsg(cls, code):
        return cls(int(code))

    # ------------------------------------------------------------------ #
    @property
    def is_projected(self):
        return 32601 <= self.epsg <= 32760 or self.epsg == 4978

    @property
    def is_geographic(self):
        return self.epsg in (4326, 4979)

    @property
    def utm_zone(self):
        if 32601 <= self.epsg <= 32660:
            return self.epsg - 32600, False
        if 32701 <= self.epsg <= 32760:
            return self.epsg - 32700, True
        return None

    @property
    def name(self):
        z = self.utm_zone
        if z:
            return 'WGS 84 / UTM zone {}{}'.format(z[0], 'S' if z[1] else 'N')
        return {4326: 'WGS 84', 4979: 'WGS 84', 4978: 'WGS 84 / Geocentric'}.get(
            self.epsg, f'EPSG:{self.epsg}')

    def to_epsg(self):
        return self.epsg

    def __eq__(self, other):
        try:
            other = CRS(other)
        except Exception:
            return NotImplemented
        # 4326 vs 4979: same horizontal datum; treat as equal for pipeline use
        a = 4326 if self.epsg == 4979 else self.epsg
        b = 4326 if other.epsg == 4979 else other.epsg
        return a == b and self.vertical == other.vertical

    def __hash__(self):
        return hash((self.epsg, self.vertical))

    def __repr__(self):
        v = f'+{self.vertical}' if self.vertical else ''
        return f'CRS(epsg:{self.epsg}{v})'

    def __str__(self):
        v = f'+{self.vertical}' if self.vertical else ''
        return f'epsg:{self.epsg}{v}'


def transform(x, y, in_crs, out_crs, z=None):
    """Convert coordinates between two CRSs (geographiclib.py:122-143).

    x, y are lon, lat for geographic CRSs (always_xy convention).
    """
    in_crs, out_crs = CRS(in_crs), CRS(out_crs)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if z is not None:
        z = np.asarray(z, dtype=np.float64)

    # to lon/lat/ellipsoid-height
    if in_crs.is_geographic:
        lon, lat = x, y
    elif in_crs.utm_zone:
        zone, south = in_crs.utm_zone
        lon, lat = utm_inverse(x, y, zone, south)
    else:
        raise NotImplementedError(f'transform from {in_crs} not supported')
    if z is not None and in_crs.vertical == 5773:
        from . import geoid
        z = z + geoid.geoid_above_ellipsoid(lat, lon, strict=True)

    # from lon/lat/ellipsoid-height
    if out_crs.epsg == 4978:
        if z is None:
            raise ValueError('z is required for geocentric output')
        return lonlat_to_geocentric(lon, lat, z)
    if out_crs.is_geographic:
        ox, oy = lon, lat
    elif out_crs.utm_zone:
        zone, south = out_crs.utm_zone
        ox, oy = utm_forward(lon, lat, zone, south)
    else:
        raise NotImplementedError(f'transform to {out_crs} not supported')
    if z is None:
        return ox, oy
    if out_crs.vertical == 5773:
        from . import geoid
        # output heights depend on the geoid here: the coarse fallback is a
        # hard error (geoid.py) unless explicitly overridden
        z = z - geoid.geoid_above_ellipsoid(lat, lon, strict=True)
    return ox, oy, z


def geoid_to_ellipsoid(lat, lon, z):
    """EGM96 geoid height -> WGS84 ellipsoid height (geographiclib.py:16-37)."""
    from . import geoid
    return z + geoid.geoid_above_ellipsoid(lat, lon)
