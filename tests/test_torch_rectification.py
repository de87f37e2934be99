"""The port's stage-3 geometry (``core/estimation``, ``core/evaluation``,
``core/rpc_geom``, ``core/srtm``, ``core/rectification``) against the JAX
package's on the synthetic cameras of ``test_torch_triangulation.py``.

Both sides are the same float64 numpy code on copies of the same host
RPC model, so every result must be equal, not merely close.  The dense
warp of ``rectify_pair`` is float32 and is held bitwise against the JAX
package's unjitted run (``test_torch_interp.py`` covers the warp alone).
"""

import warnings

import jax
import numpy as np
import pytest

from s2p_tpu.config import Config as JConfig
from s2p_tpu.core import estimation as jest
from s2p_tpu.core import evaluation as jeval
from s2p_tpu.core import pointing as jpoint
from s2p_tpu.core import rectification as jrect
from s2p_tpu.core import rpc_geom as jgeom
from s2p_tpu.core import srtm as jsrtm
from s2p_tpu.geo import crs as jcrs
from s2p_tpu.geo import geotiff as jgeotiff
from s2p_tpu_torch.config import Config as TConfig
from s2p_tpu_torch.core import estimation as test_
from s2p_tpu_torch.core import evaluation as teval
from s2p_tpu_torch.core import pointing as tpoint
from s2p_tpu_torch.core import rectification as trect
from s2p_tpu_torch.core import rpc_geom as tgeom
from s2p_tpu_torch.core import srtm as tsrtm

from test_torch_triangulation import cameras

ROI = (4000, 4800, 300, 250)
POLICIES = ('sift', 'wider_sift_exogenous', 'exogenous',
            'fixed_altitude_range', 'fixed_pixel_range')
H0 = 310.0          # the synthetic ground's altitude (m)


def _equal(a, b):
    """Equal values, nested through tuples and lists."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if a is None or isinstance(a, str):
        assert a == b, (a, b)
        return
    assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True), \
        (a, b)


def sift_matches(rpc1, rpc2, roi, n=60, seed=0, noise=0.05):
    """Matches of ground points at about H0 seen by both cameras, with a
    little pixel noise, in full-image coordinates."""
    rng = np.random.RandomState(seed)
    x, y, w, h = roi
    cols = x + rng.rand(n) * w
    rows = y + rng.rand(n) * h
    alts = H0 + rng.uniform(-20, 20, n)
    lon, lat = rpc1.localization(cols, rows, alts)
    c2, r2 = rpc2.projection(lon, lat, alts)
    m = np.column_stack([cols, rows, c2, r2])
    return m + rng.normal(0, noise, m.shape)


@pytest.fixture(scope='module')
def cams():
    return cameras(same_rows=False)


@pytest.fixture(scope='module')
def dem(tmp_path_factory):
    """A 200 x 240 GeoTIFF DEM in lon/lat over the scene (written by the
    JAX package's writer), heights about H0 with a -32768 hole and its
    own nodata value."""
    rng = np.random.RandomState(4)
    arr = (H0 + rng.uniform(-30, 30, (200, 240))).astype(np.float32)
    arr[50:60, 70:90] = -32768
    arr[120:125, 10:30] = -9999
    path = str(tmp_path_factory.mktemp('dem') / 'dem.tif')
    jgeotiff.write(path, arr, crs=jcrs.CRS(4326),
                   transform=(0.001, 0.0, 55.28, 0.0, -0.001, -20.9),
                   nodata=-9999.0)
    return path


def test_estimation_and_evaluation_equal(cams):
    j1, j2, t1, t2 = cams
    m = jgeom.matches_from_rpc(j1, j2, *ROI, 5)
    _equal(test_.affine_fundamental_matrix(m), jest.affine_fundamental_matrix(m))
    F = jest.affine_fundamental_matrix(m)
    _equal(test_.rectifying_similarities_from_affine_fundamental_matrix(F),
           jest.rectifying_similarities_from_affine_fundamental_matrix(F))
    rng = np.random.RandomState(1)
    P1, P2 = rng.rand(3, 4), rng.rand(3, 4)
    _equal(test_.fundamental_matrix_cameras(P1, P2),
           jest.fundamental_matrix_cameras(P1, P2))
    x = rng.rand(12, 2) * 100
    xx = x @ np.array([[1.01, 0.02], [-0.01, 0.99]]) + 3 + rng.rand(12, 2)
    _equal(test_.affine_transformation(x, xx), jest.affine_transformation(x, xx))
    _equal(test_.affine_transformation(x[:2], xx[:2]), np.eye(3))
    _equal(test_.translation(x, xx), jest.translation(x, xx))
    lines = rng.randn(12, 3)
    lines[3, :2] = 0.0                         # a degenerate line
    _equal(teval.distances_points_to_lines(x, lines),
           jeval.distances_points_to_lines(x, lines))
    for p, l in (((3.0, 4.0, 1.0), (1.0, 2.0, -5.0)),
                 ((3.0, 4.0, 0.0), (1.0, 2.0, -5.0)),
                 ((3.0, 4.0, 2.0), (0.0, 0.0, 1.0))):
        _equal(teval.distance_point_to_line(p, l),
               jeval.distance_point_to_line(p, l))


def test_global_from_local_equal():
    rng = np.random.RandomState(2)
    corr = []
    for k in range(5):
        A = np.eye(3)
        A[:2, 2] = rng.uniform(-2, 2, 2)
        corr.append((A, rng.uniform(0, 1000, 2)))
    for n in (0, 1, 2, 3, 5):
        _equal(tpoint.global_from_local(corr[:n]),
               jpoint.global_from_local(corr[:n]))
    # malformed entries are skipped
    bad = corr[:2] + [(np.eye(2), np.zeros(2)), (np.eye(3), np.zeros(3))]
    _equal(tpoint.global_from_local(bad), jpoint.global_from_local(bad))


def test_rpc_geom_equal(cams):
    j1, j2, t1, t2 = cams
    x, y, w, h = ROI
    _equal(tgeom.geodesic_bounding_box(t1, *ROI),
           jgeom.geodesic_bounding_box(j1, *ROI))
    _equal(tgeom.altitude_range_coarse(t1, 0.5),
           jgeom.altitude_range_coarse(j1, 0.5))
    _equal(tgeom.altitude_range(t1, *ROI, 100, -100),
           jgeom.altitude_range(j1, *ROI, 100, -100))
    _equal(tgeom.utm_zone(t1, *ROI), jgeom.utm_zone(j1, *ROI))
    _equal(tgeom.ground_control_points(t1, *ROI, 200.0, 400.0, 4),
           jgeom.ground_control_points(j1, *ROI, 200.0, 400.0, 4))
    _equal(tgeom.generate_point_mesh((0, 10, 3), (5, 7, 2), (1, 2, 4)),
           jgeom.generate_point_mesh((0, 10, 3), (5, 7, 2), (1, 2, 4)))
    _equal(tgeom.corresponding_roi(t1, t2, *ROI),
           jgeom.corresponding_roi(j1, j2, *ROI))
    _equal(tgeom.matches_from_rpc(t1, t2, *ROI, 5),
           jgeom.matches_from_rpc(j1, j2, *ROI, 5))
    _equal(tgeom.find_corresponding_point(t1, t2, x, y, H0),
           jgeom.find_corresponding_point(j1, j2, x, y, H0))
    H1 = np.array([[1.0, 0.01, -x], [0.0, 1.0, -y], [0.0, 0.0, 1.0]])
    H2 = np.array([[1.0, 0.0, -x + 40], [0.002, 1.0, -y], [0.0, 0.0, 1.0]])
    A = np.array([[1.0, 0.0, 0.7], [0.0, 1.0, -0.4], [0.0, 0.0, 1.0]])
    xs = x + np.arange(5) * 30.0
    for a in (None, A):
        _equal(tgeom.alt_to_disp(t1, t2, xs, xs * 0 + y, 250.0, H1, H2, a),
               jgeom.alt_to_disp(j1, j2, xs, xs * 0 + y, 250.0, H1, H2, a))
        _equal(tgeom.altitude_range_to_disp_range(100.0, 500.0, t1, t2, *ROI,
                                                  H1, H2, a),
               jgeom.altitude_range_to_disp_range(100.0, 500.0, j1, j2, *ROI,
                                                  H1, H2, a))
    assert tgeom.exogenous_disp_range_estimation(t1, t2, *ROI, H1, H2) is None
    _equal(tgeom.gsd_from_rpc(t1), jgeom.gsd_from_rpc(j1))
    poly = [[55.39, -20.99], [55.395, -20.99], [55.395, -20.995]]
    _equal(sorted(tgeom.roi_process(t1, poly).items()),
           sorted(jgeom.roi_process(j1, poly).items()))


@pytest.mark.parametrize('geoid', [True, False], ids=['geoid', 'ellipsoid'])
def test_rpc_geom_exogenous_dem_equal(cams, dem, geoid):
    """The DEM branch: the profile, a windowed read with both nodata
    values, the geoid offset, the ROI's height and the DEM's disparity
    range."""
    j1, j2, t1, t2 = cams
    bbx = jgeom.geodesic_bounding_box(j1, *ROI)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')     # the coarse geoid's warning
        got = tgeom.min_max_heights_from_bbx(dem, *bbx, t1, geoid)
        want = jgeom.min_max_heights_from_bbx(dem, *bbx, j1, geoid)
        _equal(got, want)
        assert H0 - 30 <= want[0] < want[1] <= H0 + 30 or geoid
        kw = dict(exogenous_dem=dem, exogenous_dem_geoid_mode=geoid)
        _equal(tgeom.altitude_range(t1, *ROI, 100, -10, **kw),
               jgeom.altitude_range(j1, *ROI, 100, -10, **kw))
        H1, H2 = np.eye(3), np.eye(3)
        _equal(tgeom.exogenous_disp_range_estimation(
            t1, t2, *ROI, H1, H2, None, 100, -10, **kw),
            jgeom.exogenous_disp_range_estimation(
                j1, j2, *ROI, H1, H2, None, 100, -10, **kw))
        poly = [[55.39, -20.99], [55.395, -20.99], [55.395, -20.995]]
        _equal(sorted(tgeom.roi_process(t1, poly, exogenous_dem=dem,
                                        exogenous_dem_geoid_mode=geoid)
                      .items()),
               sorted(jgeom.roi_process(j1, poly, exogenous_dem=dem,
                                        exogenous_dem_geoid_mode=geoid)
                      .items()))
        # a box outside the DEM falls back to the coarse RPC range
        _equal(tgeom.min_max_heights_from_bbx(dem, 60.0, 60.1, 10.0, 10.1,
                                              t1, geoid),
               jgeom.min_max_heights_from_bbx(dem, 60.0, 60.1, 10.0, 10.1,
                                              j1, geoid))


def test_srtm_lookup_equal(cams, tmp_path, monkeypatch):
    """SRTM heights from a local .hgt tile (S2P_TPU_SRTM_DIR), and the
    use_srtm branch of altitude_range and roi_process."""
    j1, _, t1, _ = cams
    rng = np.random.RandomState(6)
    grid = (300 + rng.randint(-40, 40, (121, 121))).astype('>i2')
    grid[10:12, 30:33] = -32768
    grid.tofile(str(tmp_path / 'S21E055.hgt'))
    lons = 55.0 + rng.rand(500)
    lats = -21.0 + rng.rand(500) * 1.2        # some fall outside the tile
    _equal(tsrtm.lookup(str(tmp_path), lons, lats),
           jsrtm.lookup(str(tmp_path), lons, lats))
    monkeypatch.setenv('S2P_TPU_SRTM_DIR', str(tmp_path))
    _equal(tgeom.altitude_range(t1, *ROI, 5, -5, use_srtm=True),
           jgeom.altitude_range(j1, *ROI, 5, -5, use_srtm=True))
    poly = [[55.39, -20.99], [55.395, -20.99], [55.395, -20.995]]
    _equal(sorted(tgeom.roi_process(t1, poly, use_srtm=True).items()),
           sorted(jgeom.roi_process(j1, poly, use_srtm=True).items()))


def test_registration_and_filter_equal(cams):
    j1, j2, t1, t2 = cams
    m = sift_matches(t1, t2, ROI)
    m[:5, 3] += 4.0                            # off their epipolar lines
    H1, H2, F = jrect.rectification_homographies(
        jgeom.matches_from_rpc(j1, j2, *ROI, 5), *ROI)
    _equal(trect.rectification_homographies(
        tgeom.matches_from_rpc(t1, t2, *ROI, 5), *ROI), (H1, H2, F))
    kept = trect.filter_matches_epipolar_constraint(F, m, 1.0)
    _equal(kept, jrect.filter_matches_epipolar_constraint(F, m, 1.0))
    assert len(kept) == len(m) - 5
    assert len(trect.filter_matches_epipolar_constraint(F, m[:0], 0.5)) == 0
    _equal(trect.register_horizontally_shear(kept, H1, H2),
           jrect.register_horizontally_shear(kept, H1, H2))
    for flag in ('center', 'positive', 'negative'):
        _equal(trect.register_horizontally_translation(kept, H1, H2, flag),
               jrect.register_horizontally_translation(kept, H1, H2, flag))
    _equal(trect.disparity_range_from_matches(kept, H1, H2, 0.3),
           jrect.disparity_range_from_matches(kept, H1, H2, 0.3))


def _cfgs(**kw):
    return JConfig(**kw), TConfig(**kw)


@pytest.mark.parametrize('method', ['rpc', 'sift'])
@pytest.mark.parametrize('policy', POLICIES)
def test_rectify_pair_geometry_equal(cams, dem, method, policy):
    """Both rectification methods under all five range policies, with
    the exogenous DEM, a pointing correction and shear registration."""
    j1, j2, t1, t2 = cams
    m = sift_matches(t1, t2, ROI, seed=3)
    A = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, -0.3], [0.0, 0.0, 1.0]])
    jc, tc = _cfgs(disp_range_method=policy, exogenous_dem=dem,
                   alt_min=250.0, alt_max=380.0, disp_min=-12.0,
                   disp_max=7.0)
    kw = dict(A=A, sift_matches=m, method=method, hmargin=50, vmargin=10)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        got = trect.rectify_pair_geometry(tc, t1, t2, *ROI, **kw)
        want = jrect.rectify_pair_geometry(jc, j1, j2, *ROI, **kw)
    _equal(got, want)
    if policy == 'fixed_pixel_range':
        assert want[2:4] == (-12.0, 7.0)
    # rectified rows agree for the matches the epipolar filter keeps
    H1, H2 = want[:2]
    from s2p_tpu_torch.ops.homography import points_apply_homography
    y1 = points_apply_homography(H1, m[:, :2])[:, 1]
    y2 = points_apply_homography(H2, m[:, 2:])[:, 1]
    assert np.median(np.abs(y1 - y2)) < 0.5


@pytest.mark.parametrize('shear', [True, False], ids=['shear', 'no_shear'])
def test_register_with_shear_and_no_sift(cams, shear):
    """register_with_shear on and off; without SIFT matches the range
    falls back to +-3 px and the translation registration is skipped."""
    j1, j2, t1, t2 = cams
    jc, tc = _cfgs(register_with_shear=shear, disp_range_method='sift')
    got = trect.rectify_pair_geometry(tc, t1, t2, *ROI)
    want = jrect.rectify_pair_geometry(jc, j1, j2, *ROI)
    _equal(got, want)
    assert want[2:4] == (-3, 3)


def test_no_rectification_matches_and_warning(cams):
    j1, j2, t1, t2 = cams
    jc, tc = _cfgs()
    m = sift_matches(t1, t2, ROI, n=3)
    for cfg, r1, r2, mod in ((tc, t1, t2, trect), (jc, j1, j2, jrect)):
        with pytest.raises(mod.NoRectificationMatchesError):
            mod.rectify_pair_geometry(cfg, r1, r2, *ROI, sift_matches=None,
                                      method='sift')
        with pytest.raises(mod.NoRectificationMatchesError):
            mod.rectify_pair_geometry(cfg, r1, r2, *ROI, sift_matches=m,
                                      method='sift')
        with pytest.raises(ValueError):
            mod.rectify_pair_geometry(cfg, r1, r2, *ROI, method='bogus')
    # every match off its epipolar line: warned, no translation step
    far = sift_matches(t1, t2, ROI, n=20)
    far[:, 3] += 25.0
    with pytest.warns(trect.NoHorizontalRegistrationWarning):
        got = trect.rectify_pair_geometry(tc, t1, t2, *ROI, sift_matches=far)
    with pytest.warns(jrect.NoHorizontalRegistrationWarning):
        want = jrect.rectify_pair_geometry(jc, j1, j2, *ROI, sift_matches=far)
    _equal(got, want)
    with pytest.raises(ValueError):
        trect.disparity_range(TConfig(disp_range_method='bogus'), t1, t2,
                              *ROI, np.eye(3), np.eye(3), None)


def test_rectify_pair_images_equal_unjitted(cams):
    """rectify_pair's two warps (order 5, a NaN block) on the CPU equal
    the JAX package's unjitted run bitwise.  The ROI lies near the
    images' origin, where the cameras' polynomials still hold."""
    j1, j2, t1, t2 = cams
    roi = (150, 140, 200, 160)
    rng = np.random.RandomState(8)
    im1 = (rng.rand(480, 520) * 200).astype(np.float32)
    im2 = (rng.rand(480, 520) * 200).astype(np.float32)
    im1[200:204, 230:240] = np.nan
    m = sift_matches(t1, t2, roi, seed=5)
    # the affine fundamental matrix misses these matches by about 2 px
    # this far from the cameras' centre: a wider filter keeps them
    jc, tc = _cfgs(disp_range_method='sift', epipolar_thresh=3.0)
    kw = dict(sift_matches=m, method='rpc', hmargin=20, vmargin=5)
    got = trect.rectify_pair(tc, im1, im2, t1, t2, *roi, device='cpu', **kw)
    with jax.disable_jit():
        want = jrect.rectify_pair(jc, im1, im2, j1, j2, *roi, **kw)
    _equal(got[2:], want[2:])
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
        assert np.isfinite(a).mean() > 0.5
    assert np.isnan(got[0]).any()           # the NaN block, masked
