"""The port's stage-5 triangulation (device="cpu") against the JAX
package's on the same synthetic cameras and disparities.

Parity here is not bitwise: XLA's CPU run of the RPC chain rounds some
float32 operations differently from torch's one-at-a-time evaluation, and
the two-ray solve divides that pixel noise by the cameras' altitude
sensitivity.  So the cameras below have a realistic one (about 0.35
px/m between the two views, as a satellite pair with a base-to-height
ratio near 0.3 at 1 m resolution), with cross terms in every polynomial,
and each tolerance is stated in metres, pixels or degrees.  The NaN sets
(which pixels triangulate) must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2p_tpu.core import triangulation as jtri
from s2p_tpu.geo import rpc as jrpc
from s2p_tpu.ops import filtering as jfilt
from s2p_tpu_torch import state
from s2p_tpu_torch.core import triangulation as ttri
from s2p_tpu_torch.geo import rpc as trpc
from s2p_tpu_torch.ops import filtering as tfilt

# tolerances of the port against the JAX package (float32 on both).  The
# largest differences these tests measured: altitude 8.5e-4 m (about 25
# float32 ulp at 300 m), UTM 2.9e-4 m, lon/lat 2.8e-9 deg, error 2.7e-5
# px; a wrong homography, sign or polynomial term moves them by metres
ALT_TOL_M = 2e-3        # altitudes
XY_TOL_M = 1e-3         # UTM eastings and northings
LONLAT_TOL_DEG = 1e-8   # about 1 mm on the ground
ERR_TOL_PX = 1e-4       # two-ray reprojection error

UTM = 'epsg:32740'      # the scene lies at 55.4 E, 21.0 S


def jax_rpc(seed, h_term, same_rows=True):
    """A synthetic JAX RPCModel near (55.4 E, 21.0 S): about 1 m per
    pixel, columns shifting by ``10 * h_term`` px per metre of altitude,
    small cross terms in every polynomial.  With ``same_rows`` the row
    polynomials do not depend on the seed, so two such cameras see a
    ground point on the same row (an epipolar pair without
    rectification)."""
    rng = np.random.RandomState(seed)
    rows = np.random.RandomState(1000 if same_rows else seed + 1)
    col_num = rng.uniform(-1e-3, 1e-3, 20)
    col_num[:4] = (0.01, 1.0, 0.02, h_term)
    col_den = rng.uniform(-1e-4, 1e-4, 20)
    col_den[0] = 1.0
    row_num = rows.uniform(-1e-3, 1e-3, 20)
    row_num[:4] = (-0.02, 0.015, -1.0, 0.001)
    row_den = rows.uniform(-1e-4, 1e-4, 20)
    row_den[0] = 1.0
    return jrpc.RPCModel(
        col_num=col_num, col_den=col_den, row_num=row_num, row_den=row_den,
        lon_offset=55.4, lon_scale=0.05, lat_offset=-21.0, lat_scale=0.05,
        alt_offset=500.0, alt_scale=500.0, col_offset=5000.0,
        col_scale=5000.0, row_offset=5000.0, row_scale=5000.0)


def cameras(same_rows=True):
    """(JAX rpc1, JAX rpc2, port rpc1, port rpc2): 0.35 px/m between the
    two views; the port's are carried across by ``rpc_from_state``."""
    j1 = jax_rpc(1, 0.02, same_rows)
    j2 = jax_rpc(2, -0.015, same_rows)
    return (j1, j2, state.rpc_from_state(dataclasses.asdict(j1)),
            state.rpc_from_state(dataclasses.asdict(j2)))


def tile_job(seed, h, w, x0, y0, rpc1, rpc2, shear=True):
    """One tile's stage-5 inputs: homographies with a little shear, a
    smooth disparity with a few NaN and outliers, rectified and original
    masks with holes, and the pointing correction (identity)."""
    rng = np.random.RandomState(seed)
    s = 1 if shear else 0

    def homography(dx, a, b, p, q):
        # a shear and a projective term about the tile's origin
        S = np.array([[1.0, a * s, 0.0], [b * s, 1.0, 0.0],
                      [p * s, q * s, 1.0]])
        return S @ np.array([[1.0, 0.0, -x0 + dx], [0.0, 1.0, -y0 + 2],
                             [0.0, 0.0, 1.0]])
    H1 = homography(3, 0.002, -0.001, 1e-5, 0.0)
    H2 = homography(-40, 0.001, 0.0005, 0.0, 2e-5)
    yy, xx = np.mgrid[0:h, 0:w]
    disp = (35.0 + 4 * np.sin(xx / 9.0) + 3 * np.cos(yy / 7.0)
            + rng.rand(h, w) * 0.2).astype(np.float32)
    disp[rng.rand(h, w) < 0.03] = np.nan
    spikes = rng.rand(h, w) < 0.01
    disp[spikes] += rng.uniform(-30, 30, spikes.sum()).astype(np.float32)
    mask_rect = (rng.rand(h, w) > 0.02).astype(np.uint8) * 255
    mask_orig = np.ones((h - 4, w - 6), np.uint8)
    mask_orig[5:9, 10:20] = 0
    return dict(rpc1=rpc1, rpc2=rpc2, H1=H1, H2=H2, disp=disp,
                mask_rect=mask_rect, img_bbx=(x0, x0 + w - 6, y0, y0 + h - 4),
                mask_orig=mask_orig, A=np.eye(3))


# three tiles, two padded shapes: (64, 128) twice and (64, 64)
SPECS = ((0, 60, 70, 4000, 4800), (1, 50, 64, 4100, 4900),
         (2, 40, 100, 3900, 5000))


def _jobs(rpc1, rpc2):
    return [tile_job(seed, h, w, x0, y0, rpc1, rpc2)
            for seed, h, w, x0, y0 in SPECS]


def _max_diff(a, b):
    fin = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def _recentred(rpc, like, dx=4000.0, dy=4800.0):
    return jtri._recenter_params(rpc.params(), dx, dy, like.lon_offset,
                                 like.lat_offset)


def test_rpc_device_functions_match_jax():
    """project, localize and triangulate_height on float32 tensors
    against the JAX functions, in the pipeline's recentred frame."""
    j1, j2, t1, t2 = cameras(same_rows=False)
    p1 = _recentred(j1, j1)
    p2 = _recentred(j2, j1)
    assert all(np.array_equal(a, b) for a, b in zip(
        p1, ttri._recenter_params(t1.params(), 4000.0, 4800.0,
                                  t1.lon_offset, t1.lat_offset)))
    rng = np.random.RandomState(5)
    n = 4000
    col = (rng.rand(n) * 200).astype(np.float32)
    row = (rng.rand(n) * 200).astype(np.float32)
    alt = (rng.rand(n) * 600).astype(np.float32)
    jp1 = jrpc.RpcParams(*[jnp.asarray(f) for f in p1])
    jp2 = jrpc.RpcParams(*[jnp.asarray(f) for f in p2])
    tp1 = trpc.params_to_torch([p1], 'cpu')
    tp2 = trpc.params_to_torch([p2], 'cpu')
    tc, tr, ta = (torch.from_numpy(v) for v in (col, row, alt))

    lon_j, lat_j = jrpc.localize_jax(jp1, col, row, alt)
    lon_t, lat_t = trpc.localize(tp1, tc, tr, ta)
    d_loc = max(_max_diff(np.asarray(lon_j), lon_t.numpy()),
                _max_diff(np.asarray(lat_j), lat_t.numpy()))
    cx_j, cy_j = jrpc.project_jax(jp2, lon_j, lat_j, alt)
    cx_t, cy_t = trpc.project(tp2, torch.from_numpy(np.array(lon_j)),
                              torch.from_numpy(np.array(lat_j)), ta)
    d_proj = max(_max_diff(np.asarray(cx_j), cx_t.numpy()),
                 _max_diff(np.asarray(cy_j), cy_t.numpy()))
    xb, yb = (np.array(v) for v in (cx_j, cy_j))
    h_j, e_j = jrpc.triangulate_height_jax(jp1, jp2, col, row, xb, yb)
    h_t, e_t = trpc.triangulate_height(tp1, tp2, tc, tr,
                                       torch.from_numpy(xb),
                                       torch.from_numpy(yb))
    d_alt = _max_diff(np.asarray(h_j), h_t.numpy())
    d_err = _max_diff(np.asarray(e_j), e_t.numpy())
    print(f'localize {d_loc:.3g} deg, project {d_proj:.3g} px, '
          f'altitude {d_alt:.3g} m, error {d_err:.3g} px')
    assert d_loc <= LONLAT_TOL_DEG
    assert d_proj <= ERR_TOL_PX
    assert d_alt <= ALT_TOL_M
    assert d_err <= ERR_TOL_PX
    # the solve recovers the altitude the points were projected from
    assert np.abs(h_t.numpy() - alt).max() < 0.05
    for a, b in ((lon_j, lon_t), (h_j, h_t)):
        assert np.array_equal(np.isnan(np.asarray(a)), torch.isnan(b).numpy())


@pytest.mark.parametrize('out_crs', [UTM, None])
def test_disp_to_xyz_batch_matches_jax(out_crs):
    """Three tiles in two padded shapes, with the pointing correction,
    in UTM and in lon/lat/alt (EPSG 4979)."""
    j1, j2, t1, t2 = cameras(same_rows=False)
    jres = jtri.disp_to_xyz_batch(_jobs(j1, j2), out_crs=out_crs)
    tres = ttri.disp_to_xyz_batch(_jobs(t1, t2), out_crs=out_crs,
                                  device='cpu')
    assert len({ttri._prep_triangulation(**{k: v for k, v in j.items()})[0]
                ['dx'].shape for j in _jobs(t1, t2)}) == 2
    # the single-tile entry runs the same batch of one
    xyz_1, err_1 = ttri.disp_to_xyz(**_jobs(t1, t2)[1], out_crs=out_crs,
                                    device='cpu')
    assert np.array_equal(xyz_1, tres[1][0], equal_nan=True)
    assert np.array_equal(err_1, tres[1][1], equal_nan=True)
    for (xyz_j, err_j), (xyz_t, err_t) in zip(jres, tres):
        assert xyz_j.shape == xyz_t.shape and xyz_t.dtype == np.float64
        assert err_t.dtype == np.float32
        assert np.array_equal(np.isnan(xyz_j), np.isnan(xyz_t))
        assert np.array_equal(np.isnan(err_j), np.isnan(err_t))
        assert np.isfinite(xyz_t).all(axis=-1).mean() > 0.8
        d_xy = _max_diff(xyz_j[..., :2], xyz_t[..., :2])
        d_alt = _max_diff(xyz_j[..., 2], xyz_t[..., 2])
        d_err = _max_diff(err_j, err_t)
        print(f'{out_crs}: xy {d_xy:.3g}, altitude {d_alt:.3g} m, '
              f'error {d_err:.3g} px')
        assert d_xy <= (XY_TOL_M if out_crs else LONLAT_TOL_DEG)
        assert d_alt <= ALT_TOL_M
        assert d_err <= ERR_TOL_PX


def test_known_altitude():
    """A disparity made from a chosen altitude field (localize in camera
    1, project in camera 2, both in float64) triangulates back to it."""
    _, _, t1, t2 = cameras(same_rows=True)
    h, w, x0, y0 = 48, 80, 4000, 4800
    job = tile_job(0, h, w, x0, y0, t1, t2, shear=False)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    alt = 200.0 + 40 * np.sin(xx / 13.0) + 0.5 * yy
    h1i = np.linalg.inv(job['H1'])
    px = h1i[0, 0] * xx + h1i[0, 1] * yy + h1i[0, 2]
    py = h1i[1, 0] * xx + h1i[1, 1] * yy + h1i[1, 2]
    lon, lat = t1.localization(px, py, alt)
    qx, qy = t2.projection(lon, lat, alt)
    assert np.abs(qy - py).max() < 1e-6          # same rows: epipolar
    H2 = job['H2']
    job['disp'] = ((H2[0, 0] * qx + H2[0, 2]) - xx).astype(np.float32)
    job['mask_rect'][:] = 255
    (xyz, err), = ttri.disp_to_xyz_batch([job], out_crs=None, device='cpu')
    fin = np.isfinite(xyz[..., 2])
    d = np.abs(xyz[..., 2] - alt)[fin].max()
    print(f'known altitude: max error {d:.3g} m over {fin.sum()} points')
    assert fin.mean() > 0.8          # the bbox and mask_orig cut the rest
    assert d < 0.01
    assert np.nanmax(err) < 1e-3


def test_rpc_from_state_round_trip():
    """A JAX RPCModel (its dataclass fields, ``to_dict`` or its
    ``RpcParams``) becomes the port's with the same values, and a JAX
    Config with loaded cameras carries them across."""
    from s2p_tpu.config import Config as JConfig
    from s2p_tpu.config import ImageSpec as JImageSpec

    j1, _, t1, _ = cameras()
    for src in (dataclasses.asdict(j1), j1.to_dict(), j1.params()._asdict(),
                j1):
        t = state.rpc_from_state(src)
        assert isinstance(t, trpc.RPCModel)
        for f in trpc.RpcParams._fields:
            assert np.array_equal(np.asarray(getattr(t, f)),
                                  np.asarray(getattr(j1, f))), f
        assert np.array_equal(np.stack(t.projection(55.41, -20.99, 300.0)),
                              np.stack(j1.projection(55.41, -20.99, 300.0)))
        assert np.array_equal(np.stack(t.localization(4000.5, 4800.5, 30.0)),
                              np.stack(j1.localization(4000.5, 4800.5, 30.0)))
    with pytest.raises(ValueError):
        state.rpc_from_state({'col_num': j1.col_num})
    jcfg = JConfig(images=(JImageSpec(img='a.tif', rpcm=j1),
                           JImageSpec(img='b.tif')), out_crs=UTM)
    d = jcfg.to_dict()
    d['images'][0]['rpcm'] = dataclasses.asdict(j1)
    cfg = state.config_from_state(d)
    assert all(np.array_equal(a, b) for a, b in zip(
        cfg.images[0].rpcm.params(), j1.params()))
    assert cfg.images[1].rpcm is None and cfg.out_crs == UTM


def _clouds(seed, shapes, outliers=True):
    rng = np.random.default_rng(seed)
    tiles = []
    for shape in shapes:
        a = rng.uniform(0, 30, (*shape, 3)).astype(np.float64)
        a[..., :2] += (7.1e5, 7.67e6)       # UTM magnitudes, centred in f64
        a[rng.random(shape) < 0.1] = np.nan
        tiles.append(a)
    return tiles


@pytest.mark.parametrize('n_tiles', [3, 18])
def test_count_3d_neighbors_batch_matches_jax(n_tiles):
    """Neighbour counts equal the JAX package's, single and batched (18
    tiles take two chunks of at most 16)."""
    shapes = [(60, 70), (55, 70), (60, 64)] * (n_tiles // 3)
    tiles = _clouds(0, shapes)
    got = tfilt.count_3d_neighbors_batch(tiles, 5.0, 3, device='cpu')
    ref = jfilt.count_3d_neighbors_batch(tiles, 5.0, 3)
    for g, r, t in zip(got, ref, tiles):
        assert g.dtype == np.int32 and g.shape == t.shape[:2]
        assert np.array_equal(g, np.asarray(r))
    single = tfilt.count_3d_neighbors(tiles[1], 5.0, 3, device='cpu')
    assert np.array_equal(single, got[1])
    assert np.array_equal(single, jfilt.count_3d_neighbors(tiles[1], 5.0, 3))


def test_filter_xyz_matches_jax():
    """The host reject-then-rescue pass on the port's counts equals the
    JAX package's filter."""
    xyz = _clouds(3, [(40, 50)])[0]
    xyz[::7, ::5, 2] += 40.0                   # isolated outliers
    got = tfilt.filter_xyz(xyz.copy(), 5.0, 20, 1.0, device='cpu')
    ref = jfilt.filter_xyz(xyz.copy(), 5.0, 20, 1.0)
    assert np.isnan(got).any(axis=-1).sum() > np.isnan(xyz).any(axis=-1).sum()
    assert np.array_equal(got, ref, equal_nan=True)
