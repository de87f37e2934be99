"""Disparity-to-3D triangulation on the device.

The port's counterpart of ``s2p_tpu/core/triangulation.py`` (stage 5 of
the pair pipeline).  The per-pixel chain

    rectified pixel --H1^-1--> full-image pixel --+disparity, H2^-1-->
    secondary pixel --two-ray altitude solve--> (lon, lat, alt) + error

runs as torch code on float32 tensors over a whole batch of tiles
(:func:`_triangulate_grid_impl`, with the solvers of
:mod:`s2p_tpu_torch.geo.rpc`).  Float32 suffices because the host
recentres every pixel coordinate on the tile's origin and the geographic
offsets on the reference camera's, in float64, before the solve
(:func:`_recenter_params`), and the RPC math runs in normalized space;
the conversion to the output CRS runs on the host in float64.

The JAX package's program is a jitted jnp function, not a Pallas kernel,
so this is plain torch code: no CUDA kernel of the port's own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..geo import crs as crsmod
from ..geo.rpc import (RpcParams, localize, params_to_torch,
                       triangulate_height)


def _recenter_params(params: RpcParams, dx, dy, lon0=0.0, lat0=0.0,
                     dtype=np.float32) -> RpcParams:
    """Shift the image-space offsets (and optionally the geographic
    offsets) so every device value is small.

    Pixel recentring keeps coordinates O(1e3) on large satellite frames;
    the geographic anchor (lon0, lat0) is subtracted from the lon/lat
    offsets in float64 so that the lon/lat values flowing between the
    localization and projection stages of the two-ray solve stay O(0.1)
    degree (a raw float32 longitude of about 55 degrees is quantized to a
    0.4 m ground grid).  The host adds the anchor back.
    """
    p = params.astype(np.float64)
    p = p._replace(col_offset=p.col_offset - dx, row_offset=p.row_offset - dy,
                   lon_offset=p.lon_offset - lon0,
                   lat_offset=p.lat_offset - lat0)
    return p.astype(dtype)


def _apply_h(m, x, y):
    """A batch of 3x3 homographies m (B, 3, 3) applied to (B, h, w) or
    (h, w) coordinates, in the JAX package's order of operations."""
    def e(i, j):
        return m[:, i, j][:, None, None]
    z = e(2, 0) * x + e(2, 1) * y + e(2, 2)
    return ((e(0, 0) * x + e(0, 1) * y + e(0, 2)) / z,
            (e(1, 0) * x + e(1, 1) * y + e(1, 2)) / z)


def _triangulate_grid_impl(disp_x, disp_y, valid, h1_inv, h2_inv,
                           rpc1: RpcParams, rpc2: RpcParams,
                           mask_orig, mask_hw, spans):
    """Rectified disparities of a batch of tiles -> (lon, lat, alt, err,
    valid), each (B, h, w).

    Args:
        disp_x, disp_y: (B, h, w) float32 disparity components (rectified
            frame); ``disp_y`` None means zeros (s2p's disparities are
            horizontal), made on the device.
        valid: (B, h, w) bool mask of pixels to triangulate.
        h1_inv, h2_inv: (B, 3, 3) float32 inverse rectifying homographies
            mapping rectified coords to recentred full-image coords.
        rpc1, rpc2: recentred RPC params, fields (B, 1, 1, 20) and
            (B, 1, 1) (:func:`s2p_tpu_torch.geo.rpc.params_to_torch`).
        mask_orig: (B, Mh, Mw) uint8 padded original-domain validity.
        mask_hw: (B, 2) float32 true (unpadded) mask dims (hh, ww).
        spans: (B, 2) float32 (col_span, row_span) of the tile bbox.

    The original-domain inside and mask tests of the reference's C kernel
    (disp_to_h.c) run here, as in the JAX package, so px/py never leave
    the device.
    """
    B, h, w = disp_x.shape
    dev, dt = disp_x.device, disp_x.dtype
    if disp_y is None:
        disp_y = torch.zeros_like(disp_x)
    rows = torch.arange(h, device=dev, dtype=dt)[:, None].expand(h, w)
    cols = torch.arange(w, device=dev, dtype=dt)[None, :].expand(h, w)

    px, py = _apply_h(h1_inv, cols, rows)
    qx, qy = _apply_h(h2_inv, cols + disp_x, rows + disp_y)

    alt, err = triangulate_height(rpc1, rpc2, px, py, qx, qy)
    lon, lat = localize(rpc1, px, py, alt)

    hh = mask_hw[:, 0][:, None, None]
    ww = mask_hw[:, 1][:, None, None]
    rpx = torch.round(px)
    rpy = torch.round(py)
    inside = ((rpx >= 0) & (rpx <= spans[:, 0][:, None, None])
              & (rpy >= 0) & (rpy <= spans[:, 1][:, None, None]))
    mh, mw = mask_orig.shape[1:]
    ix = torch.clamp(torch.clamp(rpx, min=torch.zeros_like(ww), max=ww - 1)
                     .to(torch.int32), 0, mw - 1)
    iy = torch.clamp(torch.clamp(rpy, min=torch.zeros_like(hh), max=hh - 1)
                     .to(torch.int32), 0, mh - 1)
    at = torch.gather(mask_orig.reshape(B, -1), 1,
                      (iy.long() * mw + ix.long()).reshape(B, -1))
    mask_ok = torch.where((rpx < ww) & (rpy < hh),
                          at.reshape(B, h, w) != 0, True)
    valid = valid & inside & mask_ok

    nan = torch.tensor(float('nan'), dtype=dt, device=dev)
    return (torch.where(valid, lon, nan), torch.where(valid, lat, nan),
            torch.where(valid, alt, nan), torch.where(valid, err, nan),
            valid)


def _prep_triangulation(rpc1, rpc2, H1, H2, disp, mask_rect, img_bbx,
                        mask_orig, A=None, disp_y=None, pad_multiple=64):
    """Host prep of one tile: recentre + pad; returns (dict of the
    device inputs as float32 numpy arrays, meta dict for
    :func:`_post_triangulation`)."""
    disp = np.asarray(disp, dtype=np.float32)
    h, w = disp.shape
    if A is not None:  # fold the pointing correction into H2
        H2 = np.asarray(H2, dtype=np.float64) @ np.linalg.inv(np.asarray(A))

    col_min, col_max, row_min, row_max = [float(v) for v in img_bbx]

    # recentre everything at the bbx origin for f32 safety
    T = np.array([[1, 0, -col_min], [0, 1, -row_min], [0, 0, 1]], dtype=np.float64)
    h1_inv = np.linalg.inv(np.asarray(H1, dtype=np.float64))
    h2_inv = np.linalg.inv(np.asarray(H2, dtype=np.float64))
    lon0, lat0 = rpc1.lon_offset, rpc1.lat_offset
    rpc1_rc = _recenter_params(rpc1.params(), col_min, row_min, lon0, lat0)
    rpc2_rc = _recenter_params(rpc2.params(), col_min, row_min, lon0, lat0)

    dx = disp
    dy = None if disp_y is None else np.asarray(disp_y, np.float32)
    base_valid = np.isfinite(dx) & (np.asarray(mask_rect) != 0)

    # bucket the grid shape (multiples of 64); the pad region is masked
    # invalid and cropped off after the solve
    Hp = -(-h // pad_multiple) * pad_multiple
    Wp = -(-w // pad_multiple) * pad_multiple

    def padf(a, fill=0.0):
        out = np.full((Hp, Wp), fill, dtype=np.float32)
        out[:h, :w] = a
        return out

    vpad = np.zeros((Hp, Wp), dtype=bool)
    vpad[:h, :w] = base_valid

    mask_orig = np.asarray(mask_orig)
    mh, mw = mask_orig.shape
    Mh = -(-mh // pad_multiple) * pad_multiple
    Mw = -(-mw // pad_multiple) * pad_multiple
    mpad = np.zeros((Mh, Mw), dtype=np.uint8)
    mpad[:mh, :mw] = (mask_orig != 0)

    dev = dict(dx=padf(np.nan_to_num(dx)),
               dy=None if dy is None else padf(np.nan_to_num(dy)),
               valid=vpad, h1_inv=(T @ h1_inv).astype(np.float32),
               h2_inv=(T @ h2_inv).astype(np.float32),
               rpc1=rpc1_rc.astype(np.float32), rpc2=rpc2_rc.astype(np.float32),
               mask_orig=mpad,
               mask_hw=np.array([mh, mw], dtype=np.float32),
               spans=np.array([col_max - col_min, row_max - row_min],
                              dtype=np.float32))
    meta = dict(h=h, w=w, lon0=lon0, lat0=lat0)
    return dev, meta


def _post_triangulation(outs, meta, out_crs):
    """Host post of one tile: crop, denormalize, the f64 CRS conversion."""
    lon, lat, alt, err, valid = outs
    h, w = meta['h'], meta['w']
    lon = np.array(lon, dtype=np.float64)[:h, :w] + meta['lon0']
    lat = np.array(lat, dtype=np.float64)[:h, :w] + meta['lat0']
    alt = np.array(alt, dtype=np.float64)[:h, :w]
    err = np.array(err, dtype=np.float32)[:h, :w]
    valid = np.asarray(valid)[:h, :w]

    lon[~valid] = np.nan
    lat[~valid] = np.nan
    alt[~valid] = np.nan
    err[~valid] = np.nan

    # CRS conversion (host, f64)
    if out_crs is not None and crsmod.CRS(out_crs) != crsmod.CRS(4979):
        x, y, z = crsmod.transform(lon.ravel(), lat.ravel(), 4979,
                                   out_crs, alt.ravel())
        xyz = np.stack([x.reshape(h, w), y.reshape(h, w), z.reshape(h, w)], axis=-1)
    else:
        xyz = np.stack([lon, lat, alt], axis=-1)
    return xyz, err


def _triangulate_preps(preps, dev):
    """One batch of prepared tiles of one padded shape on ``dev``: the
    host outputs (lon, lat, alt, err, valid), each (B, h, w)."""
    def stack(key):
        return torch.as_tensor(np.stack([d[key] for d, _ in preps]),
                               device=dev)

    has_dy = preps[0][0]['dy'] is not None
    outs = _triangulate_grid_impl(
        stack('dx'), stack('dy') if has_dy else None, stack('valid'),
        stack('h1_inv'), stack('h2_inv'),
        params_to_torch([d['rpc1'] for d, _ in preps], dev, lead=2),
        params_to_torch([d['rpc2'] for d, _ in preps], dev, lead=2),
        stack('mask_orig'), stack('mask_hw'), stack('spans'))
    return [o.cpu().numpy() for o in outs]


def disp_to_xyz(rpc1, rpc2, H1, H2, disp, mask_rect, img_bbx, mask_orig,
                A=None, out_crs=None, disp_y=None, device=None):
    """Triangulate a rectified disparity map into a 3D coordinate grid.

    Returns (xyz, err): xyz (h, w, 3) in ``out_crs`` (lon/lat/alt when
    None), err the two-ray reprojection distance in pixels.

    Args:
        rpc1, rpc2: RPCModel cameras.
        H1, H2: rectifying homographies (full-image frame).
        disp: (h, w) horizontal disparity map (NaN = invalid).
        mask_rect: (h, w) rectified-domain validity mask.
        img_bbx: (col_min, col_max, row_min, row_max) in the full image.
        mask_orig: original-domain validity mask covering the bbx area.
        A: optional pointing correction applied to image 2.
        out_crs: CRS for the output coordinates.
        device: None runs on CUDA (and raises without it); "cpu" runs
            there.
    """
    prep = _prep_triangulation(rpc1, rpc2, H1, H2, disp, mask_rect,
                               img_bbx, mask_orig, A, disp_y)
    outs = _triangulate_preps([prep], resolve(device))
    return _post_triangulation(tuple(o[0] for o in outs), prep[1], out_crs)


def disp_to_xyz_batch(jobs, out_crs=None, device=None):
    """Batched tile triangulation: one batch per shape bucket (the grid
    and ``mask_orig`` padded to multiples of 64, and whether a vertical
    disparity is given), on one device.

    Args:
        jobs: list of dicts with keys (rpc1, rpc2, H1, H2, disp, mask_rect,
            img_bbx, mask_orig) and optional (A, disp_y).
        device: None runs on CUDA (and raises without it); "cpu" runs
            there.

    Returns:
        list of (xyz, err) in input order.
    """
    dev = resolve(device)
    preps = [
        _prep_triangulation(j['rpc1'], j['rpc2'], j['H1'], j['H2'],
                            j['disp'], j['mask_rect'], j['img_bbx'],
                            j['mask_orig'], j.get('A'), j.get('disp_y'))
        for j in jobs
    ]
    results = [None] * len(jobs)
    buckets = {}
    for idx, (d, _) in enumerate(preps):
        key = (d['dx'].shape, d['mask_orig'].shape, d['dy'] is not None)
        buckets.setdefault(key, []).append(idx)
    for idxs in buckets.values():
        outs = _triangulate_preps([preps[i] for i in idxs], dev)
        for k, idx in enumerate(idxs):
            results[idx] = _post_triangulation(
                tuple(o[k] for o in outs), preps[idx][1], out_crs)
    return results
