"""Consistent rescaling of an image and its RPC model.

Replaces the reference's ``utils/scale_image_and_rpc.py``: scaling an image
by ``z`` scales the RPC's image-space offsets and scales by the same
factor (zoom out: z < 1).
"""

from __future__ import annotations

import numpy as np

from ..geo import geotiff, rpc_io
from ..geo.rpc import RPCModel


def scale_rpc(rpc: RPCModel, z: float) -> RPCModel:
    """Scale an RPC model to an image zoomed by factor z."""
    d = rpc.to_dict()
    for k in ('col_offset', 'row_offset', 'col_scale', 'row_scale'):
        d[k] = d[k] * z
    return RPCModel.from_dict(d)


def scale_image_and_rpc(img_in, img_out, z):
    """Zoom a GeoTIFF by z (bilinear) and rewrite its RPC tag accordingly."""
    arr = geotiff.read(img_in)
    prof = geotiff.read_profile(img_in)
    h, w = arr.shape[:2]
    oh, ow = int(round(h * z)), int(round(w * z))

    ys = (np.arange(oh) + 0.5) / z - 0.5
    xs = (np.arange(ow) + 0.5) / z - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 2)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a = arr[y0][:, x0]
    b = arr[y0][:, x0 + 1]
    c = arr[y0 + 1][:, x0]
    dd = arr[y0 + 1][:, x0 + 1]
    out = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
           + c * fy * (1 - fx) + dd * fy * fx).astype(arr.dtype)

    rpc_tag = None
    if prof.rpc_tag is not None:
        rpc = rpc_io.rpc_from_tag_values(prof.rpc_tag)
        rpc_tag = rpc_io.rpc_to_tag_values(scale_rpc(rpc, z))
    geotiff.write(img_out, out, nodata=prof.nodata, rpc=rpc_tag)
