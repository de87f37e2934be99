"""3D outlier filtering of gridded point clouds.

The port's counterpart of ``s2p_tpu/ops/filtering.py``:

  * :func:`count_3d_neighbors` and :func:`count_3d_neighbors_batch` -- the
    (2p+1)^2 stencil count of 3D neighbours within r, torch on the
    device, with the JAX package's host float64 centring and its chunks
    of 16 tiles;
  * :func:`remove_isolated_3d_points` and :func:`filter_xyz` -- copies of
    its host reject-then-rescue pass (numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve


def _count_neighbors(xyz, r, p):
    """Neighbour counts of a (B, h, w, 3) float32 tensor (inf = no
    point): for each pixel, the points of its (2p+1)^2 window, itself
    included, whose squared distance is below r * r (in float32)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    h, w = x.shape[-2:]
    pad = (p, p, p, p)
    xp, yp, zp = (torch.nn.functional.pad(a, pad, value=float('inf'))
                  for a in (x, y, z))
    r2 = torch.tensor(r * r, dtype=torch.float32, device=xyz.device)
    count = torch.zeros(x.shape, dtype=torch.int32, device=xyz.device)
    for dy in range(2 * p + 1):
        for dx in range(2 * p + 1):
            ex = xp[..., dy:dy + h, dx:dx + w] - x
            ey = yp[..., dy:dy + h, dx:dx + w] - y
            ez = zp[..., dy:dy + h, dx:dx + w] - z
            d2 = ex * ex + ey * ey + ez * ez
            count += (d2 < r2).to(torch.int32)
    return count


def _centered(a):
    """(float32 offsets from the mean of the finite points, inf where a
    point is not finite; the finite mask), centred in float64 first: raw
    UTM northings (about 7.7e6 m) quantize to 0.5 m steps in float32."""
    finite = np.isfinite(a).all(axis=-1)
    center = (np.nanmean(np.where(finite[..., None], a, np.nan),
                         axis=(0, 1)) if finite.any() else np.zeros(3))
    off = np.nan_to_num((a - center).astype(np.float32), nan=np.inf)
    off[~finite] = np.inf
    return off, finite


def count_3d_neighbors(xyz, r, p, device=None):
    """Number of 3D points within distance r in a (2p+1)^2 pixel window
    of one (h, w, 3) grid (reference disp_to_h.c: the centre point counts
    itself).  NaN points yield count 0.  ``device`` None runs on CUDA."""
    off, finite = _centered(np.asarray(xyz, dtype=np.float64))
    t = torch.as_tensor(off, device=resolve(device))[None]
    out = _count_neighbors(t, float(r), int(p))[0].cpu().numpy()
    out[~finite] = 0
    return out


def count_3d_neighbors_batch(xyzs, r, p, device=None):
    """Neighbour counts for many tiles in one batch on the device.

    Tiles pad to the largest (h, w) with +inf coordinates; an inf
    neighbour is never counted, exactly like the single tile's padding,
    so each cropped result equals :func:`count_3d_neighbors` on that tile
    alone.  At most 16 tiles go in one batch."""
    dev = resolve(device)
    xyzs = [np.asarray(a, dtype=np.float64) for a in xyzs]
    if len(xyzs) > 16:     # bound device memory on large scenes
        out = []
        for i in range(0, len(xyzs), 16):
            out.extend(count_3d_neighbors_batch(xyzs[i:i + 16], r, p, dev))
        return out
    H = max(a.shape[0] for a in xyzs)
    W = max(a.shape[1] for a in xyzs)
    batch = np.full((len(xyzs), H, W, 3), np.inf, np.float32)
    finites = []
    for k, a in enumerate(xyzs):
        off, finite = _centered(a)
        finites.append(finite)
        batch[k, :a.shape[0], :a.shape[1]] = off
    counts = _count_neighbors(torch.as_tensor(batch, device=dev), float(r),
                              int(p)).cpu().numpy()
    out = []
    for k, a in enumerate(xyzs):
        c = counts[k, :a.shape[0], :a.shape[1]].copy()
        c[~finites[k]] = 0
        out.append(c)
    return out


def remove_isolated_3d_points(xyz, r, p, n, q=1, max_rescue_iters=64,
                              count=None, device=None):
    """NaN-out (in place) points with < n neighbors, with rescue.

    A point is rejected when it has fewer than ``n`` 3D neighbors within
    ``r`` units inside a (2p+1)^2 window; rejected points adjacent (within a
    (2q+1)^2 window) to a kept point closer than ``r`` are rescued, and
    rescues propagate iteratively (the reference iterates to fixpoint, here
    capped at ``max_rescue_iters`` sweeps, which is equivalent for any
    realistic tile).  ``count`` optionally supplies the neighbour counts;
    otherwise they are counted on ``device``.
    """
    xyz = np.asarray(xyz)
    valid = np.isfinite(xyz).all(axis=-1)
    if count is None:
        count = count_3d_neighbors(xyz, r, p, device)
    rejected = valid & (count < n)

    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    h, w = x.shape
    r2 = r * r
    pads = [(dy, dx) for dy in range(-q, q + 1) for dx in range(-q, q + 1)
            if (dy, dx) != (0, 0)]

    def shifted(a, dy, dx, fill):
        out = np.full_like(a, fill)
        ys0, ys1 = max(dy, 0), min(h + dy, h)
        xs0, xs1 = max(dx, 0), min(w + dx, w)
        out[ys0:ys1, xs0:xs1] = a[ys0 - dy:ys1 - dy, xs0 - dx:xs1 - dx]
        return out

    for _ in range(max_rescue_iters):
        kept = valid & ~rejected
        rescued = np.zeros_like(rejected)
        for dy, dx in pads:
            nk = shifted(kept, dy, dx, False)
            d2 = ((shifted(x, dy, dx, np.inf) - x) ** 2
                  + (shifted(y, dy, dx, np.inf) - y) ** 2
                  + (shifted(z, dy, dx, np.inf) - z) ** 2)
            rescued |= rejected & nk & (d2 < r2)
        if not rescued.any():
            break
        rejected &= ~rescued

    xyz[rejected] = np.nan
    return xyz


def filter_xyz(xyz, r, n, img_gsd, count=None, device=None):
    """Radius/count outlier filter (reference triangulation.py
    ``filter_xyz``).  ``count`` optionally supplies precomputed neighbour
    counts (the batched stage-5 driver counts all tiles in one batch,
    :func:`count_3d_neighbors_batch`)."""
    p = int(np.ceil(r / img_gsd))
    return remove_isolated_3d_points(xyz, r, p, n, count=count,
                                     device=device)
