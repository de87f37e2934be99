"""RPC (Rational Polynomial Coefficient) camera models.

The port's counterpart of ``s2p_tpu/geo/rpc.py``.  A satellite RPC model
maps geographic coordinates (lon, lat, alt) to image coordinates (col,
row) through degree-3 rational polynomials of 20 terms evaluated in a
normalized coordinate space.  This module holds

  * :class:`RPCModel` and :class:`RpcParams` -- copies of the JAX
    package's host-side float64 model (``projection`` / ``localization``)
    and of its flat coefficient record, numpy only;
  * :func:`project_normalized`, :func:`project`,
    :func:`localize_normalized`, :func:`localize` and
    :func:`triangulate_height` -- torch counterparts of
    ``project_normalized_jax``, ``project_jax``,
    ``localize_normalized_jax``, ``localize_jax`` and
    ``triangulate_height_jax``, plain functions on float32 tensors with
    the same fixed iteration counts and the same order of operations.

The JAX package ``vmap``s its device functions over tiles.  Here the
coefficient fields of an :class:`RpcParams` of tensors carry their batch
axes explicitly: each coefficient vector has shape (..., 20) and each
scale or offset shape (...), where (...) broadcasts against the
coordinates (for a batch of tiles of shape (B, h, w): (B, 1, 1, 20) and
(B, 1, 1); see :func:`params_to_torch`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

def _poly20(c, L, P, H):
    """Evaluate the 20-term cubic polynomial with coefficients ``c``, its
    monomials of (L, P, H) in RPC-spec order: 1, L, P, H, LP, LH, PH, L2,
    P2, H2, LPH, L3, LP2, LH2, L2P, P3, PH2, L2H, P2H, H3.

    Works for numpy arrays and torch tensors alike; L, P, H broadcast
    against each other and ``c`` has shape (..., 20) broadcastable on the
    leading axes.
    """
    LL, PP, HH = L * L, P * P, H * H
    return (c[..., 0]
            + c[..., 1] * L + c[..., 2] * P + c[..., 3] * H
            + c[..., 4] * L * P + c[..., 5] * L * H + c[..., 6] * P * H
            + c[..., 7] * LL + c[..., 8] * PP + c[..., 9] * HH
            + c[..., 10] * L * P * H
            + c[..., 11] * LL * L + c[..., 12] * L * PP + c[..., 13] * L * HH
            + c[..., 14] * LL * P + c[..., 15] * PP * P + c[..., 16] * P * HH
            + c[..., 17] * LL * H + c[..., 18] * PP * H + c[..., 19] * HH * H)


def _poly20_dL(c, L, P, H):
    """d/dL of :func:`_poly20`."""
    return (c[..., 1] + c[..., 4] * P + c[..., 5] * H
            + 2 * c[..., 7] * L + c[..., 10] * P * H
            + 3 * c[..., 11] * L * L + c[..., 12] * P * P + c[..., 13] * H * H
            + 2 * c[..., 14] * L * P + 2 * c[..., 17] * L * H)


def _poly20_dP(c, L, P, H):
    """d/dP of :func:`_poly20`."""
    return (c[..., 2] + c[..., 4] * L + c[..., 6] * H
            + 2 * c[..., 8] * P + c[..., 10] * L * H
            + 2 * c[..., 12] * L * P + 3 * c[..., 15] * P * P
            + c[..., 16] * H * H + 2 * c[..., 18] * P * H)


class RpcParams(NamedTuple):
    """Flat record of RPC inverse-model coefficients (ground -> image).

    Host side: numpy arrays, coefficient vectors (20,), scales and offsets
    ().  Device side (:func:`params_to_torch`): tensors with a batch axis.
    """
    col_num: np.ndarray
    col_den: np.ndarray
    row_num: np.ndarray
    row_den: np.ndarray
    lon_offset: np.ndarray
    lon_scale: np.ndarray
    lat_offset: np.ndarray
    lat_scale: np.ndarray
    alt_offset: np.ndarray
    alt_scale: np.ndarray
    col_offset: np.ndarray
    col_scale: np.ndarray
    row_offset: np.ndarray
    row_scale: np.ndarray

    def astype(self, dtype):
        return RpcParams(*[np.asarray(f, dtype=dtype) for f in self])


_COEFFS = ('col_num', 'col_den', 'row_num', 'row_den')


def params_to_torch(params, device, lead=0, dtype=torch.float32):
    """An :class:`RpcParams` of tensors on ``device`` from a list of host
    records (one per tile) stacked on a leading axis.

    ``lead`` is the number of broadcast axes put after the stacking axis:
    (B, h, w) coordinates take ``lead=2``, giving coefficient vectors
    (B, 1, 1, 20) and scales and offsets (B, 1, 1)."""
    fields = []
    for f in RpcParams._fields:
        a = np.stack([np.asarray(getattr(r, f), dtype=np.float32)
                      for r in params])
        shape = ((len(params),) + (1,) * lead
                 + ((20,) if f in _COEFFS else ()))
        fields.append(torch.as_tensor(a, device=device).to(dtype)
                      .reshape(shape))
    return RpcParams(*fields)


@dataclasses.dataclass
class RPCModel:
    """Host-side RPC camera model (float64, numpy).

    Mirrors the public attribute/method surface of ``rpcm.RPCModel`` used by
    the reference s2p (attributes ``{col,row,lat,lon,alt}_{offset,scale}``,
    ``{col,row}_{num,den}``, methods ``projection`` and ``localization``).
    """
    col_num: np.ndarray
    col_den: np.ndarray
    row_num: np.ndarray
    row_den: np.ndarray
    lon_offset: float
    lon_scale: float
    lat_offset: float
    lat_scale: float
    alt_offset: float
    alt_scale: float
    col_offset: float
    col_scale: float
    row_offset: float
    row_scale: float
    # optional direct model (ground <- image); rarely provided by vendors
    lon_num: np.ndarray | None = None
    lon_den: np.ndarray | None = None
    lat_num: np.ndarray | None = None
    lat_den: np.ndarray | None = None

    def __post_init__(self):
        for f in _COEFFS:
            v = np.asarray(getattr(self, f), dtype=np.float64)
            if v.shape != (20,):
                raise ValueError(f'RPC coefficient {f} must have 20 terms, got {v.shape}')
            setattr(self, f, v)

    # ------------------------------------------------------------------ #
    def projection(self, lon, lat, alt):
        """Ground (lon, lat, alt) -> image (col, row).  Vectorized."""
        lon = np.asarray(lon, dtype=np.float64)
        lat = np.asarray(lat, dtype=np.float64)
        alt = np.asarray(alt, dtype=np.float64)
        L = (lon - self.lon_offset) / self.lon_scale
        P = (lat - self.lat_offset) / self.lat_scale
        H = (alt - self.alt_offset) / self.alt_scale
        col = _poly20(self.col_num, L, P, H) / _poly20(self.col_den, L, P, H)
        row = _poly20(self.row_num, L, P, H) / _poly20(self.row_den, L, P, H)
        return (col * self.col_scale + self.col_offset,
                row * self.row_scale + self.row_offset)

    def localization(self, col, row, alt, return_normalized=False):
        """Image (col, row) + altitude -> ground (lon, lat).  Vectorized.

        Inverts the projection by Newton iteration with the exact Jacobian
        (the reference s2p uses a finite-difference secant scheme; both
        converge to the same fixed point).
        """
        col = np.asarray(col, dtype=np.float64)
        row = np.asarray(row, dtype=np.float64)
        alt = np.asarray(alt, dtype=np.float64)
        cn = (col - self.col_offset) / self.col_scale
        rn = (row - self.row_offset) / self.row_scale
        H = (alt - self.alt_offset) / self.alt_scale

        L = np.zeros_like(cn + rn + H)
        P = np.zeros_like(L)
        for _ in range(12):
            L, P, err = self._newton_step(L, P, H, cn, rn)
            if err < 1e-13:
                break
        if return_normalized:
            return L, P
        return (L * self.lon_scale + self.lon_offset,
                P * self.lat_scale + self.lat_offset)

    def _newton_step(self, L, P, H, cn, rn):
        fc_n, fc_d = _poly20(self.col_num, L, P, H), _poly20(self.col_den, L, P, H)
        fr_n, fr_d = _poly20(self.row_num, L, P, H), _poly20(self.row_den, L, P, H)
        fc = fc_n / fc_d
        fr = fr_n / fr_d
        # Jacobian of (fc, fr) wrt (L, P) via quotient rule
        dc_dL = (_poly20_dL(self.col_num, L, P, H) - fc * _poly20_dL(self.col_den, L, P, H)) / fc_d
        dc_dP = (_poly20_dP(self.col_num, L, P, H) - fc * _poly20_dP(self.col_den, L, P, H)) / fc_d
        dr_dL = (_poly20_dL(self.row_num, L, P, H) - fr * _poly20_dL(self.row_den, L, P, H)) / fr_d
        dr_dP = (_poly20_dP(self.row_num, L, P, H) - fr * _poly20_dP(self.row_den, L, P, H)) / fr_d
        det = dc_dL * dr_dP - dc_dP * dr_dL
        ec = cn - fc
        er = rn - fr
        L = L + (dr_dP * ec - dc_dP * er) / det
        P = P + (-dr_dL * ec + dc_dL * er) / det
        return L, P, float(np.max(ec * ec + er * er)) if ec.size else 0.0

    # ------------------------------------------------------------------ #
    def params(self, dtype=np.float64) -> RpcParams:
        """The inverse-model coefficients as a flat record."""
        return RpcParams(*[np.asarray(getattr(self, f), dtype)
                           for f in RpcParams._fields])


# ====================================================================== #
# Device functions: float32 tensors, the JAX package's iteration counts
# and order of operations.
# ====================================================================== #

def project_normalized(rpc: RpcParams, L, P, H):
    """Normalized ground coords -> normalized image coords."""
    col = _poly20(rpc.col_num, L, P, H) / _poly20(rpc.col_den, L, P, H)
    row = _poly20(rpc.row_num, L, P, H) / _poly20(rpc.row_den, L, P, H)
    return col, row


def project(rpc: RpcParams, lon, lat, alt):
    """Ground -> image, denormalized."""
    L = (lon - rpc.lon_offset) / rpc.lon_scale
    P = (lat - rpc.lat_offset) / rpc.lat_scale
    H = (alt - rpc.alt_offset) / rpc.alt_scale
    col, row = project_normalized(rpc, L, P, H)
    return col * rpc.col_scale + rpc.col_offset, row * rpc.row_scale + rpc.row_offset


def localize_normalized(rpc: RpcParams, cn, rn, H, num_iters: int = 10):
    """Normalized image coords + normalized alt -> normalized (L, P).

    Fixed-iteration Newton solve with the exact Jacobian; every operand is
    O(1), so float32 converges to about 1e-7 normalized units.
    """
    L = torch.zeros_like(cn)
    P = torch.zeros_like(cn)
    for _ in range(num_iters):
        cd = _poly20(rpc.col_den, L, P, H)
        rd = _poly20(rpc.row_den, L, P, H)
        fc = _poly20(rpc.col_num, L, P, H) / cd
        fr = _poly20(rpc.row_num, L, P, H) / rd
        dc_dL = (_poly20_dL(rpc.col_num, L, P, H)
                 - fc * _poly20_dL(rpc.col_den, L, P, H)) / cd
        dc_dP = (_poly20_dP(rpc.col_num, L, P, H)
                 - fc * _poly20_dP(rpc.col_den, L, P, H)) / cd
        dr_dL = (_poly20_dL(rpc.row_num, L, P, H)
                 - fr * _poly20_dL(rpc.row_den, L, P, H)) / rd
        dr_dP = (_poly20_dP(rpc.row_num, L, P, H)
                 - fr * _poly20_dP(rpc.row_den, L, P, H)) / rd
        det = dc_dL * dr_dP - dc_dP * dr_dL
        ec = cn - fc
        er = rn - fr
        L, P = (L + (dr_dP * ec - dc_dP * er) / det,
                P + (-dr_dL * ec + dc_dL * er) / det)
    return L, P


def localize(rpc: RpcParams, col, row, alt, num_iters: int = 10):
    """Image (col, row, alt) -> ground (lon, lat), denormalized."""
    cn = (col - rpc.col_offset) / rpc.col_scale
    rn = (row - rpc.row_offset) / rpc.row_scale
    H = (alt - rpc.alt_offset) / rpc.alt_scale
    L, P = localize_normalized(rpc, cn, rn, H, num_iters)
    return L * rpc.lon_scale + rpc.lon_offset, P * rpc.lat_scale + rpc.lat_offset


def triangulate_height(rpc_a: RpcParams, rpc_b: RpcParams, xa, ya, xb, yb,
                       num_iters: int = 12, loc_iters: int = 8):
    """Two-ray altitude solve.

    Given a correspondence (xa, ya) in image a and (xb, yb) in image b,
    find the altitude h minimizing the reprojection distance in image b of
    the ray through (xa, ya): project (xa, ya, h) into image b (by
    localization in a, then projection in b), also at h + 1 m, and jump
    along the chord; ``num_iters`` such secant steps from h = 0.

    Returns (h, err), err the point-to-ray distance in pixels of image b.
    """
    def corresp(h):
        lon, lat = localize(rpc_a, xa, ya, h, loc_iters)
        return project(rpc_b, lon, lat, h)

    h = torch.zeros_like(xa)
    err = torch.full_like(xa, float('inf'))
    for _ in range(num_iters):
        px, py = corresp(h)
        qx, qy = corresp(h + 1.0)
        ax_, ay_ = qx - px, qy - py
        bx_, by_ = xb - px, yb - py
        a2 = ax_ * ax_ + ay_ * ay_
        lam = (ax_ * bx_ + ay_ * by_) / torch.clamp_min(a2, 1e-30)
        zx = px + lam * ax_
        zy = py + lam * ay_
        ex, ey = zx - xb, zy - yb
        err = torch.sqrt(ex * ex + ey * ey)
        h = h + lam * 1.0
    return h, err
