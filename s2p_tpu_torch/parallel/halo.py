"""Halo exchange over the ranks of a process group.

Counterpart of ``s2p_tpu/parallel/halo.py``:

  * :func:`sharded_dsm` rasterizes a grid of tiles split in contiguous
    blocks over the ranks.  Each tile splats its points into a grid
    widened by a halo band, then the overflow bands go to the lateral
    neighbours: first horizontally with full-height bands (they carry the
    corners), then vertically with core-width bands.  Between two tiles of
    one rank a band is added in place; between ranks it travels by gloo
    ``send``/``recv`` as a CPU tensor.  The result equals the
    rasterization of the whole cloud up to the order of the sums.
  * :func:`distributed_pointing_fit` solves the global affine pointing
    fit from per-rank sums and normal equations summed over the ranks.

The compute runs on each rank's device (``TileMesh.device``); only the
bands and the sums cross to the CPU for gloo.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

from .distributed import partition_tiles


def _splat_local(pts, w, xoff, yoff, res, halo, gw, gh, radius, sigma):
    """Gaussian scatter-add of (n, 3) points into a halo-widened grid:
    (weighted z sums, weights), each (gh + 2 halo, gw + 2 halo).

    The splat model of ``ops.rasterize.plyflatten``: a point adds to every
    cell within ``radius`` cells of its own, with the weight exp(-d^2 / 2
    sigma^2) of its distance to the cell's centre (1 with no sigma).  The
    grid covers x in [xoff - halo res, xoff + (gw + halo) res) and the rows
    below yoff + halo res."""
    dev = pts.device
    W = gw + 2 * halo
    H = gh + 2 * halo
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    good = torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z) & w
    f32 = torch.float32
    xoff = torch.tensor(xoff, dtype=f32, device=dev)
    yoff = torch.tensor(yoff, dtype=f32, device=dev)
    fj = (x - xoff) / res + halo
    fi = (yoff - y) / res + halo
    j0 = torch.floor(fj).to(torch.int32)
    i0 = torch.floor(fi).to(torch.int32)
    inv2s2 = 0.0 if sigma is None else 1.0 / (2.0 * sigma * sigma)
    acc = torch.zeros(H * W, dtype=f32, device=dev)
    wacc = torch.zeros(H * W, dtype=f32, device=dev)
    r = int(radius)
    for dj in range(-r, r + 1):
        for di in range(-r, r + 1):
            jj = j0 + dj
            ii = i0 + di
            inb = good & (jj >= 0) & (jj < W) & (ii >= 0) & (ii < H)
            cx = xoff + (jj.to(f32) + 0.5 - halo) * res
            cy = yoff - (ii.to(f32) + 0.5 - halo) * res
            d2 = (x - cx) ** 2 + (y - cy) ** 2
            wgt = torch.where(inb, torch.exp(-d2 * inv2s2), 0.0)
            flat = torch.where(inb, ii * W + jj, 0).to(torch.int64)
            acc.index_add_(0, flat, wgt * torch.where(inb, z, 0.0))
            wacc.index_add_(0, flat, wgt)
    return torch.stack([acc.reshape(H, W), wacc.reshape(H, W)])


def _exchange(grids, owner, rank, sends, recvs):
    """Move bands between tiles: ``sends`` holds (src tile, dst tile,
    band) and ``recvs`` (dst tile, src tile, shape); a band between tiles
    of this rank is returned directly, one between ranks goes through gloo
    on the CPU.  Returns {(src, dst): band on the grids' device}."""
    dev = next(iter(grids.values())).device
    got, work = {}, []
    for src, dst, band in sends:
        if owner[dst] == rank:
            got[(src, dst)] = band
        else:
            work.append(tdist.isend(band.cpu().contiguous(), owner[dst],
                                    tag=src * len(owner) + dst))
    bufs = {}
    for dst, src, shape in recvs:
        if owner[src] != rank:
            buf = torch.empty(shape, dtype=torch.float32)
            work.append(tdist.irecv(buf, owner[src],
                                    tag=src * len(owner) + dst))
            bufs[(src, dst)] = buf
    for w in work:
        w.wait()
    for k, buf in bufs.items():
        got[k] = buf.to(dev)
    return got


def sharded_dsm(mesh, tile_points, tile_valid, xoffs, yoffs, res, gw, gh,
                halo, grid_shape=None, radius=0, sigma=None):
    """Rasterize a grid of tiles with a two-phase halo exchange.

    Args:
        mesh: :class:`s2p_tpu_torch.parallel.TileMesh`; the tiles, row
            major over the grid, split in contiguous blocks over its ranks.
        tile_points: (n_tiles, n_pts, 3) float32 x, y, z; tile k owns the
            cells [xoffs[k], xoffs[k] + gw res) x (yoffs[k] - gh res,
            yoffs[k]]; points may spill into the neighbours' blocks by up
            to halo - radius cells.
        tile_valid: (n_tiles, n_pts) bool.
        xoffs, yoffs: (n_tiles,) west and north edges.
        gw, gh: a tile's grid in cells; halo: the band width in cells.
        grid_shape: (nty, ntx) tile layout; default (1, n_tiles).
        radius, sigma: the gaussian splat's parameters.
    Returns:
        (n_tiles, gh, gw) numpy weighted-mean-z rasters (NaN where empty),
        on every rank."""
    n_tiles = len(tile_points)
    nty, ntx = grid_shape if grid_shape is not None else (1, n_tiles)
    if nty * ntx != n_tiles:
        raise ValueError('the tile grid must hold every tile')
    rank = mesh.rank
    owner = [0] * n_tiles
    for r in range(mesh.n):
        for k in partition_tiles(range(n_tiles), r, mesh.n):
            owner[k] = r
    mine = list(partition_tiles(range(n_tiles), rank, mesh.n))
    dev = mesh.device
    xoffs = np.asarray(xoffs, np.float32)
    yoffs = np.asarray(yoffs, np.float32)
    grids = {}
    for k in mine:
        pts = torch.as_tensor(np.asarray(tile_points[k], np.float32),
                              device=dev)
        w = torch.as_tensor(np.asarray(tile_valid[k], bool), device=dev)
        grids[k] = _splat_local(pts, w, float(xoffs[k]), float(yoffs[k]),
                                res, halo, gw, gh, radius, sigma)

    def phase(grids, step, hi_band, lo_band, lo_add, hi_add, keep,
              neighbour):
        """One push: each tile sends its high overflow band to the
        neighbour ``+step`` and its low one to ``-step``; each adds what
        it receives into its inner bands, then keeps its core."""
        sends, recvs = [], []
        for k in mine:
            for nb, band in ((k + step, hi_band), (k - step, lo_band)):
                if neighbour(k, nb):
                    b = band(grids[k])
                    sends.append((k, nb, b))
                    # nb sends k its opposite band, of the same shape
                    recvs.append((k, nb, tuple(b.shape)))
        got = _exchange(grids, owner, rank, sends, recvs)
        out = {}
        for k in mine:
            a = grids[k].clone()
            if (k - step, k) in got:                 # from the low side
                lo_add(a, got[(k - step, k)])
            if (k + step, k) in got:                 # from the high side
                hi_add(a, got[(k + step, k)])
            out[k] = keep(a)
        return out

    def same_row(k, nb):
        return 0 <= nb < n_tiles and nb // ntx == k // ntx

    def in_grid(k, nb):
        return 0 <= nb < n_tiles

    def add_cols(lo, hi):
        def f(a, b):
            a[:, :, lo:hi] += b
        return f

    def add_rows(lo, hi):
        def f(a, b):
            a[:, lo:hi] += b
        return f

    # phase 1: horizontal, full-height bands (they carry the corners)
    grids = phase(grids, 1, lambda a: a[:, :, gw + halo:],
                  lambda a: a[:, :, :halo], add_cols(halo, 2 * halo),
                  add_cols(gw, gw + halo),
                  lambda a: a[:, :, halo:gw + halo], same_row)
    # phase 2: vertical, core-width bands (already merged in x)
    grids = phase(grids, ntx, lambda a: a[:, gh + halo:],
                  lambda a: a[:, :halo], add_rows(halo, 2 * halo),
                  add_rows(gh, gh + halo),
                  lambda a: a[:, halo:gh + halo], in_grid)
    rasters = {}
    for k in mine:
        acc, wacc = grids[k]
        rasters[k] = torch.where(
            wacc > 0, acc / torch.clamp(wacc, min=1e-30),
            float('nan')).cpu().numpy()
    allr = {}
    for part in mesh.gather(rasters):
        allr.update(part)
    return np.stack([allr[k] for k in range(n_tiles)])


def distributed_pointing_fit(mesh, centers, corrected):
    """Global affine pointing fit (centers -> corrected) from per-rank
    sums: the centring and isotropic scaling of both point sets, then the
    normal equations of the normalized affine least squares, each summed
    over the ranks in the JAX package's order of steps, solved on every
    rank in float32.

    Args:
        centers, corrected: (n_tiles, 2) tile centres and their locally
            corrected positions, split in contiguous blocks over the ranks.
    Returns:
        the 3x3 affine transform (numpy float32)."""
    dev = mesh.device
    f32 = torch.float32
    c = torch.as_tensor(np.asarray(mesh.block(list(centers)), np.float32),
                        device=dev).reshape(-1, 2)
    d = torch.as_tensor(np.asarray(mesh.block(list(corrected)), np.float32),
                        device=dev).reshape(-1, 2)
    total = mesh.all_sum
    n_tot = total(torch.tensor([float(c.shape[0])], dtype=f32, device=dev))[0]
    mu_c = total(c.sum(0)) / n_tot
    mu_d = total(d.sum(0)) / n_tot
    cc, dc = c - mu_c, d - mu_d
    s_c = torch.sqrt(total((cc * cc).sum().reshape(1))[0] / n_tot) + 1e-12
    s_d = torch.sqrt(total((dc * dc).sum().reshape(1))[0] / n_tot) + 1e-12
    cn, dn = cc / s_c, dc / s_d
    A = torch.cat([cn, torch.ones((cn.shape[0], 1), dtype=f32, device=dev)],
                  dim=1)
    AtA = total(A.T @ A)
    Atb = total(A.T @ dn)
    sol = torch.linalg.solve(AtA, Atb)                       # (3, 2)
    Mn = torch.cat([sol.T, torch.tensor([[0.0, 0.0, 1.0]], dtype=f32,
                                        device=dev)], dim=0)
    zero, one = torch.zeros((), dtype=f32, device=dev), \
        torch.ones((), dtype=f32, device=dev)
    T_d = torch.stack([torch.stack([s_d, zero, mu_d[0]]),
                       torch.stack([zero, s_d, mu_d[1]]),
                       torch.stack([zero, zero, one])])
    T_c_inv = torch.stack([torch.stack([1.0 / s_c, zero, -mu_c[0] / s_c]),
                           torch.stack([zero, 1.0 / s_c, -mu_c[1] / s_c]),
                           torch.stack([zero, zero, one])])
    return (T_d @ Mn @ T_c_inv).cpu().numpy()
