"""SIFT detection on the host: the JAX package's numpy and scipy route.

Counterpart of the host stages of ``s2p_tpu/ops/sift.py``, which that
package runs when ``sift_device`` is 'host' (``keypoints_from_array``'s
host branch): the scale space (an x2 bilinear upsampling, scipy's
separable gaussian blurs with symmetric boundaries), the 26-neighbour
extrema, the quadratic refinement, and the orientation and descriptor
histograms, vectorized over keypoints in chunks.  The code is the JAX
package's, numpy and scipy only, so on one machine it gives the same
bits; nothing here touches a device.  :mod:`s2p_tpu_torch.ops.sift`
switches between it and the device route.
"""

from __future__ import annotations

import math

import numpy as np

# IPOL reference parameters
DELTA_MIN = 0.5
SIGMA_MIN = 0.8
SIGMA_IN = 0.5
N_SPO = 3
C_EDGE = 10.0
LAMBDA_ORI = 1.5
LAMBDA_DESCR = 6.0
N_BINS = 36
N_HIST = 4
N_ORI = 8


def _gauss_kernel(sigma):
    r = max(1, int(math.ceil(4.0 * sigma)))
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img, sigma):
    """Separable gaussian blur, sampled kernel, symmetric (DCT-II) boundary
    (IPOL convention), by scipy's C path."""
    from scipy.ndimage import convolve1d
    k = _gauss_kernel(sigma)
    out = convolve1d(img, k, axis=0, mode='reflect')
    return convolve1d(out, k, axis=1, mode='reflect')


def _upsample2(img):
    """Bilinear x2 upsampling to the delta_min = 0.5 grid (IPOL oversample)."""
    h, w = img.shape
    oh, ow = 2 * h, 2 * w
    ys = np.arange(oh) * 0.5
    xs = np.arange(ow) * 0.5
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    fy = (ys - y0)[:, None].astype(np.float32)
    fx = (xs - x0)[None, :].astype(np.float32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    a = img[y0[:, None], x0[None, :]]
    b = img[y0[:, None], x1[None, :]]
    c = img[y1[:, None], x0[None, :]]
    d = img[y1[:, None], x1[None, :]]
    out = a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx \
        + c * fy * (1 - fx) + d * fy * fx
    return np.asarray(out, dtype=np.float32)


def _build_scale_space(img, n_oct, n_spo):
    """Gaussian scale space + DoG pyramid (a loop of scipy blurs).

    Returns per octave: (gauss (n_spo+3, h, w), dog (n_spo+2, h, w), delta).
    """
    octaves = []
    u = _upsample2(np.asarray(img, np.float32))
    sigma0 = math.sqrt(SIGMA_MIN ** 2 - SIGMA_IN ** 2) / DELTA_MIN
    v = _blur(u, sigma0)
    delta = DELTA_MIN
    for o in range(n_oct):
        imgs = [v]
        for s in range(1, n_spo + 3):
            rho = (SIGMA_MIN / DELTA_MIN) * math.sqrt(
                2 ** (2.0 * s / n_spo) - 2 ** (2.0 * (s - 1) / n_spo))
            imgs.append(_blur(imgs[-1], rho))
        g = np.stack(imgs)
        dog = g[1:] - g[:-1]
        octaves.append((g, dog, delta))
        if min(imgs[0].shape) // 2 < 12:
            break
        v = imgs[n_spo][::2, ::2]
        delta *= 2
    return octaves


def _extrema_mask(dog):
    """Strict 26-neighbor extrema of the DoG stack ((S, H, W) bool for
    scales 1..S-2, returned aligned with the full stack)."""
    S, H, W = dog.shape
    c = dog[1:-1, 1:-1, 1:-1]
    is_max = np.ones_like(c, dtype=bool)
    is_min = np.ones_like(c, dtype=bool)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = dog[1 + ds:S - 1 + ds, 1 + dy:H - 1 + dy,
                         1 + dx:W - 1 + dx]
                is_max &= c > nb
                is_min &= c < nb
    out = np.zeros((S, H, W), dtype=bool)
    out[1:-1, 1:-1, 1:-1] = is_max | is_min
    return out


def _refine_candidates(dog, cand, c_dog):
    """Vectorized 3D quadratic interpolation of extrema (IPOL: up to 5
    re-localization attempts, 0.6 offset gate, then |w| and edge tests).

    Args:
        dog: (S, H, W) numpy DoG stack of one octave.
        cand: (n, 3) integer candidates (s, y, x).

    Returns:
        (kept (m, 3) int, offsets (m, 3) float, vals (m,)).
    """
    S, H, W = dog.shape
    pos = cand.astype(np.int64).copy()
    n = len(pos)
    alive = np.ones(n, dtype=bool)
    done = np.zeros(n, dtype=bool)
    off = np.zeros((n, 3), dtype=np.float64)
    val = np.zeros(n, dtype=np.float64)

    for _ in range(5):
        idx = np.where(alive & ~done)[0]
        if len(idx) == 0:
            break
        s, y, x = pos[idx, 0], pos[idx, 1], pos[idx, 2]

        def at(ds, dy, dx):
            return dog[s + ds, y + dy, x + dx]

        g = np.stack([0.5 * (at(1, 0, 0) - at(-1, 0, 0)),
                      0.5 * (at(0, 1, 0) - at(0, -1, 0)),
                      0.5 * (at(0, 0, 1) - at(0, 0, -1))], axis=1)
        c0 = at(0, 0, 0)
        hss = at(1, 0, 0) + at(-1, 0, 0) - 2 * c0
        hyy = at(0, 1, 0) + at(0, -1, 0) - 2 * c0
        hxx = at(0, 0, 1) + at(0, 0, -1) - 2 * c0
        hsy = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0)
                      + at(-1, -1, 0))
        hsx = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1)
                      + at(-1, 0, -1))
        hyx = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1)
                      + at(0, -1, -1))
        Hm = np.empty((len(idx), 3, 3))
        Hm[:, 0, 0], Hm[:, 0, 1], Hm[:, 0, 2] = hss, hsy, hsx
        Hm[:, 1, 0], Hm[:, 1, 1], Hm[:, 1, 2] = hsy, hyy, hyx
        Hm[:, 2, 0], Hm[:, 2, 1], Hm[:, 2, 2] = hsx, hyx, hxx
        det = np.linalg.det(Hm)
        ok = np.abs(det) > 1e-30
        sol = np.zeros_like(g)
        if ok.any():
            sol[ok] = np.linalg.solve(Hm[ok], -g[ok][..., None])[..., 0]
        alive[idx[~ok]] = False

        interior = np.all(np.abs(sol) < 0.6, axis=1)
        w_interp = c0 + 0.5 * np.sum(g * sol, axis=1)
        fin = idx[interior & ok]
        off[fin] = sol[interior & ok]
        val[fin] = w_interp[interior & ok]
        done[fin] = True

        move = idx[~interior & ok]
        step = np.round(sol[~interior & ok]).astype(np.int64)
        step = np.clip(step, -1, 1)
        pos[move] += step
        inb = ((pos[move, 0] >= 1) & (pos[move, 0] <= S - 2)
               & (pos[move, 1] >= 1) & (pos[move, 1] <= H - 2)
               & (pos[move, 2] >= 1) & (pos[move, 2] <= W - 2))
        alive[move[~inb]] = False

    keep = alive & done & (np.abs(val) >= c_dog)
    if not keep.any():
        return (np.zeros((0, 3), np.int64), np.zeros((0, 3)), np.zeros(0))

    # edge-response test on the 2D spatial hessian
    s, y, x = pos[keep, 0], pos[keep, 1], pos[keep, 2]
    c0 = dog[s, y, x]
    hyy = dog[s, y + 1, x] + dog[s, y - 1, x] - 2 * c0
    hxx = dog[s, y, x + 1] + dog[s, y, x - 1] - 2 * c0
    hyx = 0.25 * (dog[s, y + 1, x + 1] - dog[s, y + 1, x - 1]
                  - dog[s, y - 1, x + 1] + dog[s, y - 1, x - 1])
    tr = hxx + hyy
    det2 = hxx * hyy - hyx * hyx
    edge_ok = (det2 > 0) & (tr * tr * C_EDGE < (C_EDGE + 1) ** 2 * det2)
    kidx = np.where(keep)[0][edge_ok]
    return pos[kidx], off[kidx], val[kidx]


def _extract_patches(field, y, x, r, fill=0.0):
    """(n, 2r+1, 2r+1) patches of ``field`` centered at integer (y, x);
    out-of-image samples get ``fill``.  Fully vectorized gather."""
    H, W = field.shape
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    yy = (y[:, None, None].astype(np.int32) + dy[None].astype(np.int32))
    xx = (x[:, None, None].astype(np.int32) + dx[None].astype(np.int32))
    inb = (yy >= 1) & (yy <= H - 2) & (xx >= 1) & (xx <= W - 2)
    vals = field[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
    return np.where(inb, vals, np.float32(fill)), yy, xx, inb


def _chunked(fun, n, budget_elems, patch_elems, *arrays):
    """Apply ``fun`` over keypoint chunks sized to a memory budget and
    concatenate the results along axis 0."""
    chunk = max(1, int(budget_elems // max(patch_elems, 1)))
    if n <= chunk:
        return fun(*arrays)
    outs = []
    for i in range(0, n, chunk):
        outs.append(fun(*[a[i:i + chunk] for a in arrays]))
    if isinstance(outs[0], list):
        return [x for o in outs for x in o]
    return np.concatenate(outs, axis=0)


def _orientations(grad_mag, grad_ori, y, x, sigma_oct, delta):
    """Chunked driver for :func:`_orientations_impl` (bounds peak memory on
    large keypoint sets)."""
    n = len(y)
    if n == 0:
        return []
    r = int(round(3 * LAMBDA_ORI * float(np.max(sigma_oct))))
    return _chunked(
        lambda yy, xx, ss: _orientations_impl(grad_mag, grad_ori, yy, xx, ss),
        n, 8_000_000, (2 * r + 1) ** 2, y, x, np.asarray(sigma_oct))


def _orientations_impl(grad_mag, grad_ori, y, x, sigma_oct):
    """Principal orientations of keypoints from a 36-bin gradient histogram
    (IPOL: 3*lambda_ori*sigma window, 6x circular box smoothing, 0.8 gate,
    parabolic bin refinement).  Batched over keypoints: one shared patch
    radius (the per-octave max), per-keypoint gaussian weights.
    Returns a list of arrays of angles per kp."""
    n = len(y)
    r = int(round(3 * LAMBDA_ORI * float(np.max(sigma_oct))))
    m, yy, xx, inb = _extract_patches(grad_mag, np.rint(y), np.rint(x), r)
    o = _extract_patches(grad_ori, np.rint(y), np.rint(x), r)[0]

    d2 = ((yy - y[:, None, None]) ** 2 + (xx - x[:, None, None]) ** 2)
    sig = np.asarray(sigma_oct)[:, None, None]
    w = np.exp(-d2 / (2 * (LAMBDA_ORI * sig) ** 2)) * m
    # per-keypoint square window of half-width 3*lambda_ori*sigma
    win = np.maximum(np.abs(yy - np.rint(y)[:, None, None]),
                     np.abs(xx - np.rint(x)[:, None, None]))
    w = np.where((win <= np.rint(3 * LAMBDA_ORI * sig)) & inb, w, 0.0)

    bins = np.rint(N_BINS / (2 * np.pi) * (o % (2 * np.pi))) \
        .astype(np.int64) % N_BINS
    flat = (np.arange(n)[:, None, None] * N_BINS + bins).ravel()
    hist = np.bincount(flat, weights=w.ravel(),
                       minlength=n * N_BINS).reshape(n, N_BINS)
    for _ in range(6):
        hist = (np.roll(hist, 1, axis=1) + hist
                + np.roll(hist, -1, axis=1)) / 3.0

    mx = hist.max(axis=1, keepdims=True)
    hp = np.roll(hist, 1, axis=1)
    hn = np.roll(hist, -1, axis=1)
    peak = (hist > hp) & (hist > hn) & (hist >= 0.8 * mx) & (mx > 0)
    den = hp + hn - 2 * hist
    with np.errstate(divide='ignore', invalid='ignore'):
        db = np.where(den != 0, (hp - hn) / (2 * den), 0.0)
    theta = 2 * np.pi * (np.arange(N_BINS)[None, :] + 0.5 + db) / N_BINS
    theta = np.where(theta <= np.pi, theta, theta - 2 * np.pi)

    out = []
    for i in range(n):
        out.append(theta[i][peak[i]])
    return out


def _descriptors_batch(grad_mag, grad_ori, yc, xc, sigma, theta):
    """Chunked driver for the host descriptor stage."""
    n = len(yc)
    if n == 0:
        return np.zeros((0, 128), dtype=np.float32)
    lim_win = LAMBDA_DESCR * (N_HIST + 1.0) / N_HIST
    r = int(math.ceil(lim_win * float(np.max(sigma)) * math.sqrt(2.0)))
    return _chunked(
        lambda a, b, c, d: _descriptors_batch_impl(grad_mag, grad_ori, a, b,
                                                   c, d),
        n, 8_000_000, (2 * r + 1) ** 2, np.asarray(yc), np.asarray(xc),
        np.asarray(sigma), np.asarray(theta))


def _descriptors_batch_impl(grad_mag, grad_ori, yc, xc, sigma, theta):
    """Batched 128-d SIFT descriptors (4x4x8, trilinear, 0.2 clip, 512
    quantization) for n (keypoint, orientation) jobs sharing one gradient
    field.  One scatter-add over all samples of all jobs."""
    n = len(yc)
    if n == 0:
        return np.zeros((0, 128), dtype=np.float32)
    lam = LAMBDA_DESCR
    lim_win = lam * (N_HIST + 1.0) / N_HIST
    r = int(math.ceil(lim_win * float(np.max(sigma)) * math.sqrt(2.0)))

    m, yy, xx, inb = _extract_patches(grad_mag, np.rint(yc), np.rint(xc), r)
    o = _extract_patches(grad_ori, np.rint(yc), np.rint(xc), r)[0]

    dy = (yy - yc[:, None, None])      # along rows ('x' in the IPOL frame)
    dx = (xx - xc[:, None, None])      # along cols ('y' in the IPOL frame)
    ct = np.cos(theta)[:, None, None]
    st = np.sin(theta)[:, None, None]
    sig = np.asarray(sigma)[:, None, None]
    u = (ct * dy + st * dx) / sig
    v = (-st * dy + ct * dx) / sig

    sel = (np.abs(u) < lim_win) & (np.abs(v) < lim_win) & inb
    # flatten to the selected samples only: the rotated support covers about
    # half of the gathered square patch
    kp_idx = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None, None],
                             u.shape)[sel]
    m = m[sel]
    o = o[sel]
    u = u[sel]
    v = v[sel]
    w = m * np.exp(-(u * u + v * v) / (2 * lam * lam))
    ang = (o - np.asarray(theta, np.float32)[kp_idx]) % (2 * np.pi)

    cu = (u + lam) * N_HIST / (2 * lam) - 0.5
    cv = (v + lam) * N_HIST / (2 * lam) - 0.5
    co = ang * N_ORI / (2 * np.pi)
    iu0 = np.floor(cu).astype(np.int64)
    iv0 = np.floor(cv).astype(np.int64)
    io0 = np.floor(co).astype(np.int64)
    fu = (cu - iu0).astype(np.float64)
    fv = (cv - iv0).astype(np.float64)
    fo = (co - io0).astype(np.float64)

    desc = np.zeros(n * N_HIST * N_HIST * N_ORI)
    for du, wu in ((0, 1 - fu), (1, fu)):
        uu = iu0 + du
        mu = (uu >= 0) & (uu < N_HIST)
        for dv, wv in ((0, 1 - fv), (1, fv)):
            vv = iv0 + dv
            mv = mu & (vv >= 0) & (vv < N_HIST)
            for do, wo in ((0, 1 - fo), (1, fo)):
                oo = (io0 + do) % N_ORI
                # IPOL flattening order: (u-cell, v-cell, orientation)
                flat = ((kp_idx * N_HIST + uu) * N_HIST + vv) * N_ORI + oo
                wgt = (w * wu * wv * wo)[mv]
                desc += np.bincount(flat[mv], weights=wgt,
                                    minlength=len(desc))

    desc = desc.reshape(n, 128)
    nrm = np.linalg.norm(desc, axis=1, keepdims=True)
    desc = np.minimum(desc, 0.2 * nrm)
    nrm2 = np.linalg.norm(desc, axis=1, keepdims=True)
    with np.errstate(invalid='ignore', divide='ignore'):
        q = np.minimum(np.floor(512.0 * desc / nrm2), 255.0)
    q[~np.isfinite(q)] = 0.0
    return q.astype(np.float32)


def _describe_group_host(grp):
    """Host orientation + descriptor stages for one (octave, scale) group:
    returns (job_kp indices, job_theta, desc (m, 128))."""
    v = grp['g']
    gy = np.zeros_like(v)      # d/d(row)
    gx = np.zeros_like(v)      # d/d(col)
    gy[1:-1, :] = 0.5 * (v[2:, :] - v[:-2, :])
    gx[:, 1:-1] = 0.5 * (v[:, 2:] - v[:, :-2])
    gmag = np.hypot(gx, gy)
    # IPOL axis convention: the first image axis is 'x' (rows), so the
    # reference orientation is atan2(d/dcol, d/drow)
    gori = np.arctan2(gx, gy)

    ys, xs, sigma_oct = grp['ys'], grp['xs'], grp['sigma_oct']
    oris = _orientations(gmag, gori, ys, xs, sigma_oct, grp['delta'])
    job_kp = np.array([i for i, a in enumerate(oris) for _ in a],
                      dtype=np.int64)
    job_theta = np.array([t for a in oris for t in a], dtype=np.float64)
    if len(job_kp) == 0:
        return job_kp, job_theta, np.zeros((0, 128), np.float32)
    descs = _descriptors_batch(gmag, gori, ys[job_kp], xs[job_kp],
                               sigma_oct[job_kp], job_theta)
    return job_kp, job_theta, descs



def keypoints_from_array(arr, thresh_dog=0.0133, n_octaves=8, n_scales=3,
                         offset=None):
    """SIFT keypoints and descriptors of a 2D array on the host: (n, 132)
    float32 rows (x, y, scale, orientation, descriptor), the contract of
    the reference's ctypes wrapper."""
    arr = np.asarray(arr, dtype=np.float32)
    octaves = _build_scale_space(arr, n_octaves, n_scales)

    groups = []
    for (g, dog, delta) in octaves:
        dog_np = np.asarray(dog)
        # pre-filter weak extrema before interpolation (IPOL 0.8 * C_DoG)
        mask = (np.asarray(_extrema_mask(dog))
                & (np.abs(dog_np) >= 0.8 * thresh_dog))
        cand = np.argwhere(mask)
        if len(cand) == 0:
            continue
        pos, off, val = _refine_candidates(dog_np, cand, thresh_dog)
        if len(pos) == 0:
            continue

        g_np = np.asarray(g)
        for s_idx in range(1, n_scales + 1 + 1):
            sel = pos[:, 0] == s_idx
            if not sel.any():
                continue
            ys = pos[sel, 1] + off[sel, 1]
            xs = pos[sel, 2] + off[sel, 2]
            ss = pos[sel, 0] + off[sel, 0]
            sigma = delta / DELTA_MIN * SIGMA_MIN * 2.0 ** (ss / n_scales)
            groups.append(dict(g=g_np[s_idx], delta=delta, ys=ys, xs=xs,
                               sigma=sigma, sigma_oct=sigma / delta))

    described = [_describe_group_host(grp) for grp in groups]

    rows = []
    for grp, (job_kp, job_theta, descs) in zip(groups, described):
        if len(job_kp) == 0:
            continue
        heads = np.column_stack([grp['xs'][job_kp] * grp['delta'],
                                 grp['ys'][job_kp] * grp['delta'],
                                 grp['sigma'][job_kp], job_theta])
        rows.append(np.hstack([heads, descs]))

    if not rows:
        return np.zeros((0, 132), dtype=np.float32)
    kp = np.vstack(rows).astype(np.float32)
    if offset is not None:
        kp[:, 0] += offset[0]
        kp[:, 1] += offset[1]
    return kp
