"""SIFT detection, matching and stage 1's drivers.

The port's counterpart of ``s2p_tpu/ops/sift.py``, with its two routes,
chosen by :func:`set_device_mode` (``cfg.sift_device``, set by
``pipeline.main``):

  * the device route ('auto' and 'device'; the route a TPU always takes):
    detection is :mod:`s2p_tpu_torch.ops.sift_device`, the match is one
    torch function on the device, the RANSAC filter host numpy, and stage
    1 runs as waves over all tile pairs (:func:`matches_on_rpc_roi_batch`);
  * the host route ('host'): the JAX package's numpy and scipy detection
    (:mod:`s2p_tpu_torch.ops.sift_host`), the match's distances by numpy,
    and stage 1 pair by pair (:func:`_matches_on_rpc_roi_independent`).
    It never touches a device.

IPOL "Anatomy of the SIFT Method" (Rey-Otero & Delbracio) parameters, the
reference s2p's ``sift.py`` contract: rows of (x, y, scale, orientation,
128-descriptor), raw-intensity DoG threshold 0.0133, 8 octaves, 3 scales
per octave.

Descriptors are integers from 0 to 255, so every squared distance of the
match is an integer below 2^24: float32 holds it exactly in any summation
order, and the match equals the JAX package's given the same keypoints.
"""

from __future__ import annotations

import concurrent.futures
import math
import warnings

import numpy as np
import torch

from ..device import resolve
from . import sift_host
# the IPOL reference parameters and the sampled gaussian
from .sift_host import (C_EDGE, DELTA_MIN, LAMBDA_DESCR, LAMBDA_ORI,  # noqa
                        N_BINS, N_HIST, N_ORI, N_SPO, SIGMA_IN, SIGMA_MIN,
                        _gauss_kernel)

_MATCH_ROWS = 2048    # query rows per block of the distance matrix
_MATCH_JOBS = 64      # tile pairs per detection + match wave


def _hist_peaks(hist):
    """Orientation angles from smoothed 36-bin histograms (host, tiny):
    local maxima >= 0.8 * max, parabolic bin refinement."""
    n = len(hist)
    mx = hist.max(axis=1, keepdims=True)
    hp = np.roll(hist, 1, axis=1)
    hn = np.roll(hist, -1, axis=1)
    peak = (hist > hp) & (hist > hn) & (hist >= 0.8 * mx) & (mx > 0)
    den = hp + hn - 2 * hist
    with np.errstate(divide='ignore', invalid='ignore'):
        db = np.where(den != 0, (hp - hn) / (2 * den), 0.0)
    theta = 2 * np.pi * (np.arange(N_BINS)[None, :] + 0.5 + db) / N_BINS
    theta = np.where(theta <= np.pi, theta, theta - 2 * np.pi)
    return [theta[i][peak[i]] for i in range(n)]


# --------------------------------------------------------------------- #
# Matching
# --------------------------------------------------------------------- #

def _match_kernel_split(meta1, d1, meta2, d2, fc, gate):
    """Nearest and second-nearest descriptor distances with the epipolar
    gate applied inside the search (the reference C matcher's contract),
    on the device: ``_match_kernel_split_jit`` of the JAX package.

    meta*: (n, 4) [x, y, scale, theta] and d*: (n, 128) float32 tensors;
    fc: the 5 affine-F coefficients (float32 tensor), gate: compared in
    float32.  The distance matrix is built in blocks of _MATCH_ROWS query
    rows.
    Returns an (n1, 3) float32 tensor [nn, best, second]; a row whose
    candidates are all gated gets nn 0 and inf distances, as ``argmin``
    over infs gives."""
    n2 = d2.shape[0]
    cols = torch.arange(n2, device=d2.device)
    gate = float(np.float32(gate))
    sq2 = torch.sum(d2 * d2, dim=1)[None, :]
    lin2 = fc[0] * meta2[None, :, 0] + fc[1] * meta2[None, :, 1]
    big = float('inf')
    outs = []
    for r in range(0, d1.shape[0], _MATCH_ROWS):
        a, m1 = d1[r:r + _MATCH_ROWS], meta1[r:r + _MATCH_ROWS]
        sq = (torch.sum(a * a, dim=1)[:, None] + sq2
              - 2.0 * torch.matmul(a, d2.T))
        sq = torch.clamp_min(sq, 0.0)
        lin = lin2 + (fc[2] * m1[:, 0] + fc[3] * m1[:, 1] + fc[4])[:, None]
        sq = torch.where(lin.abs() > gate, big, sq)
        best = sq.min(dim=1).values
        # the lowest index among the minima, as argmin
        nn = torch.where(sq == best[:, None], cols, n2).min(dim=1).values
        second = torch.where(cols == nn[:, None], big, sq).min(dim=1).values
        outs.append(torch.stack([nn.float(), best, second], dim=1))
    return torch.cat(outs)


def _epipolar_gate(F, epipolar_threshold):
    """The affine F's 5 coefficients (float32) and the gate on |line|."""
    Fm = np.asarray(F, dtype=np.float64)
    fc = np.array([Fm[0, 2], Fm[1, 2], Fm[2, 0], Fm[2, 1], Fm[2, 2]],
                  dtype=np.float32)
    return fc, float(epipolar_threshold * math.hypot(fc[0], fc[1]))


def _match_device(k1, k2, fc, gate, device):
    """The match of two host keypoint arrays (n, 132) on ``device``:
    (nn int64, best, second) on the host."""
    dev = resolve(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    out = _match_kernel_split(up(k1[:, :4]), up(k1[:, 4:]), up(k2[:, :4]),
                              up(k2[:, 4:]), up(fc), gate).cpu().numpy()
    return out[:, 0].astype(np.int64), out[:, 1], out[:, 2]


# --------------------------------------------------------------------- #
# The route: 'auto' (the card), 'device' or 'host'
# --------------------------------------------------------------------- #

_DEVICE_MODE = 'auto'


def set_device_mode(mode: str):
    """Select SIFT's route ('auto' | 'device' | 'host'); 'auto' is the
    device route."""
    global _DEVICE_MODE
    if mode not in ('auto', 'device', 'host'):
        raise ValueError(f'unknown sift_device mode {mode!r}')
    _DEVICE_MODE = mode


def _use_device_sift():
    return _DEVICE_MODE != 'host'


def keypoints_from_array(arr, thresh_dog=0.0133, n_octaves=8, n_scales=3,
                         offset=None, device=None):
    """SIFT keypoints and descriptors of a 2D array: (n, 132) float32 rows
    (x, y, scale, orientation, descriptor), the contract of the reference's
    ctypes wrapper.  The device route runs on ``device`` (None: CUDA), the
    host route (:mod:`sift_host`) in numpy."""
    if not _use_device_sift():
        return sift_host.keypoints_from_array(arr, thresh_dog, n_octaves,
                                              n_scales, offset)
    from .sift_device import keypoints_from_array as on_device
    return on_device(arr, thresh_dog, n_octaves, n_scales, offset,
                     device=device)


def image_keypoints(img, x, y, w, h, max_nb=None, thresh_dog=0.0133,
                    n_octaves=8, n_scales=3, device=None):
    """Keypoints of a window of a (full) image array, the ROI clipped to
    the image (the reference's contract)."""
    img = np.asarray(img)
    x, y, w, h = _clip_roi(img, x, y, w, h)
    kp = keypoints_from_array(img[y:y + h, x:x + w], thresh_dog, n_octaves,
                              n_scales, offset=(x, y), device=device)
    if max_nb is not None:
        kp = kp[:max_nb]
    return kp


def keypoints_match(k1, k2, method='relative', sift_thresh=0.6, F=None,
                    epipolar_threshold=10, model=None, ransac_max_err=0.3,
                    device=None):
    """Match two keypoint sets: epipolar-gated nearest neighbour with the
    ratio (``method='relative'``) or absolute test, then, with
    ``model='fundamental'``, the RANSAC fundamental-matrix inlier filter.
    The distances are one matrix product on ``device`` (None: CUDA), or
    numpy's on the host route."""
    k1 = np.asarray(k1, dtype=np.float32)
    k2 = np.asarray(k2, dtype=np.float32)
    if len(k1) == 0 or len(k2) == 0:
        return np.zeros((0, 4), dtype=np.float32)
    if F is not None:
        fc, gate = _epipolar_gate(F, epipolar_threshold)
    else:
        fc, gate = np.zeros(5, dtype=np.float32), float('inf')
    if _use_device_sift():
        nn, best, second = _match_device(k1, k2, fc, gate, device)
    else:
        nn, best, second = _match_host(k1, k2, fc, gate, F is not None)
    return _match_finish(k1, k2, nn, best, second, method, sift_thresh,
                         ransac_max_err, ransac=model == 'fundamental')


def _match_host(k1, k2, fc, gate, gated):
    """The match's distances by numpy (the JAX package's host branch):
    (nn int64, best, second)."""
    d1 = k1[:, 4:]
    d2 = k2[:, 4:]
    sq = (np.einsum('ij,ij->i', d1, d1)[:, None]
          + np.einsum('ij,ij->i', d2, d2)[None, :] - 2.0 * (d1 @ d2.T))
    np.maximum(sq, 0.0, out=sq)
    if gated:
        lin = (fc[0] * k2[None, :, 0] + fc[1] * k2[None, :, 1]
               + (fc[2] * k1[:, 0] + fc[3] * k1[:, 1] + fc[4])[:, None])
        sq[np.abs(lin) > gate] = np.inf
    nn = np.argmin(sq, axis=1)
    best = sq[np.arange(len(sq)), nn]
    sq[np.arange(len(sq)), nn] = np.inf
    second = np.min(sq, axis=1)
    return nn, best, second


def _eight_point(sub):
    """Normalized 8-point fundamental matrix of (k, 4) matches, rank 2."""
    a = sub[:, 0:2]
    b = sub[:, 2:4]

    def normalize(p):
        c = p.mean(axis=0)
        s = np.sqrt(2) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        return (p - c) * s, T

    an, Ta = normalize(a)
    bn, Tb = normalize(b)
    X = np.column_stack([
        bn[:, 0] * an[:, 0], bn[:, 0] * an[:, 1], bn[:, 0],
        bn[:, 1] * an[:, 0], bn[:, 1] * an[:, 1], bn[:, 1],
        an[:, 0], an[:, 1], np.ones(len(sub))])
    f = np.linalg.svd(X)[2][-1].reshape(3, 3)
    U, S, Vt = np.linalg.svd(f)
    f = U @ np.diag([S[0], S[1], 0.0]) @ Vt
    return Tb.T @ f @ Ta


def _ransac_inliers(m, ntrials=1000, max_err=0.3, seed=0):
    """RANSAC's best consensus on (n, 4) float64 matches: (inlier mask,
    inlier count).  The symmetric epipolar distance of every match under
    each trial's 8-point model, ``max_err`` px at most."""
    n = len(m)
    rng = np.random.RandomState(seed)
    p1 = np.column_stack([m[:, 0:2], np.ones(n)])
    p2 = np.column_stack([m[:, 2:4], np.ones(n)])

    def epi_errors(F):
        l2 = p1 @ F.T          # lines in image 2
        l1 = p2 @ F            # lines in image 1
        num = np.abs(np.sum(p2 * l2, axis=1))
        d2 = num / np.hypot(l2[:, 0], l2[:, 1])
        d1 = num / np.hypot(l1[:, 0], l1[:, 1])
        return np.maximum(d1, d2)

    # draw every trial's subset with the EXACT RandomState consumption of
    # the original per-trial loop (bitwise-stable inlier sets), then solve
    # all eight-point problems as one batched LAPACK call -- the Python
    # loop of 1000 small SVDs was ~0.25 s per pair (stage-1 probe)
    k = min(8, n)
    subs_idx = np.stack([rng.choice(n, size=k, replace=False)
                         for _ in range(ntrials)])
    try:
        a = m[subs_idx][:, :, 0:2]                     # (T, k, 2)
        b = m[subs_idx][:, :, 2:4]

        def normalize_b(p):
            c = p.mean(axis=1, keepdims=True)          # (T, 1, 2)
            d = np.linalg.norm(p - c, axis=2).mean(axis=1)
            s = np.sqrt(2) / np.maximum(d, 1e-12)      # (T,)
            return (p - c) * s[:, None, None], c[:, 0], s

        an, ca, sa = normalize_b(a)
        bn, cb, sb = normalize_b(b)
        one = np.ones((ntrials, k))
        X = np.stack([
            bn[:, :, 0] * an[:, :, 0], bn[:, :, 0] * an[:, :, 1],
            bn[:, :, 0],
            bn[:, :, 1] * an[:, :, 0], bn[:, :, 1] * an[:, :, 1],
            bn[:, :, 1],
            an[:, :, 0], an[:, :, 1], one], axis=2)    # (T, k, 9)
        f = np.linalg.svd(X)[2][:, -1].reshape(ntrials, 3, 3)
        U, S, Vt = np.linalg.svd(f)
        S = S.copy()
        S[:, 2] = 0.0
        f = U * S[:, None, :] @ Vt                     # rank-2 projection
        Ta = np.zeros((ntrials, 3, 3))
        Tb = np.zeros((ntrials, 3, 3))
        for T_, c, s in ((Ta, ca, sa), (Tb, cb, sb)):
            T_[:, 0, 0] = s
            T_[:, 1, 1] = s
            T_[:, 0, 2] = -s * c[:, 0]
            T_[:, 1, 2] = -s * c[:, 1]
            T_[:, 2, 2] = 1.0
        Fs = np.transpose(Tb, (0, 2, 1)) @ f @ Ta      # (T, 3, 3)

        l2 = np.einsum('nj,tij->tni', p1, Fs)          # p1 @ F.T per trial
        l1 = np.einsum('nj,tji->tni', p2, Fs)          # p2 @ F per trial
        num = np.abs(np.einsum('nj,tnj->tn', p2, l2))
        d2 = num / np.hypot(l2[:, :, 0], l2[:, :, 1])
        d1 = num / np.hypot(l1[:, :, 0], l1[:, :, 1])
        with np.errstate(invalid='ignore'):
            inls = np.maximum(d1, d2) < max_err        # (T, n)
        counts = inls.sum(axis=1)
        best_t = int(np.argmax(counts))                # first max, like the
        best_count = int(counts[best_t])               # loop's strict '>'
        best_inl = inls[best_t]
    except np.linalg.LinAlgError:
        # rare degenerate batch: fall back to the per-trial loop
        best_count = -1
        best_inl = np.zeros(n, dtype=bool)
        for t in range(ntrials):
            try:
                F = _eight_point(m[subs_idx[t]])
            except np.linalg.LinAlgError:
                continue
            inl = epi_errors(F) < max_err
            cnt = int(inl.sum())
            if cnt > best_count:
                best_count = cnt
                best_inl = inl
    return best_inl, best_count


def ransac_fundamental_matrix(matches, ntrials=1000, max_err=0.3, seed=0):
    """RANSAC F-matrix inlier search (replaces the pip ``ransac`` package
    of the reference s2p): normalized 8-point minimal solver, symmetric
    epipolar distance, best-consensus model refit on the inliers.  The
    JAX package's function, split in two: :func:`_ransac_inliers` and the
    refit, which stage 1 does not need."""
    m = np.asarray(matches, dtype=np.float64)
    best_inl, best_count = _ransac_inliers(m, ntrials, max_err, seed)
    F = _eight_point(m[best_inl]) if best_count >= 8 else None
    return np.where(best_inl)[0], F


def _clip_roi(img, x, y, w, h):
    """Clip an ROI to the image extent (the image_keypoints contract)."""
    if x < 0:
        w += x
        x = 0
    if y < 0:
        h += y
        y = 0
    w = min(w, img.shape[1] - x)
    h = min(h, img.shape[0] - y)
    return int(x), int(y), int(w), int(h)


def _match_finish(k1, k2, nn, best, second, method, sift_thresh,
                  ransac_max_err=0.3, ransac=True):
    """Host tail of the match: ratio/absolute test + RANSAC's inliers
    (from 7 matches)."""
    if method == 'relative':
        ok = np.sqrt(best) < sift_thresh * np.sqrt(second)
    else:
        ok = np.sqrt(best) < sift_thresh
    ok &= np.isfinite(best)
    matches = np.column_stack([k1[ok, 0], k1[ok, 1],
                               k2[nn[ok], 0], k2[nn[ok], 1]]) \
        .astype(np.float32)
    if ransac and len(matches) >= 7:
        # the inliers alone: the refit F is not used here
        inliers, _ = _ransac_inliers(np.asarray(matches, dtype=np.float64),
                                     ntrials=1000, max_err=ransac_max_err)
        matches = matches[np.where(inliers)[0]]
    return matches


# --------------------------------------------------------------------- #
# Stage 1's batch driver
# --------------------------------------------------------------------- #

def matches_on_rpc_roi_batch(jobs, device=None, stats=None):
    """Stage 1: SIFT matches for MANY (tile, pair) jobs, breadth-first:
    one multi-crop detection wave
    (:func:`s2p_tpu_torch.ops.sift_device.keypoints_from_arrays`, the
    descriptors left on the device), one match wave, then the host
    RANSAC fan-out on threads, in chunks of _MATCH_JOBS jobs.  The
    DoG-threshold halving retry (the reference's sift.py) re-enters the
    wave with only the failed jobs.

    Args:
        jobs: list of dicts with keys im1, im2, rpc1, rpc2, x, y, w, h,
            method, sift_thresh, epipolar_threshold, alt_kwargs.
        device: None runs on CUDA and raises without it; "cpu" runs there.
        stats: a dict that, when given, receives the seconds of the
            parts (keys 'detection', 'match', 'ransac' and the detection's
            'pyramid', 'orientation', 'descriptor'), summed over chunks
            and retries, the device synchronised at each boundary; and
            under 'keypoints', per job index, the keypoint counts of its
            two crops at its last attempt.

    Returns:
        list of (n, 4) match arrays (None where no matches were found).
    """
    from ..core import estimation, rpc_geom

    dev = resolve(device)
    metas = []
    for j in jobs:
        x, y, w, h = j['x'], j['y'], j['w'], j['h']
        kw = j.get('alt_kwargs', {})
        x2, y2, w2, h2 = rpc_geom.corresponding_roi(
            j['rpc1'], j['rpc2'], x, y, w, h, **kw)
        rpc_matches = rpc_geom.matches_from_rpc(
            j['rpc1'], j['rpc2'], x, y, w, h, 5, **kw)
        F = estimation.affine_fundamental_matrix(rpc_matches)
        roi1 = _clip_roi(j['im1'], x, y, w, h)
        roi2 = _clip_roi(j['im2'], x2, y2, w2, h2)
        metas.append(dict(F=F, roi1=roi1, roi2=roi2))

    results = [None] * len(jobs)
    pending = list(range(len(jobs)))
    thresh_dog = {k: 0.0133 for k in pending}
    for _ in range(2):
        if not pending:
            break
        finished = {}
        for c0 in range(0, len(pending), _MATCH_JOBS):
            _run_match_chunk(jobs, metas, pending[c0:c0 + _MATCH_JOBS],
                             thresh_dog, finished, dev, stats)
        still = []
        for k in pending:
            m = finished[k]
            if m is not None and m.ndim == 2 and m.shape[0] > 10:
                results[k] = m
            else:
                thresh_dog[k] /= 2.0
                still.append(k)
        pending = still

    if pending:
        warnings.warn('sift.matches_on_rpc_roi_batch: found no matches for '
                      f'{len(pending)} tile pair(s)')
    return results


def _run_match_chunk(jobs, metas, chunk, thresh_dog, finished, device,
                     stats):
    """One detection + match + RANSAC wave over a chunk of pending jobs;
    fills ``finished[k]`` per job."""
    from .sift_device import _Clock, keypoints_from_arrays

    clock = _Clock(device, stats)
    crops, offs, ths = [], [], []
    for k in chunk:
        for img, (x, y, w, h) in ((jobs[k]['im1'], metas[k]['roi1']),
                                  (jobs[k]['im2'], metas[k]['roi2'])):
            crops.append(np.ascontiguousarray(
                img[y:y + h, x:x + w], dtype=np.float32))
            offs.append((x, y))
            ths.append(thresh_dog[k])
    kps = keypoints_from_arrays(crops, ths, offs, device_desc=True,
                                device=device, timings=stats)
    clock.tick('detection')
    if stats is not None:
        counts = stats.setdefault('keypoints', {})
        for idx, k in enumerate(chunk):
            counts[k] = (kps[2 * idx]['count'], kps[2 * idx + 1]['count'])

    def up(a):
        return torch.from_numpy(a).to(device)

    outs = []
    for idx, k in enumerate(chunk):
        m1, m2 = kps[2 * idx], kps[2 * idx + 1]
        if m1['count'] == 0 or m2['count'] == 0:
            outs.append(None)
            continue
        fc, gate = _epipolar_gate(metas[k]['F'],
                                  jobs[k]['epipolar_threshold'])
        outs.append(_match_kernel_split(up(m1['meta']), m1['desc'],
                                        up(m2['meta']), m2['desc'], up(fc),
                                        gate))
    # one copy of every pair's (n1, 3) rows to the host
    live = [o for o in outs if o is not None]
    flat = torch.cat(live).cpu().numpy() if live else None
    host, r = [], 0
    for o in outs:
        host.append(None if o is None else flat[r:r + len(o)])
        r += 0 if o is None else len(o)
    clock.tick('match')

    todo = []
    for idx, (k, out) in enumerate(zip(chunk, host)):
        if out is None:
            finished[k] = np.zeros((0, 4), np.float32)
            continue
        todo.append((k, kps[2 * idx]['meta'], kps[2 * idx + 1]['meta'], out))
    # RANSAC is host numpy; its LAPACK calls release the interpreter lock,
    # so the pairs run on threads
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, max(1, len(todo)))) as ex:
        for k, m in zip((t[0] for t in todo), ex.map(
                lambda t: _match_finish(
                    t[1], t[2], t[3][:, 0].astype(np.int64), t[3][:, 1],
                    t[3][:, 2], jobs[t[0]]['method'],
                    jobs[t[0]]['sift_thresh']), todo)):
            finished[k] = m
    clock.tick('ransac')


def matches_on_rpc_roi(im1, im2, rpc1, rpc2, x, y, w, h, method='relative',
                       sift_thresh=0.6, epipolar_threshold=10, device=None,
                       **alt_kwargs):
    """SIFT matches between two full images over an ROI of the first
    (corresponding ROI via the RPCs, affine-F gate, DoG-threshold halving
    retry, RANSAC): :func:`matches_on_rpc_roi_batch` of one job on the
    device route, :func:`_matches_on_rpc_roi_independent` on the host
    route."""
    if not _use_device_sift():
        return _matches_on_rpc_roi_independent(
            im1, im2, rpc1, rpc2, x, y, w, h, method, sift_thresh,
            epipolar_threshold, **alt_kwargs)
    return matches_on_rpc_roi_batch([dict(
        im1=im1, im2=im2, rpc1=rpc1, rpc2=rpc2, x=x, y=y, w=w, h=h,
        method=method, sift_thresh=sift_thresh,
        epipolar_threshold=epipolar_threshold, alt_kwargs=alt_kwargs)],
        device=device)[0]


def _matches_on_rpc_roi_independent(im1, im2, rpc1, rpc2, x, y, w, h,
                                    method='relative', sift_thresh=0.6,
                                    epipolar_threshold=10, device=None,
                                    **alt_kwargs):
    """The per-pair flow (the crops' detections one after the other,
    :func:`keypoints_match`, the DoG-threshold halving retry): the host
    route of :func:`matches_on_rpc_roi`, an implementation independent of
    the batch driver."""
    from ..core import estimation, rpc_geom

    x2, y2, w2, h2 = rpc_geom.corresponding_roi(rpc1, rpc2, x, y, w, h,
                                                **alt_kwargs)
    rpc_matches = rpc_geom.matches_from_rpc(rpc1, rpc2, x, y, w, h, 5,
                                            **alt_kwargs)
    F = estimation.affine_fundamental_matrix(rpc_matches)

    thresh_dog = 0.0133
    for _ in range(2):
        p1 = image_keypoints(im1, x, y, w, h, thresh_dog=thresh_dog,
                             device=device)
        p2 = image_keypoints(im2, x2, y2, w2, h2, thresh_dog=thresh_dog,
                             device=device)
        matches = keypoints_match(p1, p2, method, sift_thresh, F,
                                  epipolar_threshold=epipolar_threshold,
                                  model='fundamental', device=device)
        if matches is not None and matches.ndim == 2 \
                and matches.shape[0] > 10:
            return matches
        thresh_dog /= 2.0
    warnings.warn('sift.matches_on_rpc_roi: found no matches')
    return None
