"""The port's SIFT match (``s2p_tpu_torch/ops/sift.py``, device="cpu")
against the JAX package's device route, given the same keypoints: the
JAX package's own, detected on two overlapping crops of seeded smoothed
noise.

Descriptors are integers from 0 to 255, so every squared distance is an
integer below 2^24 and exact in float32 in any summation order; the
epipolar line is evaluated in the JAX package's order.  So the match's
outputs (nearest index, best and second-best distances) and the matches
after the ratio test and RANSAC must be equal, bitwise; so must the
seeded RANSAC on its own.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from s2p_tpu.ops import sift as jsift
from s2p_tpu.ops import sift_tpu as jst
from s2p_tpu_torch.ops import sift as tsift
from test_torch_sift import one_thread  # noqa: F401 (autouse fixture)

# a horizontal epipolar geometry: the line of (x1, y1) is y2 = y1
F_ROWS = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
SHIFT = (5, 3)          # crop 2 starts 5 px right and 3 px below crop 1


@pytest.fixture(scope='module')
def keypoints():
    """The JAX package's keypoints of two overlapping 200 x 200 crops, in
    image coordinates; the second set gets 40 duplicated rows at its end,
    so that the nearest neighbour ties."""
    rng = np.random.RandomState(5)
    img = ndimage.gaussian_filter(rng.rand(300, 300) * 255, 1.5) \
        .astype(np.float32)
    dx, dy = SHIFT
    crops = [np.ascontiguousarray(img[20:220, 30:230]),
             np.ascontiguousarray(img[20 + dy:220 + dy, 30 + dx:230 + dx])]
    k1, k2 = jst.keypoints_from_arrays_tpu(crops, [0.0133] * 2,
                                           [(30, 20), (30 + dx, 20 + dy)])
    k2 = np.concatenate([k2, k2[::len(k2) // 40][:40]])
    return k1, k2


def _gate(F, thr=10):
    Fm = np.asarray(F, np.float64)
    fc = np.array([Fm[0, 2], Fm[1, 2], Fm[2, 0], Fm[2, 1], Fm[2, 2]],
                  np.float32)
    return fc, float(thr * np.hypot(fc[0], fc[1]))


def _jax_match(k1, k2, fc, gate, bucket=2048):
    """The JAX package's split match kernel on bucket-padded operands, as
    its batch driver calls it."""
    n1, n2 = len(k1), len(k2)
    N1, N2 = -(-n1 // bucket) * bucket, -(-n2 // bucket) * bucket
    pad = [np.zeros((N, k.shape[1]), np.float32) for N, k in
           ((N1, k1), (N2, k2))]
    pad[0][:n1], pad[1][:n2] = k1, k2
    out = jsift._match_kernel_split_jit()(
        pad[0][:, :4], pad[0][:, 4:], pad[1][:, :4], pad[1][:, 4:], n1, n2,
        fc, np.float32(gate))
    return np.asarray(out)[:n1]


@pytest.mark.parametrize('gated', [True, False])
def test_match_kernel_bitwise(keypoints, gated):
    k1, k2 = keypoints
    fc, gate = _gate(F_ROWS) if gated else (np.zeros(5, np.float32),
                                            float('inf'))
    want = _jax_match(k1, k2, fc, gate)
    t = torch.from_numpy
    got = tsift._match_kernel_split(
        t(k1[:, :4].copy()), t(k1[:, 4:].copy()), t(k2[:, :4].copy()),
        t(k2[:, 4:].copy()), t(fc), gate).numpy()
    assert np.array_equal(got, want)
    # the duplicated rows tie: the nearest is the lower index, the second
    # distance equals the best
    dup = np.isin(want[:, 0], np.arange(len(k2) - 40)) & (want[:, 2] ==
                                                          want[:, 1])
    assert dup.sum() >= 10
    if gated:     # the gate changes some rows' nearest neighbour
        free = _jax_match(k1, k2, np.zeros(5, np.float32), float('inf'))
        assert (free[:, 1] < want[:, 1]).any()


@pytest.mark.parametrize('method,thresh', [('relative', 0.6),
                                           ('absolute', 250.0)])
def test_keypoints_match_bitwise(keypoints, monkeypatch, method, thresh):
    k1, k2 = keypoints
    monkeypatch.setattr(jsift, '_DEVICE_MODE', 'device')
    want = jsift.keypoints_match(k1, k2, method, thresh, F_ROWS,
                                 epipolar_threshold=10, model='fundamental')
    got = tsift.keypoints_match(k1, k2, method, thresh, F_ROWS,
                                epipolar_threshold=10, model='fundamental',
                                device='cpu')
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(got) > 100
    plain = tsift.keypoints_match(k1, k2, method, thresh, F_ROWS,
                                  epipolar_threshold=10, device='cpu')
    assert len(plain) >= len(got)


@pytest.mark.parametrize('seed', [3, 4])
def test_ransac_bitwise(seed):
    rng = np.random.RandomState(seed)
    n = 120
    x1 = rng.uniform(0, 500, (n, 2))
    disp = rng.uniform(0, 10, n)
    matches = np.column_stack([x1, x1[:, 0] + disp, x1[:, 1]])
    bad = rng.choice(n, 25, replace=False)
    matches[bad, 3] += rng.uniform(5, 30, 25) * rng.choice([-1, 1], 25)
    want = jsift.ransac_fundamental_matrix(matches, ntrials=300,
                                           max_err=0.3)
    got = tsift.ransac_fundamental_matrix(matches, ntrials=300, max_err=0.3)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert len(set(got[0]) & set(bad)) <= 3 and len(got[0]) >= 80


def test_match_finish_and_clip_roi_equal():
    rng = np.random.RandomState(9)
    k1 = rng.rand(50, 132).astype(np.float32) * 100
    k2 = rng.rand(60, 132).astype(np.float32) * 100
    nn = rng.randint(0, 60, 50)
    best = rng.rand(50).astype(np.float32) * 10
    second = best + rng.rand(50).astype(np.float32) * 20
    best[3] = np.inf
    for method in ('relative', 'absolute'):
        assert np.array_equal(
            tsift._match_finish(k1, k2, nn, best, second, method, 0.6),
            jsift._match_finish(k1, k2, nn, best, second, method, 0.6))
    img = np.zeros((100, 120))
    for roi in ((-5, 10, 50, 50), (90, 80, 50, 50), (0, 0, 120, 100)):
        assert tsift._clip_roi(img, *roi) == jsift._clip_roi(img, *roi)


def test_constants_and_peaks_equal():
    for name in ('DELTA_MIN', 'SIGMA_MIN', 'SIGMA_IN', 'N_SPO', 'C_EDGE',
                 'LAMBDA_ORI', 'LAMBDA_DESCR', 'N_BINS', 'N_HIST', 'N_ORI'):
        assert getattr(tsift, name) == getattr(jsift, name)
    for sigma in (1.2, 1.6, 3.1):
        assert np.array_equal(tsift._gauss_kernel(sigma),
                              jsift._gauss_kernel(sigma))
    hist = np.random.RandomState(2).rand(30, 36).astype(np.float32)
    hist[4] = 0
    for a, b in zip(tsift._hist_peaks(hist), jsift._hist_peaks(hist)):
        assert np.array_equal(a, b)
