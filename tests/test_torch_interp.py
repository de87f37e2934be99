"""The port's resampling (``ops/interp.py``, the plain versions of W1, and
``ops/homography.py``) against the JAX package's on the CPU.

The JAX package's samplers run op by op under ``jax.disable_jit()``:
the port's plain versions repeat that float32 arithmetic and must equal
it bitwise, NaN set included.  Its jitted warp is another computation
(XLA's CPU compiler reorders and contracts the float32 expressions,
down to the source coordinates), so against it the values agree within
WARP_JIT_TOL and the NaN sets are equal away from source coordinates
next to an integer.
"""

import jax
import numpy as np
import pytest
import torch

from s2p_tpu.ops import homography as jhom
from s2p_tpu.ops import interp as jint
from s2p_tpu_torch.ops import homography as thom
from s2p_tpu_torch.ops import interp as tint

# the largest difference from the jitted JAX warp measured on the
# inputs of test_warp_homography_equal_jax (0-255 noise) is 0.0047 at
# order 1, 0.0052 at order 3 and 0.042 at order 5 (whose prefiltered
# coefficients span several times the image's range); a wrong weight or
# tap moves values by whole units
WARP_JIT_TOL = 0.1

ORDERS = (1, 3, 5)


def _same(a, b):
    """Bitwise equal, NaN-aware."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True), np.nanmax(np.abs(a - b))


def _image(seed, h=60, w=70, nan=True):
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w) * 255).astype(np.float32)
    if nan:
        img[10:13, 20:24] = np.nan
        img[0, :] = np.nan
    return img


def _coords(seed, h, w, n=3000):
    """Sample points inside, on and outside the image's edges."""
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-3, w + 2, n).astype(np.float32)
    ys = rng.uniform(-3, h + 2, n).astype(np.float32)
    xs[:8] = (0, w - 1, 1, w - 2, 0.5, -0.0, w - 1.5, 2)
    ys[:8] = (h - 1, 0, h - 2, 1, -0.5, 3, 0, h - 1)
    return xs, ys


def _homographies():
    return [np.array([[1.01, 0.02, -3.0], [-0.01, 0.99, 2.0], [0, 0, 1.0]]),
            np.array([[0.97, -0.03, 2.5], [0.02, 1.02, -0.8], [1e-4, -2e-4,
                                                              1.0]]),
            np.array([[0.5, 0.1, 4.0], [-0.1, 0.6, 3.0], [0, 0, 1.0]])]


def _near_integer_source(hinv, ow, oh, eps=1e-4):
    """Output pixels whose source coordinate (float64) lies within
    ``eps`` of an integer."""
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float64)
    m = hinv.astype(np.float64)
    z = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    near = np.zeros(xs.shape, bool)
    for r in (0, 1):
        v = (m[r, 0] * xs + m[r, 1] * ys + m[r, 2]) / z
        near |= np.abs(v - np.round(v)) < eps
    return near


@pytest.mark.parametrize('fill', [float('nan'), 0.0, -7.5],
                         ids=['nan', 'zero', 'neg'])
@pytest.mark.parametrize('kind', ['bilinear', 'bicubic', 'bspline5',
                                  'bspline5_mask'])
def test_samplers_equal_unjitted_jax(kind, fill):
    img = _image(0)
    h, w = img.shape
    xs, ys = _coords(1, h, w)
    t = torch.from_numpy
    if kind.startswith('bspline5'):
        coeffs, mask = jhom._spline5_inputs(img)
        m = mask if kind.endswith('mask') else None
        with jax.disable_jit():
            want = jint.bspline5_sample(coeffs, xs, ys, nanmask=m,
                                        fill_value=fill)
        got = tint.bspline5_sample(t(coeffs), t(xs), t(ys),
                                   nanmask=None if m is None else t(m),
                                   fill_value=fill)
    else:
        fn = {'bilinear': 'bilinear_sample', 'bicubic': 'bicubic_sample'}[kind]
        with jax.disable_jit():
            want = getattr(jint, fn)(img, xs, ys, fill_value=fill)
        got = getattr(tint, fn)(t(img), t(xs), t(ys), fill_value=fill)
    _same(got.numpy(), np.asarray(want))
    assert np.isfinite(np.asarray(want)).mean() > 0.3


@pytest.mark.parametrize('masked', [True, False], ids=['mask', 'nomask'])
@pytest.mark.parametrize('order', ORDERS)
def test_warp_homography_equal_jax(order, masked):
    """The plain warp against the unjitted JAX warp (bitwise) and the
    jitted one (WARP_JIT_TOL, equal NaN sets), on 0-255 noise with a NaN
    block; outputs larger and smaller than the source."""
    img = (np.random.default_rng(3).uniform(0, 255, (200, 230))
           .astype(np.float32))
    img[10:14, 40:44] = np.nan
    src, mask = (jhom._spline5_inputs(img) if order == 5 else (img, None))
    if not masked:
        if order != 5:
            src = np.nan_to_num(src)
        mask = None
    for H, (ow, oh) in zip(_homographies(), ((150, 120), (70, 60),
                                             (260, 210))):
        hinv = np.linalg.inv(H).astype(np.float32)
        with jax.disable_jit():
            want = np.asarray(jint.warp_homography(src, hinv, ow, oh,
                                                   order=order, nanmask=mask))
        got = tint.warp_homography(
            torch.from_numpy(src), torch.from_numpy(hinv), ow, oh, order,
            None if mask is None else torch.from_numpy(mask)).numpy()
        _same(got, want)
        jit = np.asarray(jint.warp_homography(src, hinv, ow, oh, order=order,
                                              nanmask=mask))
        # where a source coordinate lies within 1e-4 px of an integer,
        # the jitted run's coordinates may floor to the next pixel and
        # reach (or leave) a NaN tap: the NaN sets agree everywhere else
        amb = _near_integer_source(hinv, ow, oh)
        assert amb.mean() < 0.1
        assert np.array_equal(np.isnan(got)[~amb], np.isnan(jit)[~amb])
        fin = np.isfinite(got) & np.isfinite(jit)
        assert fin.mean() > 0.2
        d = np.abs(got[fin] - jit[fin]).max()
        print(f'order {order}, {oh} x {ow}: max |port - jitted JAX| {d}')
        assert d <= WARP_JIT_TOL


def test_warp_batch_equals_single_warps():
    """A (B, 3, 3) batch equals the warps one by one, and a (3, 3)
    homography gives a 2-D output."""
    img = _image(4, nan=False)
    hinvs = np.stack([np.linalg.inv(H) for H in _homographies()]) \
        .astype(np.float32)
    for order in ORDERS:
        batch = tint.warp_homography(torch.from_numpy(img),
                                     torch.from_numpy(hinvs), 33, 21, order)
        assert batch.shape == (3, 21, 33)
        for k in range(3):
            one = tint.warp_homography(torch.from_numpy(img),
                                       torch.from_numpy(hinvs[k]), 33, 21,
                                       order)
            _same(one.numpy(), batch[k].numpy())


def test_warp_homography_refuses_bad_input():
    img = torch.zeros((8, 9))
    hv = torch.eye(3)
    with pytest.raises(ValueError, match='order'):
        tint.warp_homography(img, hv, 4, 4, order=2)
    with pytest.raises(ValueError, match='nanmask'):
        tint.warp_homography(img, hv, 4, 4, order=3, nanmask=img)
    with pytest.raises(TypeError):
        tint.warp_homography(img.double(), hv, 4, 4, order=1)
    with pytest.raises(ValueError, match='hinvs'):
        tint.warp_homography(img, torch.eye(4), 4, 4, order=1)


def test_warp_homography_refuses_bad_dilated():
    img = torch.zeros((8, 9))
    hv = torch.eye(3)
    bad6 = torch.zeros((8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError, match='dilated'):
        tint.warp_homography(img, hv, 4, 4, order=5, dilated=bad6)
    with pytest.raises(ValueError, match='dilated'):
        tint.warp_homography(img, hv, 4, 4, order=5, nanmask=img,
                             dilated=bad6[:, :8])
    with pytest.raises(TypeError, match='dilated'):
        tint.warp_homography(img, hv, 4, 4, order=5, nanmask=img,
                             dilated=img)
    with pytest.raises(TypeError, match='nanmask'):
        tint.warp_dilate(bad6)


def test_cpu_warp_launches_no_kernel():
    """On CPU tensors the wrappers take the plain versions: the counts of
    W1 and of its mask dilation stay 0."""
    tint.reset_launch_counts()
    mask = torch.zeros((8, 9))
    tint.warp_homography(torch.zeros((8, 9)), torch.eye(3), 4, 4, order=5,
                         nanmask=mask)
    tint.warp_dilate(mask)
    assert tint.launch_counts() == {'warp': 0, 'warp_dilate': 0}


def test_warp_z_crossing_zero():
    """A homography whose z crosses 0 inside the output gives NaN there
    (inf or NaN coordinates) and equals the unjitted JAX warp."""
    img = _image(5, nan=False)
    # the inverse's z = 1 - 0.05 x is 0 at column 20 and negative past it
    H = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.05, 0.0, 1.0]])
    hinv = np.linalg.inv(H).astype(np.float32)
    for order in ORDERS:
        src = jhom._spline5_inputs(img)[0] if order == 5 else img
        with jax.disable_jit():
            want = np.asarray(jint.warp_homography(src, hinv, 40, 30,
                                                   order=order))
        got = tint.warp_homography(torch.from_numpy(src),
                                   torch.from_numpy(hinv), 40, 30, order)
        _same(got.numpy(), want)
        assert np.isnan(want[:, 20:]).all()
        assert np.isfinite(want[5:-5, 3:10]).all()


def test_prefilter_equal_jax():
    img = _image(6)
    for a, b in zip(thom._spline5_inputs(img), jhom._spline5_inputs(img)):
        _same(a, b)
    coeffs, mask = thom._spline5_inputs(np.nan_to_num(img))
    assert mask is None


def test_warp_jobs_batched_bitwise(tmp_path):
    """Grouped warps (two sources, two buckets, a NaN block) equal the
    per-job warps bitwise and the JAX package's unjitted per-job warps;
    the same holds for image_apply_homographies."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (200, 230)).astype(np.float32)
    img[10:14, 40:44] = np.nan
    img2 = rng.uniform(0, 255, (90, 100)).astype(np.float32)
    Hs = [np.array([[1.01, 0.02, -30.0], [-0.01, 0.99, 12.0], [0, 0, 1.0]]),
          np.array([[0.97, -0.03, 25.0], [0.02, 1.02, -8.0], [0, 0, 1.0]]),
          np.eye(3)]
    jobs = [(img, Hs[0], 150, 120), (img, Hs[1], 150, 120),
            (img, Hs[2], 70, 60), (img2, Hs[1], 150, 120),
            (img2, Hs[0], 60, 61)]
    batch = thom.warp_jobs_batched(jobs, device='cpu')
    lists = thom.image_apply_homographies(jobs, device='cpu')
    for (im, H, w, h), b, c in zip(jobs, batch, lists):
        s = thom.image_apply_homography(im, H, w, h, device='cpu')
        with jax.disable_jit():
            j = jhom.image_apply_homography(im, H, w, h)
        assert b.shape == (h, w)
        _same(b, s)
        _same(c, s)
        _same(s, j)


def test_warp_jobs_batched_chunks_of_64():
    """65 jobs on one source and bucket run as two warps (64 + 1); each
    output still equals its own warp."""
    img = _image(7, h=20, w=24, nan=False)
    rng = np.random.RandomState(7)
    jobs = []
    for k in range(65):
        H = np.eye(3)
        H[:2, 2] = rng.uniform(-3, 3, 2)
        jobs.append((img, H, 5 + k % 3, 4 + k % 2))
    out = thom.warp_jobs_batched(jobs, order=3, device='cpu')
    for (im, H, w, h), o in zip(jobs[::16] + jobs[-1:],
                                out[::16] + out[-1:]):
        _same(o, thom.image_apply_homography(im, H, w, h, order=3,
                                             device='cpu'))


def test_points_and_boxes_equal_jax():
    rng = np.random.RandomState(9)
    pts = rng.rand(20, 2) * 100
    H = _homographies()[1]
    _same(thom.points_apply_homography(H, pts),
          jhom.points_apply_homography(H, pts))
    _same(thom.points_apply_homography(H, pts[0]),
          jhom.points_apply_homography(H, pts[0]))
    _same(np.array(thom.bounding_box2D(pts)),
          np.array(jhom.bounding_box2D(pts)))
    _same(thom.matrix_translation(3.5, -2), jhom.matrix_translation(3.5, -2))


def _weights_inputs(kind):
    """float32 fractions t in [0, 1) for the weights' bitwise test."""
    if kind == 'zero':
        return np.zeros(1, np.float32)
    if kind == 'below_one':     # the 2^20 float32 just below 1
        top = np.float32(1).view(np.uint32)
        return np.arange(top - (1 << 20), top, dtype=np.uint32) \
            .view(np.float32)
    if kind == 'powers_of_two':     # 2^-1 .. 2^-149 (subnormal)
        return np.ldexp(np.ones(149, np.float32), -np.arange(1, 150))
    return np.random.default_rng(0).random(10 ** 6, dtype=np.float32)


@pytest.mark.parametrize('kind', ['zero', 'below_one', 'powers_of_two',
                                  'uniform'])
def test_bspline5_weights_equal_jax(kind):
    """The port's quintic weights, which skip the terms that are exactly
    zero for t in [0, 1], equal the JAX package's full 7-term sums bit
    for bit."""
    t = _weights_inputs(kind)
    assert t.dtype == np.float32 and (t >= 0).all() and (t < 1).all()
    with jax.disable_jit():
        want = [np.asarray(w) for w in jint._bspline5_weights(t)]
    got = [w.numpy() for w in tint._bspline5_weights(torch.from_numpy(t))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))


def _masked_source(kind):
    """(image with NaN, extra edits of the mask) for the dilation test."""
    rng = np.random.RandomState(11)
    shape = {'row_1xN': (1, 23), 'col_Nx1': (23, 1),
             'tiny_5x5': (5, 5)}.get(kind, (24, 31))
    img = (rng.rand(*shape) * 255).astype(np.float32)
    h, w = shape
    edits = []
    if kind.startswith('border_'):
        side = kind.split('_')[1]
        sl = {'top': (0, slice(None)), 'bottom': (-1, slice(None)),
              'left': (slice(None), 0), 'right': (slice(None), -1)}[side]
        img[sl] = np.nan
    elif kind == 'corners':
        for y, x in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
            img[y, x] = np.nan
    elif kind == 'single_pixels':
        for y, x in ((2, 2), (7, 15), (12, 29), (21, 3)):
            img[y, x] = np.nan
    elif kind == 'mask_nan':     # NaN, negative and -0 values in the mask
        img[5, 5] = np.nan
        edits = [((10, 20), np.nan), ((15, 8), -3.0), ((3, 27), -0.0),
                 ((5, 5), -1.0)]
    else:   # a corner, and the middle of the long sources
        img[0, 0] = np.nan
        if h * w > 25:
            img[h // 2, w // 2] = np.nan
    return img, edits


@pytest.mark.parametrize('kind', ['border_top', 'border_bottom',
                                  'border_left', 'border_right', 'corners',
                                  'single_pixels', 'mask_nan', 'row_1xN',
                                  'col_Nx1', 'tiny_5x5'])
def test_dilated_nanmask_equals_36_tap_rule(kind):
    """W1's masked order 5 reads one byte of ``dilate_nanmask6`` at the
    sample's integer parts.  Through that map the verdict of every
    sample inside the source equals the 36-tap rule (a tap with
    !(m <= 0) makes the sample NaN), and the samples equal
    ``bspline5_sample`` with the mask bitwise, NaN sets included."""
    img, edits = _masked_source(kind)
    coeffs, mask = thom._spline5_inputs(img)
    for (y, x), v in edits:
        mask[y, x] = v
    h, w = img.shape
    # integers, halves and random fractions over the source and past it
    rng = np.random.RandomState(12)
    gy = np.concatenate([np.arange(-1, h + 1), np.arange(-1, h) + 0.5,
                         rng.uniform(-1, h, 40)]).astype(np.float32)
    gx = np.concatenate([np.arange(-1, w + 1), np.arange(-1, w) + 0.5,
                         rng.uniform(-1, w, 40)]).astype(np.float32)
    ys, xs = (a.ravel() for a in np.meshgrid(gy, gx, indexing='ij'))
    t = torch.from_numpy
    want = tint.bspline5_sample(t(coeffs), t(xs), t(ys),
                                nanmask=t(mask)).numpy()
    clear = tint.bspline5_sample(t(coeffs), t(xs), t(ys)).numpy()
    dil = tint.dilate_nanmask6(t(mask)).numpy()
    assert dil.dtype == np.uint8 and dil.shape == mask.shape
    assert np.array_equal(dil, tint.warp_dilate(t(mask)).numpy())
    inside = (xs >= 0) & (ys >= 0) & (xs <= w - 1) & (ys <= h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    verdict = inside & (dil[y0, x0] == 1)
    # the 36-tap rule, tap by tap
    rule = np.zeros_like(inside)
    for j in range(-2, 4):
        for i in range(-2, 4):
            m = mask[np.clip(y0 + j, 0, h - 1), np.clip(x0 + i, 0, w - 1)]
            rule |= ~(m <= 0)
    rule &= inside
    assert np.array_equal(verdict, rule)
    assert verdict.any() and (inside & ~verdict).any()
    got = np.where(verdict, np.float32(np.nan), clear)
    _same(got, want)
