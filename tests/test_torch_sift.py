"""The port's SIFT detection and description
(``s2p_tpu_torch/ops/sift_device.py``, device="cpu") against the JAX
package's device route (``s2p_tpu/ops/sift_tpu.py``, jitted on the CPU).

The inputs are seeded smoothed noise.  Given the same inputs at a step's
boundary, the port's step agrees with the JAX package's as stated below
(descriptors bitwise).  Run end to end, the port differs from the JAX
package by XLA's own rounding of the blur cascade (it contracts and
reorders float32 expressions; the atlases differ by about 6e-5 on
intensities up to 255), which can move a borderline keypoint, so the
end-to-end criterion is a set criterion:

* at least KP_SHARE of the port's keypoints have a JAX keypoint within
  KP_DIST in (x, y, scale, orientation), and the counts differ by at
  most COUNT_SHARE;
* of those keypoints' descriptor entries, at least DESC_EQ_SHARE are
  equal and at least DESC_1_SHARE differ by at most 1; none differs by
  more than DESC_MAX.

Measured on these inputs (``pytest -s`` prints every figure): 100% and
99.89% of the keypoints within 4.5e-3, equal counts, 99.93% of the
entries equal, 99.997% or more within 1, at most 2 apart.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from s2p_tpu.ops import sift as jsift
from s2p_tpu.ops import sift_tpu as jst
from s2p_tpu_torch.ops import sift_device as tsd

THRESH = np.float32(0.0133)
KP_DIST = 1e-2
KP_SHARE = 0.995
COUNT_SHARE = 0.01
DESC_EQ_SHARE = 0.995
DESC_1_SHARE = 0.9999
DESC_MAX = 4
# one step's inputs shared with the JAX package (measured differences
# in brackets)
REFINE_TOL = 1e-5       # offsets (px) and DoG values (3.3e-7, 4.8e-7)
ATLAS_TOL = 1e-3        # the whole pyramid, intensities up to 255 (6.1e-5)
OFFSET_TOL = 2e-2       # kept candidates' offsets and values (6.0e-4)
GRAD_TOL = 1e-5         # gradient magnitude and orientation (7.6e-6, 2.4e-7)
HIST_RTOL = 2e-6        # histograms, against their largest bin (3.4e-7)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one CPU thread here: the suite runs several test files at
    once, and SIFT's thousands of small ops slow down many times over when
    each spins up a parallel region on a shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def image():
    rng = np.random.RandomState(0)
    return ndimage.gaussian_filter(rng.rand(400, 400) * 255, 1.5) \
        .astype(np.float32)


@pytest.fixture(scope='module')
def crops(image):
    """Two crops in two buckets, (256, 256) and (256, 384), with the
    offsets of their origins."""
    return ([np.ascontiguousarray(image[10:200, 20:210]),
             np.ascontiguousarray(image[100:340, 50:310])],
            [(20, 10), (50, 100)])


@pytest.fixture(scope='module')
def padded(crops):
    crop = crops[0][0]
    h, w = crop.shape
    hb, wb = jst._crop_bucket(crop)
    return np.pad(crop, ((0, hb - h), (0, wb - w)), mode='symmetric'), h, w


@pytest.fixture(scope='module')
def jax_pyramid(padded):
    img, h, w = padded
    atlas, tables = jst._pyramid_program(*img.shape, 8, 3)(img, h, w, THRESH)
    return np.asarray(atlas), [np.asarray(t) for t in tables]


@pytest.fixture(scope='module')
def jax_keypoints(crops):
    return jst.keypoints_from_arrays_tpu(crops[0], [THRESH] * 2, crops[1])


@pytest.fixture(scope='module')
def torch_keypoints(crops):
    return tsd.keypoints_from_arrays(crops[0], [THRESH] * 2, crops[1],
                                     device='cpu')


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('shape', [(120, 140), (190, 190), (256, 256),
                                   (257, 900), (800, 1150), (30, 12)])
def test_bucket_and_octave_layout_equal(shape):
    arr = np.zeros(shape, np.float32)
    bucket = jst._crop_bucket(arr)
    assert tsd._crop_bucket(arr) == bucket
    assert tsd._octave_layout(*bucket, 8) == jst._octave_layout(*bucket, 8)


@pytest.mark.parametrize('n,r', [(7, 3), (12, 13), (5, 11), (256, 13)])
def test_symmetric_padding_matches_jnp(n, r):
    """The blur's boundary, also where the radius exceeds the axis (the
    last octaves)."""
    got = tsd._symmetric_index(n, r, 'cpu').numpy()
    want = np.asarray(jnp.pad(jnp.arange(n), (r, r), mode='symmetric'))
    assert np.array_equal(got, want)


def test_stable_top_k_breaks_ties_to_the_lower_index():
    score = np.zeros(64, np.float32)
    score[[3, 9, 17, 40]] = 2.0
    score[[5, 50]] = 3.0
    score[[7, 8, 60]] = 1.0
    for k in (2, 5, 9, 20):
        top, idx = jax.lax.top_k(jnp.asarray(score), k)
        ttop, tidx = tsd._top_k(torch.from_numpy(score), k)
        assert np.array_equal(np.asarray(idx), tidx.numpy()), k
        assert np.array_equal(np.asarray(top), ttop.numpy()), k


def test_pyramid_tables_and_atlas(padded, jax_pyramid):
    img, h, w = padded
    atlas, tables = tsd._pyramid_program(_t(img), h, w, THRESH, 8, 3)
    jatlas, jtables = jax_pyramid
    assert atlas.shape == jatlas.shape
    print(f'atlas: largest difference {np.abs(atlas.numpy() - jatlas).max()}')
    assert np.abs(atlas.numpy() - jatlas).max() <= ATLAS_TOL
    assert len(tables) == len(jtables)
    n_kept = 0
    for a, b in zip(tables, jtables):
        a = a.numpy()
        assert a.shape == b.shape
        ka, kb = a[:, 7] > 0, b[:, 7] > 0
        kept_a = {tuple(r) for r in a[ka, :3]}
        kept_b = {tuple(r) for r in b[kb, :3]}
        assert len(kept_a ^ kept_b) <= (1 - KP_SHARE) * max(len(kept_b), 1)
        both = ka & kb & (a[:, :3] == b[:, :3]).all(axis=1)
        if both.any():
            print(f'octave table: {kb.sum()} kept, offsets and values within '
                  f'{np.abs(a[both, 3:7] - b[both, 3:7]).max()}')
            assert np.abs(a[both, 3:7] - b[both, 3:7]).max() <= OFFSET_TOL
        n_kept += kb.sum()
    assert n_kept > 500


def _jax_octave0(img, h, w):
    """The JAX package's octave-0 DoG and top-K candidates (its own
    functions, jitted), and its refinement of them."""
    @jax.jit
    def run(x):
        sigma0 = math.sqrt(jsift.SIGMA_MIN ** 2
                           - jsift.SIGMA_IN ** 2) / jsift.DELTA_MIN
        imgs = [jst._blur_jnp(jst._upsample2_jnp(x), sigma0)]
        for s in range(1, 6):
            rho = (jsift.SIGMA_MIN / jsift.DELTA_MIN) * math.sqrt(
                2 ** (2.0 * s / 3) - 2 ** (2.0 * (s - 1) / 3))
            imgs.append(jst._blur_jnp(imgs[-1], rho))
        g = jnp.stack(imgs)
        dog = g[1:] - g[:-1]
        mask = jst._extrema_mask_jnp(dog) & (jnp.abs(dog) >= 0.8 * THRESH)
        score = jnp.where(mask, jnp.abs(dog), 0.0).reshape(-1)
        top, idx = jax.lax.top_k(score, jst._K0)
        S, H, W = dog.shape
        cand = (idx // (H * W), (idx // W) % H, idx % W)
        return dog, cand, top > 0, jst._refine_device(
            dog, *cand, top > 0, THRESH, 2 * h, 2 * w)
    return jax.tree_util.tree_map(np.asarray, run(img))


def test_refine_given_the_jax_dog(padded):
    img, h, w = padded
    dog, cand, alive, want = _jax_octave0(img, h, w)
    got = tsd._refine_device(_t(dog), *[_t(c.astype(np.int64)) for c in cand],
                             _t(alive), torch.tensor(THRESH), 2 * h, 2 * w)
    got = [g.numpy() for g in got]
    for k in (0, 1, 2, 5):        # s, y, x, keep
        assert np.array_equal(got[k], want[k])
    print(f'refinement: offsets within {np.abs(got[3] - want[3]).max()}, '
          f'values within {np.abs(got[4] - want[4]).max()}')
    assert np.abs(got[3] - want[3]).max() <= REFINE_TOL
    assert np.abs(got[4] - want[4]).max() <= REFINE_TOL
    assert want[5].sum() > 500


def _jax_jobs(padded, jax_pyramid):
    """Orientation and descriptor jobs from the JAX package's own tables
    and histograms, as its dispatch builds them."""
    img, h, w = padded
    _, tables = jax_pyramid
    st = dict(h=h, w=w, n_scales=3, n_octaves=8,
              slots=jst._octave_layout(*img.shape, 8)[1])
    groups = jst._build_groups(st, tables)
    for g in groups:
        g['_jobs'] = g['ys']
    return groups


def _cols(groups, fns):
    return np.stack([c for _, c in jst._group_cols(
        groups, [(str(k), f) for k, f in enumerate(fns)])])


def test_gradients_histograms_and_descriptors_given_the_jax_atlas(
        padded, jax_pyramid):
    jatlas, _ = jax_pyramid
    gm, go = (np.asarray(a) for a in jst._grad_fields_atlas()(jatlas))
    tm, to = tsd._grad_fields_atlas(_t(jatlas))
    print(f'gradients: magnitude within {np.abs(tm.numpy() - gm).max()}, '
          f'orientation within {np.abs(to.numpy() - go).max()}')
    assert np.abs(tm.numpy() - gm).max() <= GRAD_TOL
    assert np.abs(to.numpy() - go).max() <= GRAD_TOL

    groups = _jax_jobs(padded, jax_pyramid)
    ori = _cols(groups, [
        lambda g: g['ys'] + g['oy'], lambda g: g['xs'] + g['ox'],
        lambda g: g['sigma_oct'], lambda g: g['ylo'], lambda g: g['yhi'],
        lambda g: g['xlo'], lambda g: g['xhi']])
    n = ori.shape[1]
    want = np.asarray(jst._ori_kernel_atlas()(gm, go, *ori,
                                              np.ones(n, bool)))
    got = tsd._ori_kernel_atlas(_t(gm), _t(go), *_t(ori)).numpy()
    print(f'histograms: within {np.abs(got - want).max() / np.abs(want).max()}'
          ' of the largest bin')
    assert np.abs(got - want).max() <= HIST_RTOL * np.abs(want).max()
    peaks_j, peaks_t = jsift._hist_peaks(want), jsift._hist_peaks(got)
    assert all(len(a) == len(b) for a, b in zip(peaks_j, peaks_t))

    pos = 0
    for g in groups:
        oris = peaks_j[pos:pos + len(g['ys'])]
        pos += len(g['ys'])
        g['job_kp'] = np.array([i for i, a in enumerate(oris) for _ in a],
                               dtype=np.int64)
        g['job_theta'] = np.array([t for a in oris for t in a], np.float32)
        g['_jobs'] = g['job_kp']
    desc = _cols(groups, [
        lambda g: g['ys'][g['job_kp']] + g['oy'],
        lambda g: g['xs'][g['job_kp']] + g['ox'],
        lambda g: g['sigma_oct'][g['job_kp']], lambda g: g['job_theta'],
        lambda g: g['ylo'], lambda g: g['yhi'], lambda g: g['xlo'],
        lambda g: g['xhi']])
    m = desc.shape[1]
    want = np.concatenate([np.asarray(jst._desc_kernel_atlas()(
        gm, go, *desc[:, i:i + 512], np.ones(desc[:, i:i + 512].shape[1],
                                             bool)))
        for i in range(0, m, 512)])
    radius = tsd._desc_radius(desc[2])
    assert radius.max() <= tsd._R_DESC and len(np.unique(radius)) > 1
    for R in np.unique(radius):
        idx = np.nonzero(radius == R)[0]
        got = tsd._desc_kernel_atlas(_t(gm), _t(go), *_t(desc[:, idx]),
                                     R=int(R)).numpy()
        # the JAX package's one radius and the port's classes alike
        assert np.array_equal(got, want[idx])
        assert np.array_equal(tsd._desc_kernel_atlas(
            _t(gm), _t(go), *_t(desc[:, idx])).numpy(), want[idx])
    assert m > 500 and (want.max(axis=1) > 0).all()


@pytest.mark.parametrize('k', [0, 1])
def test_keypoints_set_criterion(jax_keypoints, torch_keypoints, k):
    want, got = jax_keypoints[k], torch_keypoints[k]
    assert got.shape[1] == want.shape[1] == 132
    assert abs(len(got) - len(want)) <= COUNT_SHARE * len(want)
    assert len(want) > 1000
    d, idx = cKDTree(want[:, :4]).query(got[:, :4], k=1)
    close = d < KP_DIST
    diff = np.abs(got[close, 4:] - want[idx[close], 4:])
    print(f'crop {k}: {len(got)} keypoints against {len(want)}; '
          f'{close.mean()} within {KP_DIST} (at most {d[close].max()}); '
          f'descriptor entries equal {(diff == 0).mean()}, within 1 '
          f'{(diff <= 1).mean()}, at most {diff.max()} apart')
    assert close.mean() >= KP_SHARE
    assert (diff == 0).mean() >= DESC_EQ_SHARE
    assert (diff <= 1).mean() >= DESC_1_SHARE
    assert diff.max() <= DESC_MAX
    # integer descriptors, at most 255, every row normalised
    assert np.array_equal(got[:, 4:], np.floor(got[:, 4:]))
    assert got[:, 4:].max() <= 255 and (got[:, 4:].sum(axis=1) > 0).all()


def test_batch_equals_single_bitwise(crops, torch_keypoints):
    for crop, off, batch in zip(*crops, torch_keypoints):
        single = tsd.keypoints_from_array(crop, THRESH, offset=off,
                                          device='cpu')
        assert np.array_equal(single, batch)


def test_device_desc_keeps_the_rows(crops, torch_keypoints):
    """device_desc=True: the host heads and the device descriptors are
    the rows of the host route; timings names the three waves."""
    timings = {}
    out = tsd.keypoints_from_arrays(crops[0], [THRESH] * 2, crops[1],
                                    device_desc=True, device='cpu',
                                    timings=timings)
    for o, rows in zip(out, torch_keypoints):
        assert o['count'] == len(rows) == len(o['meta'])
        assert np.array_equal(o['meta'], rows[:, :4])
        assert o['desc'].device.type == 'cpu'
        assert np.array_equal(o['desc'].numpy(), rows[:, 4:])
    assert sorted(timings) == ['descriptor', 'orientation', 'pyramid']


def test_runs_on_cuda_unless_asked(monkeypatch, crops):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tsd.keypoints_from_arrays(crops[0][:1], [THRESH])
