"""The port's line segment detector (``s2p_tpu_torch/ops/lsd.py``) against
the JAX package's: segments, their rasterization and the mgm_multi_lsd
weight maps, equal to the bit."""

import numpy as np
import pytest

from s2p_tpu.ops import lsd as jlsd
from s2p_tpu_torch.ops import lsd as tlsd


def _square():
    """``tests/test_lsd.py``'s square on a noisy background."""
    img = np.full((200, 200), 200.0)
    img[60:140, 50:160] = 50.0
    img += np.random.RandomState(0).randn(200, 200) * 2
    return img


def _textured():
    """Blocks, a slanted band and a disc over a smoothed random texture,
    with a NaN corner (the rectified tiles' borders)."""
    rng = np.random.RandomState(3)
    img = rng.rand(120, 160) * 40
    img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3 + 60
    ys, xs = np.mgrid[:120, :160]
    img[15:50, 20:70] += 90
    img[70:110, 90:150] -= 40
    img[np.abs(ys - 0.4 * xs - 40) < 3] += 120
    img[(ys - 90) ** 2 + (xs - 40) ** 2 < 15 ** 2] = 230
    img[:8, :12] = np.nan
    return img


_IMAGES = {'square': _square, 'textured': _textured}


@pytest.mark.parametrize('name', sorted(_IMAGES))
def test_lsd_matches_jax(name):
    img = np.nan_to_num(_IMAGES[name]())
    ref = jlsd.lsd(img)
    ours = tlsd.lsd(img)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert np.array_equal(ours, ref)
    assert len(ref) >= 4


@pytest.mark.parametrize('name', sorted(_IMAGES))
def test_draw_segments_matches_jax(name):
    img = np.nan_to_num(_IMAGES[name]())
    segs = jlsd.lsd(img)
    # and segments that leave the image on every side
    segs = np.concatenate([segs, [[-5.0, 2.0, 300.0, 2.0, 1.0],
                                  [10.0, -8.0, 10.0, 500.0, 2.0],
                                  [-3.0, -3.0, 400.0, 250.0, 1.5]]])
    h, w = img.shape
    ours = tlsd.draw_segments(segs, w, h)
    ref = jlsd.draw_segments(segs, w, h)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert (ref == 255).any()


@pytest.mark.parametrize('name', sorted(_IMAGES))
def test_lsd_weights_match_jax(name):
    img = _IMAGES[name]().astype(np.float32)
    ref = jlsd.lsd_weights(img)
    ours = tlsd.lsd_weights(img)
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours, ref)
    assert ref.min() == np.float32(0.1) and ref.max() == 1.0


def test_lsd_empty_on_flat():
    img = np.full((100, 100), 7.0)
    assert len(tlsd.lsd(img)) == 0 == len(jlsd.lsd(img))
