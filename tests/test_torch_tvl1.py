"""The port's TV-L1 matcher (``ops/tvl1.py``, device="cpu") against the
JAX package's: the pyramid and the flow's upsampling bitwise (the JAX
package runs them eagerly, one jnp operation at a time), the finite
differences bitwise, then ``flow``, ``disparity``,
``compute_disparity_map('tvl1')`` and stage 4's per-tile route within a
tolerance.

Why a tolerance.  The JAX package runs each pyramid level's 5 warps of
30 primal-dual iterations as one jitted program.  XLA's CPU run fuses
some of its multiplies into the adds that follow (the bilinear samples'
sums and the dual updates, not the data term, as its fusion decides) and
rounds ``jnp.hypot`` (itself jitted) otherwise than the formula's
separate operations on about 0.7% of the inputs.  The port rounds every
operation on its own, in the JAX package's order, so that its card and
its CPU agree; 150 iterations a level carry the last-bit differences into
the flow, and a few pixels amplify them, the more so where the flow is
ill-posed.  Measured on six seeds of the textured 64 x 80 pair below:
the 99th percentile of the flows' differences from 5.7e-6 to 1.9e-4 px,
the largest from 7.3e-5 to 0.022 px; on a 24 x 40 pair of pure noise
(``test_torch_mgm_multi.py``) 0.0076 px and 0.22 px; the validity masks
(``|v| <= 1``) equal in all (``pytest -s`` prints this run's figures).
The criterion, on the flows and on the disparities of pixels valid in
both: the median difference at most FLOW_MEDIAN px, the 99th percentile
at most FLOW_P99 px, the largest at most FLOW_MAX px; the masks equal on
at least VALID_SHARE of the pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2p_tpu.config import Config as JConfig
from s2p_tpu.core import matching as jm
from s2p_tpu.ops import tvl1 as jtvl1
from s2p_tpu_torch import state
from s2p_tpu_torch.core import matching as tm
from s2p_tpu_torch.ops import tvl1 as ttvl1

from test_torch_msmw import _same, pair, stage4_against_jax
from test_torch_sift import one_thread  # noqa: F401 (autouse fixture)

FLOW_MEDIAN = 1e-3
FLOW_P99 = 0.02
FLOW_MAX = 0.5
VALID_SHARE = 0.995
SHAPE = (64, 80)          # two pyramid levels


def check_tvl1(ours, ref, what=''):
    """The criterion of the module docstring on (disp, valid) pairs."""
    (d, v), (dr, vr) = ours, ref
    agree = (v == vr).mean()
    both = v & vr
    print(f'tvl1 {what}: masks agree on {agree}, valid {vr.mean():.3f}')
    assert agree >= VALID_SHARE
    _within(d[both], dr[both], what)
    assert vr.mean() > 0.3


def _within(a, b, what):
    err = np.abs(a - b)
    med, p99, top = np.median(err), np.percentile(err, 99), err.max()
    print(f'tvl1 {what}: |error| median {med}, p99 {p99}, max {top} px')
    assert med <= FLOW_MEDIAN and p99 <= FLOW_P99 and top <= FLOW_MAX


def test_pyramid_and_upsampling_bitwise():
    rng = np.random.RandomState(1)
    img = (rng.rand(37, 50) * 255).astype(np.float32)
    _same(ttvl1._zoom_out(torch.from_numpy(img)).numpy(),
          jtvl1._zoom_out(jnp.asarray(img)))
    u = (rng.rand(19, 25) * 4 - 2).astype(np.float32)
    v = (rng.rand(19, 25) - 0.5).astype(np.float32)
    ours = ttvl1._zoom_in_flow(torch.from_numpy(u), torch.from_numpy(v),
                               (37, 50))
    ref = jtvl1._zoom_in_flow(jnp.asarray(u), jnp.asarray(v), (37, 50))
    for o, r in zip(ours, ref):
        _same(o.numpy(), r)


def test_differences_bitwise():
    rng = np.random.RandomState(2)
    a, b = ((rng.rand(9, 13) * 10 - 5).astype(np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for o, r in zip(ttvl1._forward_grad(ta), jtvl1._forward_grad(a)):
        _same(o.numpy(), r)
    _same(ttvl1._divergence(ta, tb).numpy(), jtvl1._divergence(a, b))
    _same(ttvl1._cdx(ta).numpy(), jtvl1._cdx(a))
    _same(ttvl1._cdy(ta).numpy(), jtvl1._cdy(a))


@pytest.fixture(scope='module')
def jax_flow():
    im1, im2 = pair(SHAPE, shift=3)
    return (im1, im2), jtvl1.flow(im1, im2)


def test_flow_within_the_tolerance(jax_flow):
    (im1, im2), (ur, vr) = jax_flow
    u, v = ttvl1.flow(im1, im2, device='cpu')
    assert u.dtype == np.float32 and u.shape == ur.shape
    _within(u, ur, 'flow u')
    _within(v, vr, 'flow v')
    fin = np.isfinite(im1)
    assert abs(np.median(u[fin]) - 3.0) < 0.1


def test_disparity_within_the_tolerance(jax_flow):
    (im1, im2), _ = jax_flow
    ours = ttvl1.disparity(im1, im2, device='cpu')
    check_tvl1(ours, jtvl1.disparity(im1, im2), 'disparity')
    assert not ours[1][:3, :4].any()          # NaN in the reference


def test_compute_disparity_map(jax_flow):
    (im1, im2), _ = jax_flow
    ref = jm.compute_disparity_map(JConfig(matching_algorithm='tvl1'), im1,
                                   im2, -8, 8)
    ours = tm.compute_disparity_map(
        state.config_from_state({'matching_algorithm': 'tvl1'}), im1, im2,
        -8, 8, device='cpu')
    assert ours[2] is None and ref[2] is None
    assert ours[1].dtype == np.uint8
    check_tvl1((ours[0], ours[1] == 1), (ref[0], ref[1] == 1), 'compute')


def test_stereo_matching_all(tmp_path):
    """Stage 4's per-tile route with tvl1: the JAX package's file set."""
    stage4_against_jax(tmp_path, 'tvl1',
                       lambda k: pair(SHAPE, shift=3, seed=k),
                       [(-8, 8), (-5, 9)], check_tvl1)
