"""``ops/rasterize.plyflatten_device`` (device="cpu") against the JAX
package's ``plyflatten_jax``, jitted and op by op.

The scatter-adds run in the order of the points on both, so the two are
bitwise wherever the weights are: uniform weights (a huge sigma) and
points at cell centres give exp(0) = 1 on both.  With gaussian weights
XLA's ``exp`` and torch's differ in the last bit on about 9% of the
inputs, so those cases are held to a relative error of 1e-6 (the largest
measured: 2.6e-7) with equal sets of empty cells.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2p_tpu.ops.rasterize import plyflatten_jax
from s2p_tpu_torch.ops.rasterize import plyflatten_device

GRID = (0.5, 30.25, 0.5, 80, 60)       # xoff, yoff, resolution, xsize, ysize
RTOL = 1e-6


def _cloud(n=4000, seed=0):
    """Points over the grid and past each of its borders, several a cell,
    NaN in x, in a payload column and in y, and infinities."""
    rng = np.random.RandomState(seed)
    xyz = np.column_stack([rng.uniform(-5, 45, n), rng.uniform(-5, 35, n),
                           rng.uniform(0, 100, n),
                           rng.uniform(0, 255, n)]).astype(np.float32)
    xyz[rng.rand(n) < 0.05, 2] = np.nan
    xyz[rng.rand(n) < 0.02, 0] = np.nan
    xyz[rng.rand(n) < 0.02, 1] = np.nan
    xyz[:4, :2] = [[1e12, 5.0], [-1e12, 5.0], [np.inf, 5.0], [5.0, -np.inf]]
    xyz[4, 3] = np.inf
    return xyz


def _centres():
    """Three points on each of 40 cell centres (d = 0, so weight 1)."""
    rng = np.random.RandomState(1)
    j, i = rng.randint(0, 80, 40), rng.randint(0, 60, 40)
    x = 0.5 + (j + 0.5) * 0.5
    y = 30.25 - (i + 0.5) * 0.5
    pts = np.column_stack([np.repeat(x, 3), np.repeat(y, 3),
                           rng.uniform(0, 100, 120), rng.uniform(0, 9, 120)])
    return pts.astype(np.float32)


def _jax(xyz, sigma, jit):
    if jit:
        f = jax.jit(plyflatten_jax, static_argnums=(4, 5, 6))
        return np.asarray(f(jnp.asarray(xyz), *GRID, sigma))
    with jax.disable_jit():
        return np.asarray(plyflatten_jax(jnp.asarray(xyz), *GRID, sigma))


@pytest.mark.parametrize('jit', [True, False], ids=['jit', 'op_by_op'])
@pytest.mark.parametrize('case', ['uniform', 'centres', 'gauss_res',
                                  'gauss_0.3'])
def test_equals_plyflatten_jax(case, jit):
    xyz, sigma = {'uniform': (_cloud(), 1e6), 'centres': (_centres(), 0.3),
                  'gauss_res': (_cloud(seed=2), None),
                  'gauss_0.3': (_cloud(seed=3), 0.3)}[case]
    want = _jax(xyz, sigma, jit)
    got = plyflatten_device(xyz, *GRID, sigma=sigma, device='cpu')
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    got = got.numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (60, 80, 2)
    full = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), full)
    assert full.any() and not full.all()
    if case in ('uniform', 'centres'):
        assert np.array_equal(got, want, equal_nan=True)
    else:
        np.testing.assert_allclose(got[full], want[full], rtol=RTOL, atol=0)


def test_dtype_tensor_input_and_cuda_default(monkeypatch):
    xyz = _cloud(500)
    got = plyflatten_device(torch.from_numpy(xyz).double(), *GRID,
                            device='cpu')
    assert got.dtype == torch.float64
    want = plyflatten_device(xyz.astype(np.float64), *GRID, device='cpu')
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        plyflatten_device(xyz, *GRID)
