"""The port's ``parallel/`` against the JAX package's, on the CPU.

``distributed``: in one process every function is the identity, and
``partition_tiles`` gives the JAX package's blocks.  ``mesh`` and ``halo``
run twice: in this process (one rank, no process group) and in two OS
processes joined by a gloo group over a free localhost port (as
``tests/test_multiprocess.py`` joins its JAX workers); each rank writes
its results to an ``.npz``.  Both runs are held against the JAX functions
on the conftest's 8 virtual CPU devices: the matcher bitwise (each tile's
chain is the same there), the rasterizer, the global mean and the
pointing fit at the JAX tests' own tolerances (``tests/test_parallel_mesh.py``;
their sums run in another order).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from s2p_tpu_torch.ops.sgm import SgmParams
from s2p_tpu_torch.parallel import distributed as tdist
from s2p_tpu_torch.parallel import halo as thalo
from s2p_tpu_torch.parallel import mesh as tmesh

# the workers import this module without JAX: the JAX package is imported
# inside the tests
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TILES = 8
DSM_TOL = {'1d': dict(rtol=1e-5, atol=1e-4), '2d': dict(rtol=1e-4, atol=1e-3)}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    same = (a == b) | (np.isnan(a) & np.isnan(b)) if a.dtype.kind == 'f' \
        else a == b
    assert same.all(), f'{(~same).sum()} of {same.size} entries differ'


def _inputs():
    """Every case's inputs, made from seeds: the matcher's batch, the two
    rasterizer layouts, the altitude grids and the pointing pairs."""
    rng = np.random.RandomState(0)
    im1 = (rng.rand(N_TILES, 32, 48) * 100).astype(np.float32)
    im2 = np.roll(im1, 3, axis=2)
    ins = {'im1': im1, 'im2': im2}
    # one row of tiles (test_parallel_mesh.py's layout)
    gw, gh, halo, res, yoff, n_pts = 16, 12, 2, 1.0, 100.0, 300
    pts = np.zeros((N_TILES, n_pts, 3), np.float32)
    xoffs = np.array([1000.0 + k * gw * res for k in range(N_TILES)],
                     np.float32)
    for k in range(N_TILES):
        x = xoffs[k] + rng.uniform(-halo * res, gw * res + halo * res, n_pts)
        x = np.clip(x, 1000.0, 1000.0 + N_TILES * gw * res - 1e-3)
        y = yoff - rng.uniform(0, gh * res, n_pts)
        pts[k] = np.column_stack([x, y, rng.uniform(10, 50, n_pts)])
    valid = rng.rand(N_TILES, n_pts) > 0.05
    ins['1d'] = dict(tile_points=pts, tile_valid=valid, xoffs=xoffs,
                     yoffs=np.full(N_TILES, yoff, np.float32), res=res,
                     gw=gw, gh=gh, halo=halo)
    # a 2 x 4 grid with the gaussian splat
    nty, ntx = 2, N_TILES // 2
    gw, gh, halo, res, radius, sigma = 12, 10, 4, 0.5, 2, 0.8
    x0, y0, n_pts = 5000.0, 200.0, 250
    pts = np.zeros((N_TILES, n_pts, 3), np.float32)
    xoffs = np.zeros(N_TILES, np.float32)
    yoffs = np.zeros(N_TILES, np.float32)
    for k in range(N_TILES):
        ty, tx = divmod(k, ntx)
        xoffs[k] = x0 + tx * gw * res
        yoffs[k] = y0 - ty * gh * res
        spill = (halo - radius) * res
        x = xoffs[k] + rng.uniform(-spill, gw * res + spill, n_pts)
        y = yoffs[k] - rng.uniform(-spill, gh * res + spill, n_pts)
        x = np.clip(x, x0, x0 + ntx * gw * res - 1e-3)
        y = np.clip(y, y0 - nty * gh * res + 1e-3, y0)
        pts[k] = np.column_stack([x, y, rng.uniform(10, 50, n_pts)])
    ins['2d'] = dict(tile_points=pts, tile_valid=np.ones((N_TILES, n_pts),
                                                         bool),
                     xoffs=xoffs, yoffs=yoffs, res=res, gw=gw, gh=gh,
                     halo=halo, grid_shape=(nty, ntx), radius=radius,
                     sigma=sigma)
    alts = rng.rand(N_TILES, 16, 16).astype(np.float32)
    alts[0, :4] = np.nan
    alts[5, 3:9, 2:] = np.nan
    ins['alts'] = alts
    centers = rng.uniform(0, 1000, (4 * N_TILES, 2))
    M_true = np.array([[1.0, 0.01, 3.0], [-0.02, 0.99, -7.0], [0, 0, 1.0]])
    h = np.column_stack([centers, np.ones(len(centers))])
    ins['centers'], ins['corrected'] = centers, (h @ M_true.T)[:, :2]
    return ins


def _run_port(mesh):
    """Every case of the port on ``mesh``: {name: numpy result}."""
    ins = _inputs()
    out = {}
    for name, params in (('match_mgm', SgmParams()),
                         ('match_classic', SgmParams(mgm=False))):
        r = tmesh.sharded_matching_step(mesh, ins['im1'], ins['im2'], -2, 5,
                                        params)
        for k, v in r.items():
            out[f'{name}_{k}'] = v
    for layout in ('1d', '2d'):
        out[f'dsm_{layout}'] = thalo.sharded_dsm(mesh, **ins[layout])
    out['mean'] = np.float64(tmesh.global_mean_height_allreduce(
        mesh, ins['alts']))
    out['fit'] = thalo.distributed_pointing_fit(mesh, ins['centers'],
                                                ins['corrected'])
    return out


_WORKER = r"""
import json, sys
import numpy as np
import torch
sys.path[:0] = [sys.argv[5], sys.argv[5] + '/tests']
torch.set_num_threads(1)
port, n, k, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
from s2p_tpu_torch.parallel import distributed as dist
from s2p_tpu_torch.parallel import mesh as tmesh
assert dist.init(f'localhost:{port}', n, k) == (n, k)
assert not dist.is_primary() or k == 0
from test_torch_parallel import _run_port
res = _run_port(tmesh.TileMesh(device='cpu'))
np.savez(out, **res)
with open(out + '.json', 'w') as f:
    json.dump({'block': dist.partition_tiles(list(range(8)))}, f)
dist.barrier('done')
"""


@pytest.fixture(scope='module')
def jax_results():
    """The JAX functions on the 8-device virtual mesh."""
    from s2p_tpu.ops.sgm import SgmParams as JParams
    from s2p_tpu.parallel import TileMesh as JMesh
    from s2p_tpu.parallel import halo as jhalo
    from s2p_tpu.parallel import mesh as jmesh
    ins = _inputs()
    mesh = JMesh()
    assert mesh.n == N_TILES
    out = {}
    for name, params in (('match_mgm', JParams()),
                         ('match_classic', JParams(mgm=False))):
        r = jmesh.sharded_matching_step(mesh, ins['im1'], ins['im2'], -2, 5,
                                        params)
        for k, v in r.items():
            out[f'{name}_{k}'] = v
    for layout in ('1d', '2d'):
        out[f'dsm_{layout}'] = jhalo.sharded_dsm(mesh, **ins[layout])
    out['mean'] = jmesh.global_mean_height_allreduce(mesh, ins['alts'])
    out['fit'] = jhalo.distributed_pointing_fit(mesh, ins['centers'],
                                                ins['corrected'])
    return out


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """The port's cases in two gloo processes: each rank's results."""
    root = tmp_path_factory.mktemp('ranks')
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, '-c', _WORKER, str(port), '2', str(k),
         str(root / f'rank_{k}.npz'), ROOT], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for k in (0, 1)]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for k, p in enumerate(procs):
        assert p.returncode == 0, f'rank {k} failed:\n{logs[k][-4000:]}'
    return [(dict(np.load(root / f'rank_{k}.npz')),
             json.load(open(root / f'rank_{k}.npz.json'))) for k in (0, 1)]


def _check(out, ref):
    for name in ('match_mgm', 'match_classic'):
        for k in ('disp', 'valid', 'confidence'):
            _same(out[f'{name}_{k}'], ref[f'{name}_{k}'])
        d, v = out[f'{name}_disp'], out[f'{name}_valid']
        inner = v[:, 8:-8, 8:-8]
        assert np.median(np.abs(d[:, 8:-8, 8:-8][inner] - 3.0)) < 0.3
    for layout in ('1d', '2d'):
        got, want = out[f'dsm_{layout}'], ref[f'dsm_{layout}']
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        m = ~np.isnan(want)
        assert m.mean() > 0.5
        np.testing.assert_allclose(got[m], want[m], **DSM_TOL[layout])
    assert np.isclose(float(out['mean']), ref['mean'], rtol=1e-5)
    np.testing.assert_allclose(out['fit'], ref['fit'], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize('count', [1, 2, 3, 5, 8])
def test_distributed_is_the_identity_in_one_process(count):
    from s2p_tpu.parallel import distributed as jdist
    assert tdist.init() == (1, 0)
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    assert tdist.is_primary()
    tdist.barrier('nothing to wait for')
    items = list(range(11))
    assert tdist.partition_tiles(items) == items
    blocks = [tdist.partition_tiles(items, i, count) for i in range(count)]
    assert blocks == [jdist.partition_tiles(items, i, count)
                      for i in range(count)]
    assert sum(blocks, []) == items


def test_batch_tiles_matches():
    from s2p_tpu.parallel import mesh as jmesh
    rng = np.random.RandomState(1)
    imgs = [rng.rand(30, 40), rng.rand(25, 45), rng.rand(8, 8)]
    for kw in ({'multiple': 16}, {}, {'pad_shape': (40, 48)}):
        got, shapes = tmesh.batch_tiles(imgs, **kw)
        want, wshapes = jmesh.batch_tiles(imgs, **kw)
        _same(got, want)
        assert shapes == wshapes


def test_one_rank_matches_jax(jax_results):
    mesh = tmesh.TileMesh(device='cpu')
    assert (mesh.n, mesh.rank) == (1, 0)
    _check(_run_port(mesh), jax_results)


def test_two_ranks_match_jax(two_ranks, jax_results):
    blocks = [info['block'] for _, info in two_ranks]
    assert blocks == [list(range(4)), list(range(4, 8))]
    for out, _ in two_ranks:
        _check(out, jax_results)
    # both ranks hold every tile's result, the same bits
    for k in two_ranks[0][0]:
        _same(two_ranks[0][0][k], two_ranks[1][0][k])


def test_uneven_tile_counts_raise():
    mesh = tmesh.TileMesh(device='cpu')
    mesh.n = 3
    ins = _inputs()
    with pytest.raises(ValueError, match='split'):
        tmesh.sharded_matching_step(mesh, ins['im1'], ins['im2'], -2, 5)
    with pytest.raises(ValueError, match='split'):
        tmesh.global_mean_height_allreduce(mesh, ins['alts'])
