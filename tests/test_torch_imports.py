"""The port stands alone: it imports neither JAX nor the JAX package nor
PIL nor torch.utils.cpp_extension, and its entry points run on CUDA
unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 's2p_tpu_torch')
_BANNED = ('jax', 'jaxlib', 's2p_tpu', 'PIL', 'torch.utils.cpp_extension')


def _port_sources():
    tools = os.path.join(ROOT, 'tools')
    paths = [os.path.join(ROOT, 'chip_smoke.py')] + [
        os.path.join(tools, f) for f in os.listdir(tools)
        if f.endswith('_torch.py')]
    for d, _, files in os.walk(PKG):
        paths += [os.path.join(d, f) for f in files if f.endswith('.py')]
    return sorted(paths)


def _modules():
    mods = []
    for p in _port_sources():
        rel = os.path.relpath(p, ROOT)[:-3].replace(os.sep, '.')
        mods.append(rel[:-len('.__init__')] if rel.endswith('__init__')
                    else rel)
    return mods


def _banned(name):
    return any(name == b or name.startswith(b + '.') for b in _BANNED)


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_banned_import_anywhere_in_source(path):
    """Every import statement, at module level or inside a function."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module] + [f'{node.module}.{a.name}'
                                     for a in node.names]
        else:
            continue
        assert not any(_banned(n) for n in names), (path, names)


def test_new_modules_are_scanned():
    """The modules of the multi-process slice, the lax matcher routes, the
    msmw and TV-L1 matchers, SIFT's host route and ASIFT are among the
    scanned sources, and import with JAX blocked (below)."""
    rels = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ('s2p_tpu_torch/parallel/__init__.py',
                's2p_tpu_torch/parallel/distributed.py',
                's2p_tpu_torch/parallel/mesh.py',
                's2p_tpu_torch/parallel/halo.py',
                's2p_tpu_torch/ops/mgm.py', 's2p_tpu_torch/ops/msmw.py',
                's2p_tpu_torch/ops/tvl1.py', 's2p_tpu_torch/ops/sift_host.py',
                's2p_tpu_torch/ops/asift.py', 'chip_smoke.py'):
        assert rel.replace('/', os.sep) in rels, rel
    mods = _modules()
    for m in ('s2p_tpu_torch.parallel', 's2p_tpu_torch.parallel.distributed',
              's2p_tpu_torch.parallel.mesh', 's2p_tpu_torch.parallel.halo',
              's2p_tpu_torch.ops.mgm', 's2p_tpu_torch.ops.msmw',
              's2p_tpu_torch.ops.tvl1', 's2p_tpu_torch.ops.sift_host',
              's2p_tpu_torch.ops.asift'):
        assert m in mods, m


# modules of the JAX package whose counterpart has another name
RENAMED = {
    # the Pallas kernels' wrappers: the port's hand-written CUDA kernels
    # (csrc/) and their plain versions sit behind sgm_kernels.py
    'ops/sgm_pallas.py': ('ops/sgm_kernels.py', 'the Pallas kernels became '
                          'CUDA kernels with plain PyTorch versions'),
    # SIFT's device route: eager torch on the card, not a TPU program
    'ops/sift_tpu.py': ('ops/sift_device.py', 'the device route is not '
                        "the TPU's"),
}


def test_every_module_has_a_counterpart():
    """Each .py module of s2p_tpu/ has a file of the same name and place
    in s2p_tpu_torch/, or the renamed one listed in RENAMED."""
    jax_pkg = os.path.join(ROOT, 's2p_tpu')
    missing = []
    for d, _, files in os.walk(jax_pkg):
        for f in files:
            if not f.endswith('.py'):
                continue
            rel = os.path.relpath(os.path.join(d, f), jax_pkg).replace(
                os.sep, '/')
            port = RENAMED.get(rel, (rel,))[0]
            if not os.path.exists(os.path.join(PKG, *port.split('/'))):
                missing.append(rel)
    assert not missing, missing
    for rel, (port, _) in RENAMED.items():
        assert os.path.exists(os.path.join(ROOT, 's2p_tpu', rel)), rel
        assert not os.path.exists(os.path.join(PKG, rel)), rel
    # the native reader's source has its own copy beside the port
    assert os.path.exists(os.path.join(PKG, 'native', 'tiffio.cpp'))


def test_package_imports_with_jax_blocked():
    code = (
        'import sys\n'
        f'for m in {_BANNED!r}: sys.modules[m] = None\n'
        'import importlib\n'
        f'for m in {_modules()!r}: importlib.import_module(m)\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "s2p_tpu", "PIL") and sys.modules[m] is not None]\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')


def test_entry_points_raise_without_cuda(monkeypatch):
    from s2p_tpu_torch import device, pipeline
    from s2p_tpu_torch.config import Config
    from s2p_tpu_torch.core.matching import compute_disparity_map
    from s2p_tpu_torch.ops import homography, morphology, sift, sift_device
    from s2p_tpu_torch.ops.mgm_flow import (mgm_binary_match,
                                            mgm_binary_match_batch,
                                            mgm_multi_match,
                                            mgm_multi_match_batch)
    from s2p_tpu_torch.ops.mgm_flow import MgmVariant
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.stereo_matching_all(Config(), [])
    a = torch.zeros((1, 8, 8)).numpy()
    with pytest.raises(RuntimeError, match='CUDA'):
        mgm_binary_match_batch(a, a, [0], 4, [8], [8], [8])
    with pytest.raises(RuntimeError, match='CUDA'):
        mgm_binary_match(a[0], a[0], 0, 3)
    with pytest.raises(RuntimeError, match='CUDA'):
        compute_disparity_map(Config(), a[0], a[0], 0, 3)
    with pytest.raises(RuntimeError, match='CUDA'):
        mgm_multi_match(a[0], a[0], 0, 3, MgmVariant())
    with pytest.raises(RuntimeError, match='CUDA'):
        mgm_multi_match_batch(a, a, [0], 4, [8], [8], [8], [4])
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.stereo_matching(Config(), {'dir': 'tile'}, 1)
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.rectification_all(Config(), [])
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.rectification_pair(Config(), {}, 1)
    with pytest.raises(RuntimeError, match='CUDA'):
        homography.warp_jobs_batched([(a[0], np.eye(3), 4, 4)])
    with pytest.raises(RuntimeError, match='CUDA'):
        homography.image_apply_homography(a[0], np.eye(3), 4, 4)
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.pointing_correction_all(Config(), [])
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.disparity_to_ply(Config(), {})
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.disparity_to_height_all(Config(), [])
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.heights_to_ply_all(Config(), [])
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.heights_fusion(Config(), {'dir': 'tile'})
    with pytest.raises(RuntimeError, match='CUDA'):
        morphology.morphoop(a[0], 'min', 5)
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.main({'images': [{'img': 'a.tif'}, {'img': 'b.tif'}]})
    with pytest.raises(RuntimeError, match='CUDA'):
        sift_device.keypoints_from_arrays([a[0]], [0.0133])
    with pytest.raises(RuntimeError, match='CUDA'):
        sift.matches_on_rpc_roi_batch([])
    with pytest.raises(RuntimeError, match='CUDA'):
        sift.keypoints_match(np.ones((2, 132)), np.ones((2, 132)))
    from s2p_tpu_torch.ops import sgm
    from s2p_tpu_torch.parallel import mesh
    with pytest.raises(RuntimeError, match='CUDA'):
        sgm.sgm_match(a[0], a[0], 0, 3, sgm.SgmParams())
    with pytest.raises(RuntimeError, match='CUDA'):
        compute_disparity_map(Config(matching_algorithm='sgbm'), a[0], a[0],
                              0, 3)
    with pytest.raises(RuntimeError, match='CUDA'):
        mesh.TileMesh()
    from s2p_tpu_torch.ops import asift, msmw, tvl1
    with pytest.raises(RuntimeError, match='CUDA'):
        sgm.sgm_match_batch(a, a, [0], 4, sgm.SgmParams())
    with pytest.raises(RuntimeError, match='CUDA'):
        msmw.disparity(a[0], a[0], 0, 3)
    with pytest.raises(RuntimeError, match='CUDA'):
        tvl1.disparity(a[0], a[0])
    for algo in ('msmw', 'hirschmuller02', 'tvl1'):
        with pytest.raises(RuntimeError, match='CUDA'):
            compute_disparity_map(Config(matching_algorithm=algo), a[0],
                                  a[0], 0, 3)
    with pytest.raises(RuntimeError, match='CUDA'):
        asift.keypoints(np.zeros((40, 40), np.float32), n_tilts=1)
    with pytest.raises(RuntimeError, match='CUDA'):
        device.resolve('cuda')
    assert device.resolve('cpu') == torch.device('cpu')


def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke run exits non-zero and prints no result."""
    code = ('import sys, torch\n'
            'torch.cuda.is_available = lambda: False\n'
            'sys.argv = ["chip_smoke.py"]\n'
            'import runpy\n'
            'runpy.run_path("chip_smoke.py", run_name="__main__")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_build_is_lazy_and_keyed_by_sources():
    from s2p_tpu_torch.ops import _build
    assert not _build._libs
    d = _build.build_dir()
    assert d.startswith(os.path.join(PKG, '_build'))
    assert d == _build.build_dir()
    assert sorted(os.path.basename(p) for p in os.listdir(
        os.path.join(PKG, 'csrc'))) == sorted(
            n + '.cu' for n in _build.SOURCES)
