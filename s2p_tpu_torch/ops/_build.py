"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` launchers that take raw
device pointers, plain integer sizes and a ``cudaStream_t``, and return
``cudaGetLastError()``.  Each source becomes its own shared library,
compiled for Hopper (``sm_90a``) with FMA contraction off (the scan's f32
sums around ``BIG = 1e9`` and the warp's spline weights round differently
when a multiply and an add are fused) and without fast math (the
subpixel and the warp's divisions must round correctly).  The libraries include no PyTorch or Python header, so a
build takes seconds and needs nothing but ``nvcc``.

The build runs at first use, all sources at once, into
``s2p_tpu_torch/_build/<hash>/``, where the hash covers the sources and
the flags; a second build of the same sources is a lookup.  Nothing here
runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

import torch

SOURCES = ('cost_prepass', 'scan', 'scan_mgm', 'wta', 'warp', 'box')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, 'csrc')
_BUILD = os.path.join(_PKG, '_build')

_libs = {}


def _nvcc():
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 shutil.which('nvcc') or '',
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels are built from csrc/ at first use')


def build_dir():
    """The build directory of the current sources and flags."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_CSRC, name + '.cu'), 'rb') as f:
            h.update(name.encode() + b'\0' + f.read())
    return os.path.join(_BUILD, h.hexdigest()[:16])


def build():
    """Compile every missing library, one nvcc per source, all in parallel.

    Returns ({name: library path}, seconds spent compiling)."""
    out = build_dir()
    os.makedirs(out, exist_ok=True)
    libs = {n: os.path.join(out, f'lib{n}.so') for n in SOURCES}
    t0 = time.perf_counter()
    with open(os.path.join(out, 'lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in SOURCES if not os.path.exists(libs[n])]
        if todo:
            nvcc = _nvcc()
            procs = {}
            for n in todo:
                log = open(os.path.join(out, n + '.log'), 'w')
                cmd = [nvcc, *NVCC_FLAGS, '-o', libs[n] + '.tmp',
                       os.path.join(_CSRC, n + '.cu')]
                procs[n] = (subprocess.Popen(cmd, stdout=log,
                                             stderr=subprocess.STDOUT), log)
            failed = []
            for n, (p, log) in procs.items():
                rc = p.wait()
                log.close()
                if rc != 0:
                    failed.append(n)
                else:
                    os.replace(libs[n] + '.tmp', libs[n])
            if failed:
                logs = ''.join(build_log(n) for n in failed)
                raise RuntimeError(f'nvcc failed for {failed}:\n{logs}')
    return libs, time.perf_counter() - t0


def build_log(name):
    """The compiler's output for one source (register and spill counts)."""
    path = os.path.join(build_dir(), name + '.log')
    if not os.path.exists(path):
        return ''
    with open(path) as f:
        return f.read()


def load(name):
    """The ctypes handle of one kernel library, building it if needed."""
    if name not in _libs:
        libs, _ = build()
        _libs[name] = ctypes.CDLL(libs[name])
    return _libs[name]


def call(lib_name, fn_name, argtypes, *args):
    """Call the C launcher ``fn_name`` of one library on the current
    stream; raises with the CUDA error's name if it returns non-zero."""
    lib = load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        err = getattr(lib, f's2p_{lib_name}_error')
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f'{fn_name} launch failed: CUDA error {rc} '
                           f'({err(rc).decode()})')
