"""ctypes binding to the port's native TIFF window reader
(``s2p_tpu_torch/native/tiffio.cpp``).

:func:`s2p_tpu_torch.geo.geotiff.read` sends windowed reads here: the
native reader decodes only the strips or tiles that meet the window, where
the Python reader decodes the whole raster.  The library is built at first
use with the host's C++ compiler (``g++ -O3 -fPIC -shared ... -lz``) into
``s2p_tpu_torch/_build/tiffio-<hash>/``, the hash covering the source and
the flags; a second build of the same source is a lookup.  A failed build
raises with the compiler's output: there is no silent fallback.

Layouts the reader refuses give None, and the caller decodes the file in
Python: LZW and every other compression but none, deflate and PackBits;
planar configuration 2; a predictor other than 1 and 2 (the
floating-point predictor 3 among them); sample types outside
:data:`_DTYPES`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG, 'native', 'tiffio.cpp')
_BUILD = os.path.join(_PKG, '_build')
CXX_FLAGS = ('-O3', '-Wall', '-fPIC', '-std=c++17', '-shared')

# (SampleFormat, BitsPerSample) -> sample type
_DTYPES = {(1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
           (1, 64): np.uint64, (2, 8): np.int8, (2, 16): np.int16,
           (2, 32): np.int32, (2, 64): np.int64, (3, 16): np.float16,
           (3, 32): np.float32, (3, 64): np.float64}
_COMPRESSIONS = (1, 8, 32946, 32773)     # none, deflate (two codes), PackBits

_lib = None


def _compiler():
    for name in ('g++', 'c++'):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError('no C++ compiler (g++ or c++) on PATH: the native '
                       'TIFF reader is built from native/tiffio.cpp at '
                       'first use')


def build_dir():
    """The build directory of the current source and flags."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    with open(_SOURCE, 'rb') as f:
        h.update(f.read())
    return os.path.join(_BUILD, 'tiffio-' + h.hexdigest()[:16])


def build():
    """Compile the library unless it is built; returns its path.  Raises
    RuntimeError with the compiler's output if the build fails."""
    out = build_dir()
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, 'libtiffio.so')
    with open(os.path.join(out, 'lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib):
            cmd = [_compiler(), *CXX_FLAGS, _SOURCE, '-o', lib + '.tmp',
                   '-lz']
            p = subprocess.run(cmd, capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(
                    f'the native TIFF reader failed to build ({" ".join(cmd)}'
                    f'):\n{p.stdout}{p.stderr}')
            os.replace(lib + '.tmp', lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.tiff_open.restype = ctypes.c_void_p
        lib.tiff_open.argtypes = [ctypes.c_char_p]
        lib.tiff_close.argtypes = [ctypes.c_void_p]
        lib.tiff_info.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.tiff_read_window.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
    return _lib


def available():
    """True once the library is built and loaded (raises if it cannot be)."""
    return bool(_load())


def read_window(path, x, y, w, h, clip=False):
    """The window (x, y, w, h) of a TIFF's first image as an (h, w) or
    (h, w, spp) array, zero outside the raster; with ``clip`` the window
    is first cut to the raster, and a window that misses it gives None.
    None too for a file or layout the native reader refuses."""
    lib = _load()
    handle = lib.tiff_open(os.fsencode(path))
    if not handle:
        return None
    try:
        info = (ctypes.c_int64 * 10)()
        if lib.tiff_info(handle, info) != 0:
            return None
        W, H, spp, bps, sf, comp, _, pred, planar, _ = list(info)
        dt = _DTYPES.get((sf, bps))
        if (dt is None or comp not in _COMPRESSIONS or pred not in (1, 2)
                or planar != 1):
            return None
        x, y, w, h = int(x), int(y), int(w), int(h)
        if clip:
            x0, y0 = max(x, 0), max(y, 0)
            x1, y1 = min(x + w, W), min(y + h, H)
            if x1 <= x0 or y1 <= y0:
                return None
            x, y, w, h = x0, y0, x1 - x0, y1 - y0
        out = np.empty((h, w, spp), dtype=dt)
        if lib.tiff_read_window(handle, x, y, w, h,
                                out.ctypes.data_as(ctypes.c_void_p)) != 0:
            return None
        return out[:, :, 0] if spp == 1 else out
    finally:
        lib.tiff_close(handle)
