"""Point-cloud exporters: Potree / LidarViewer / LAS.

The reference s2p shells out to external converter suites
(``utils/s2p_to_potree.py``, ``s2p_to_lidarviewer.py``); those tools are
not part of this runtime, so the exporters here write the directly
consumable files instead:

  * :func:`write_las` -- LAS 1.2 point records (format 2: xyz + rgb), the
    input format both the Potree and the LidarViewer converters ingest,
  * :func:`export_potree` / :func:`export_lidarviewer` -- run the external
    converter when it is on PATH, else write the LAS file and warn.
"""

from __future__ import annotations

import glob
import os
import shutil
import struct
import subprocess
import warnings

import numpy as np

from ..geo import ply as plymod


def gather_cloud(outdir):
    """Concatenate all tile clouds of a finished run."""
    files = sorted(glob.glob(os.path.join(outdir, 'tiles', '*', '*',
                                          'cloud.ply')))
    arrays = [plymod.read_ply(f)[0] for f in files]
    if not arrays:
        raise FileNotFoundError(f'no cloud.ply under {outdir}')
    width = max(a.shape[1] for a in arrays)
    arrays = [np.pad(a, ((0, 0), (0, width - a.shape[1])))
              if a.shape[1] < width else a for a in arrays]
    return np.vstack(arrays)


def write_las(path, points):
    """Write a minimal LAS 1.2 file (point format 2: xyz + rgb).

    Args:
        points: (n, >=3) array; columns 3:6 taken as rgb if present.
    """
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    mins = pts[:, :3].min(axis=0)
    maxs = pts[:, :3].max(axis=0)
    scale = np.maximum((maxs - mins) / (2 ** 31 - 2), 1e-8)
    offset = mins

    header_size = 227
    point_size = 26  # format 2
    with open(path, 'wb') as f:
        h = bytearray(header_size)
        h[0:4] = b'LASF'
        h[24] = 1   # version major
        h[25] = 2   # version minor
        h[26:26 + 8] = b's2p_tpu\0'
        struct.pack_into('<H', h, 94, header_size)
        struct.pack_into('<I', h, 96, header_size)   # offset to points
        struct.pack_into('<B', h, 104, 2)            # point format 2
        struct.pack_into('<H', h, 105, point_size)
        struct.pack_into('<I', h, 107, n)
        struct.pack_into('<3d', h, 131, *scale)
        struct.pack_into('<3d', h, 155, *offset)
        struct.pack_into('<6d', h, 179, maxs[0], mins[0], maxs[1], mins[1],
                         maxs[2], mins[2])
        f.write(bytes(h))

        xyz_i = np.round((pts[:, :3] - offset) / scale).astype(np.int32)
        rec = np.zeros(n, dtype=[('x', '<i4'), ('y', '<i4'), ('z', '<i4'),
                                 ('intensity', '<u2'), ('flags', 'u1'),
                                 ('cls', 'u1'), ('rank', 'i1'), ('ud', 'u1'),
                                 ('psid', '<u2'),
                                 ('r', '<u2'), ('g', '<u2'), ('b', '<u2')])
        rec['x'], rec['y'], rec['z'] = xyz_i.T
        if pts.shape[1] >= 6:
            rec['r'] = (pts[:, 3].clip(0, 255) * 257).astype(np.uint16)
            rec['g'] = (pts[:, 4].clip(0, 255) * 257).astype(np.uint16)
            rec['b'] = (pts[:, 5].clip(0, 255) * 257).astype(np.uint16)
        f.write(rec.tobytes())


def _export(outdir, target, converter, args):
    os.makedirs(target, exist_ok=True)
    las = os.path.join(target, 'cloud.las')
    write_las(las, gather_cloud(outdir))
    conv = shutil.which(converter)
    if conv:
        subprocess.run([conv, *args(las)], check=True)
    else:
        warnings.warn(f'{converter} not found on PATH; wrote LAS only '
                      f'({las})')
    return las


def export_potree(outdir, target=None):
    """Export a run's cloud for the Potree web viewer (the reference's
    ``utils/s2p_to_potree.py``); returns the LAS file's path."""
    target = target or os.path.join(outdir, 'potree')
    return _export(outdir, target, 'PotreeConverter',
                   lambda las: [las, '-o', target])


def export_lidarviewer(outdir, target=None):
    """Export a run's cloud for lidarviewer (the reference's
    ``utils/s2p_to_lidarviewer.py``); returns the LAS file's path."""
    target = target or os.path.join(outdir, 'lidarviewer')
    return _export(outdir, target, 'LidarPreprocessor',
                   lambda las: ['-f', las, '-o', target])
