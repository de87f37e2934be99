"""PLY point-cloud IO (the port's own copy of ``s2p_tpu.geo.ply``, numpy
only; it replaces the ``plyfile`` dependency of the reference s2p).

Reads ascii and binary_little_endian PLY files into numpy record arrays and
writes binary clouds with the same property layout the reference emits:
x, y, z (float64 or float32), red, green, blue (uchar), optional extra float
properties (e.g. confidence).
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    'char': 'i1', 'uchar': 'u1', 'int8': 'i1', 'uint8': 'u1',
    'short': 'i2', 'ushort': 'u2', 'int16': 'i2', 'uint16': 'u2',
    'int': 'i4', 'uint': 'u4', 'int32': 'i4', 'uint32': 'u4',
    'float': 'f4', 'float32': 'f4', 'double': 'f8', 'float64': 'f8',
}
_INV_TYPES = {'u1': 'uchar', 'i1': 'char', 'u2': 'ushort', 'i2': 'short',
              'u4': 'uint', 'i4': 'int', 'f4': 'float', 'f8': 'double'}


def read_ply(path):
    """Read a PLY vertex cloud.

    Returns:
        (array, comments): array of shape (n, n_props) float64 with one point
        per row (same convention as reference ply.py:7-21), and the list of
        header comment strings.
    """
    with open(path, 'rb') as f:
        data = f.read()

    end = data.index(b'end_header\n') + len(b'end_header\n')
    header = data[:end].decode('latin1').splitlines()
    body = data[end:]

    fmt = 'ascii'
    n_vertex = 0
    props = []
    comments = []
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == 'format':
            fmt = parts[1]
        elif parts[0] == 'comment':
            comments.append(line.split(' ', 1)[1] if ' ' in line else '')
        elif parts[0] == 'element':
            in_vertex = parts[1] == 'vertex'
            if in_vertex:
                n_vertex = int(parts[2])
        elif parts[0] == 'property' and in_vertex:
            props.append((parts[2], _PLY_TYPES[parts[1]]))

    if fmt == 'ascii':
        arr = np.loadtxt(body.decode('latin1').splitlines(), dtype=np.float64,
                         max_rows=n_vertex)
        arr = arr.reshape(n_vertex, len(props))
    else:
        endian = '<' if 'little' in fmt else '>'
        dt = np.dtype([(name, endian + t) for name, t in props])
        rec = np.frombuffer(body, dtype=dt, count=n_vertex)
        arr = np.column_stack([rec[name].astype(np.float64) for name, _ in props])
    return arr, comments


def write_ply(path, coords, colors=None, extra=None, extra_names=None,
              comments=()):
    """Write a binary PLY cloud (reference ply.py:24-64 layout).

    Args:
        coords: (n, 3) float array of x, y, z.
        colors: optional (n, 1|3|4) uint8 array.
        extra: optional (n,) or (n, k) float32 array of extra properties.
        extra_names: names for the extra properties.
    """
    coords = np.asarray(coords)
    n = len(coords)
    fields = [('x', coords.dtype), ('y', coords.dtype), ('z', coords.dtype)]
    cols = [coords[:, 0], coords[:, 1], coords[:, 2]]

    if colors is not None:
        colors = np.asarray(colors)
        if colors.ndim == 1:
            colors = colors[:, None]
        if colors.shape[1] == 1:
            colors = np.repeat(colors, 3, axis=1)
        names = ['red', 'green', 'blue', 'ir'][:colors.shape[1]]
        for k, name in enumerate(names):
            fields.append((name, colors.dtype))
            cols.append(colors[:, k])

    if extra is not None:
        extra = np.atleast_2d(np.asarray(extra, dtype=np.float32))
        if extra.shape[0] != n:
            extra = extra.T
        extra_names = extra_names or [f'extra{k}' for k in range(extra.shape[1])]
        for k, name in enumerate(extra_names):
            fields.append((name, np.float32))
            cols.append(extra[:, k])

    dt = np.dtype([(name, np.dtype(t).str) for name, t in fields])
    rec = np.empty(n, dtype=dt)
    for (name, _), col in zip(fields, cols):
        rec[name] = col

    with open(path, 'wb') as f:
        f.write(b'ply\n')
        f.write(b'format binary_little_endian 1.0\n')
        for c in comments:
            f.write(f'comment {c}\n'.encode('latin1'))
        f.write(f'element vertex {n}\n'.encode())
        for name, t in fields:
            f.write(f'property {_INV_TYPES[np.dtype(t).str[-2:]]} {name}\n'.encode())
        f.write(b'end_header\n')
        f.write(rec.tobytes())
