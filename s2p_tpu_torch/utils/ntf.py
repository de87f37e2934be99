"""Extract the RPC model from an NITF (NTF) file.

Replaces the reference's ``utils/extract_rpc_from_ntf.py`` (which shells
out to gdal_translate): parses the RPC00B TRE from the NITF image
subheader directly.
"""

from __future__ import annotations

import re

import numpy as np

from ..geo.rpc import RPCModel


def _f(s):
    return float(s.decode() if isinstance(s, bytes) else s)


def rpc_from_rpc00b(tre: bytes) -> RPCModel:
    """Decode an RPC00B TRE payload (fixed-width NITF fields)."""
    o = 1 + 7 + 7          # after SUCCESS (1), ERR_BIAS (7), ERR_RAND (7)

    def take(n):
        nonlocal o
        v = tre[o:o + n]
        o += n
        return _f(v)

    row_off, col_off = take(6), take(5)
    lat_off, lon_off, alt_off = take(8), take(9), take(5)
    row_sc, col_sc = take(6), take(5)
    lat_sc, lon_sc, alt_sc = take(8), take(9), take(5)
    c = np.asarray([take(12) for _ in range(80)])
    return RPCModel(row_num=c[0:20], row_den=c[20:40],
                    col_num=c[40:60], col_den=c[60:80],
                    row_offset=row_off, col_offset=col_off,
                    lat_offset=lat_off, lon_offset=lon_off, alt_offset=alt_off,
                    row_scale=row_sc, col_scale=col_sc,
                    lat_scale=lat_sc, lon_scale=lon_sc, alt_scale=alt_sc)


def rpc_from_ntf(path: str) -> RPCModel:
    """Locate the RPC00B TRE in an NITF file and decode it."""
    with open(path, 'rb') as f:
        data = f.read()
    m = re.search(b'RPC00B', data)
    if not m:
        raise ValueError(f'no RPC00B TRE found in {path}')
    # the TRE header is 'RPC00B' and a 5-digit length; the payload follows
    start = m.end() + 5
    length = int(data[m.end():m.end() + 5])
    return rpc_from_rpc00b(data[start:start + length])
