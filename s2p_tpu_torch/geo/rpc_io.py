"""Loading RPC camera models from the usual satellite-product containers
(the port's own copy of ``s2p_tpu/geo/rpc_io.py``, numpy only).

Supported sources (the set the reference s2p reaches through ``rpcm``):

  * GeoTIFF baseline tag 50844 (RPCCoefficientTag, 92 doubles),
  * Ikonos/WorldView style ``.rpc`` / ``.txt`` files (``LINE_OFF: +03067.21 pixels``),
  * WorldView ``.rpb`` files (``lineOffset = +0306721;``),
  * Pleiades DIMAP XML files (``<Inverse_Model>`` blocks).

All loaders return :class:`s2p_tpu_torch.geo.rpc.RPCModel`.
"""

from __future__ import annotations

import re

import numpy as np

from .rpc import RPCModel

# Layout of TIFF tag 50844 (RPCs in GeoTIFF spec):
#   0: ERR_BIAS  1: ERR_RAND
#   2: LINE_OFF  3: SAMP_OFF  4: LAT_OFF  5: LONG_OFF  6: HEIGHT_OFF
#   7: LINE_SCALE 8: SAMP_SCALE 9: LAT_SCALE 10: LONG_SCALE 11: HEIGHT_SCALE
#   12..31: LINE_NUM  32..51: LINE_DEN  52..71: SAMP_NUM  72..91: SAMP_DEN
RPC_TIFF_TAG = 50844


def rpc_from_tag_values(values) -> RPCModel:
    """Build an RPCModel from the 92 doubles of TIFF tag 50844."""
    t = np.asarray(values, dtype=np.float64)
    if t.size != 92:
        raise ValueError(f'RPC TIFF tag must have 92 values, got {t.size}')
    return RPCModel(
        row_offset=t[2], col_offset=t[3],
        lat_offset=t[4], lon_offset=t[5], alt_offset=t[6],
        row_scale=t[7], col_scale=t[8],
        lat_scale=t[9], lon_scale=t[10], alt_scale=t[11],
        row_num=t[12:32], row_den=t[32:52],
        col_num=t[52:72], col_den=t[72:92],
    )


def rpc_to_tag_values(rpc: RPCModel):
    """Inverse of :func:`rpc_from_tag_values` (ERR_BIAS/ERR_RAND set to -1)."""
    t = np.empty(92, dtype=np.float64)
    t[0] = t[1] = -1.0
    t[2], t[3] = rpc.row_offset, rpc.col_offset
    t[4], t[5], t[6] = rpc.lat_offset, rpc.lon_offset, rpc.alt_offset
    t[7], t[8] = rpc.row_scale, rpc.col_scale
    t[9], t[10], t[11] = rpc.lat_scale, rpc.lon_scale, rpc.alt_scale
    t[12:32], t[32:52] = rpc.row_num, rpc.row_den
    t[52:72], t[72:92] = rpc.col_num, rpc.col_den
    return t


def rpc_from_geotiff(path: str) -> RPCModel:
    """Read the RPC model stored in the tags of a GeoTIFF file."""
    from . import geotiff
    values = geotiff.read_tag(path, RPC_TIFF_TAG)
    if values is None:
        raise ValueError(f'no RPC tag ({RPC_TIFF_TAG}) in {path}')
    return rpc_from_tag_values(values)


# --------------------------------------------------------------------- #
# Text formats
# --------------------------------------------------------------------- #

_IKONOS_SCALARS = {
    'LINE_OFF': 'row_offset', 'SAMP_OFF': 'col_offset',
    'LAT_OFF': 'lat_offset', 'LONG_OFF': 'lon_offset', 'HEIGHT_OFF': 'alt_offset',
    'LINE_SCALE': 'row_scale', 'SAMP_SCALE': 'col_scale',
    'LAT_SCALE': 'lat_scale', 'LONG_SCALE': 'lon_scale', 'HEIGHT_SCALE': 'alt_scale',
}
_IKONOS_VECTORS = {
    'LINE_NUM_COEFF': 'row_num', 'LINE_DEN_COEFF': 'row_den',
    'SAMP_NUM_COEFF': 'col_num', 'SAMP_DEN_COEFF': 'col_den',
}

_RPB_SCALARS = {
    'lineOffset': 'row_offset', 'sampOffset': 'col_offset',
    'latOffset': 'lat_offset', 'longOffset': 'lon_offset', 'heightOffset': 'alt_offset',
    'lineScale': 'row_scale', 'sampScale': 'col_scale',
    'latScale': 'lat_scale', 'longScale': 'lon_scale', 'heightScale': 'alt_scale',
}
_RPB_VECTORS = {
    'lineNumCoef': 'row_num', 'lineDenCoef': 'row_den',
    'sampNumCoef': 'col_num', 'sampDenCoef': 'col_den',
}

_FLOAT_RE = re.compile(r'[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?')


def _parse_ikonos(text: str) -> RPCModel:
    d = {}
    for key, field in _IKONOS_SCALARS.items():
        m = re.search(rf'^{key}\s*:\s*([-+0-9.eE]+)', text, re.M)
        if not m:
            raise ValueError(f'missing {key} in RPC text file')
        d[field] = float(m.group(1))
    for key, field in _IKONOS_VECTORS.items():
        vals = []
        for i in range(1, 21):
            m = re.search(rf'^{key}_{i}\s*:\s*([-+0-9.eE]+)', text, re.M)
            if not m:
                raise ValueError(f'missing {key}_{i} in RPC text file')
            vals.append(float(m.group(1)))
        d[field] = np.array(vals)
    return RPCModel(**d)


def _parse_rpb(text: str) -> RPCModel:
    d = {}
    for key, field in _RPB_SCALARS.items():
        m = re.search(rf'{key}\s*=\s*([-+0-9.eE]+)\s*;', text)
        if not m:
            raise ValueError(f'missing {key} in RPB file')
        d[field] = float(m.group(1))
    for key, field in _RPB_VECTORS.items():
        m = re.search(rf'{key}\s*=\s*\(([^)]*)\)\s*;', text, re.S)
        if not m:
            raise ValueError(f'missing {key} in RPB file')
        vals = [float(v) for v in _FLOAT_RE.findall(m.group(1))]
        if len(vals) != 20:
            raise ValueError(f'{key} must have 20 coefficients, got {len(vals)}')
        d[field] = np.array(vals)
    return RPCModel(**d)


def _parse_dimap(text: str) -> RPCModel:
    """Parse a Pleiades DIMAP V2 RPC XML file (Inverse_Model = ground->image).

    DIMAP stores image coordinates with a 1-based convention (pixel centers at
    integer coordinates starting from 1) while the RPC standard (and s2p) use
    0-based coordinates: subtract 1 from the offsets, as rpcm does.
    """
    import xml.etree.ElementTree as ET
    root = ET.fromstring(text)

    def findtext(tag):
        el = root.find(f'.//{tag}')
        if el is None or el.text is None:
            raise ValueError(f'missing {tag} in DIMAP RPC file')
        return el.text

    d = {
        'row_offset': float(findtext('LINE_OFF')) - 1.0,
        'col_offset': float(findtext('SAMP_OFF')) - 1.0,
        'lat_offset': float(findtext('LAT_OFF')),
        'lon_offset': float(findtext('LONG_OFF')),
        'alt_offset': float(findtext('HEIGHT_OFF')),
        'row_scale': float(findtext('LINE_SCALE')),
        'col_scale': float(findtext('SAMP_SCALE')),
        'lat_scale': float(findtext('LAT_SCALE')),
        'lon_scale': float(findtext('LONG_SCALE')),
        'alt_scale': float(findtext('HEIGHT_SCALE')),
    }
    inv = root.find('.//Inverse_Model')
    if inv is None:
        inv = root  # some products put the coefficients at top level
    for xml_prefix, field in (('SAMP_NUM_COEFF', 'col_num'),
                              ('SAMP_DEN_COEFF', 'col_den'),
                              ('LINE_NUM_COEFF', 'row_num'),
                              ('LINE_DEN_COEFF', 'row_den')):
        vals = []
        for i in range(1, 21):
            el = inv.find(f'.//{xml_prefix}_{i}')
            if el is None:
                raise ValueError(f'missing {xml_prefix}_{i} in DIMAP RPC file')
            vals.append(float(el.text))
        d[field] = np.array(vals)
    return RPCModel(**d)


def rpc_from_rpc_file(path: str) -> RPCModel:
    """Load an RPC model from a text/XML sidecar file, sniffing the format."""
    with open(path, 'r', errors='replace') as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith('<'):
        return _parse_dimap(text)
    if 'lineOffset' in text or 'LINE_OFF =' in text:
        return _parse_rpb(text)
    return _parse_ikonos(text)


def load_rpc(spec) -> RPCModel:
    """Resolve an RPC from a config 'rpc' entry: path, dict, or RPCModel."""
    if isinstance(spec, RPCModel):
        return spec
    if isinstance(spec, dict):
        return RPCModel.from_dict(spec)
    if isinstance(spec, str):
        return rpc_from_rpc_file(spec)
    raise NotImplementedError(f'rpc of type {type(spec)} not supported')
