"""State carried across from the JAX package.

s2p has no learned weights: the state that decides what stages 4 and 5
compute is the matcher's configuration and the cameras' RPC models.
These functions take the plain dicts the JAX package produces
(``dataclasses.asdict`` of its ``MgmVariant``, ``SgmParams`` and
``RPCModel``, ``RpcParams._asdict()``, and ``Config.to_dict()``) and
build the port's own classes, so that both packages run on exactly the
same settings and cameras.  Nothing of the JAX package is imported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import Config
from .geo.rpc import RPCModel, RpcParams
from .ops.mgm_flow import MgmVariant
from .ops.sgm import SgmParams

# The JAX variant's and parameters' ``backend`` picks between its Pallas, lax and interpret
# routes; in the port the device of the tensors makes that choice.
_VARIANT_DROPPED = ('backend',)


def _plain(v):
    """numpy scalars and arrays -> python values."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def variant_from_state(d: dict) -> MgmVariant:
    """The port's MgmVariant from ``dataclasses.asdict`` of the JAX one."""
    known = {f.name for f in dataclasses.fields(MgmVariant)}
    unknown = set(d) - known - set(_VARIANT_DROPPED)
    if unknown:
        raise ValueError(f'unknown MgmVariant fields: {sorted(unknown)}')
    return MgmVariant(**{k: _plain(v) for k, v in d.items() if k in known})


def sgm_params_from_state(d: dict) -> SgmParams:
    """The port's SgmParams from ``dataclasses.asdict`` of the JAX one."""
    known = {f.name for f in dataclasses.fields(SgmParams)}
    unknown = set(d) - known - set(_VARIANT_DROPPED)
    if unknown:
        raise ValueError(f'unknown SgmParams fields: {sorted(unknown)}')
    return SgmParams(**{k: _plain(v) for k, v in d.items() if k in known})


def rpc_from_state(d) -> RPCModel:
    """The port's RPCModel from the fields of a JAX ``RPCModel`` or
    ``RpcParams``: a dict of them (``dataclasses.asdict``,
    ``RPCModel.to_dict()``, ``RpcParams._asdict()``) or the object
    itself.  Coefficients are kept as float64 numpy arrays, scales and
    offsets as floats."""
    if not isinstance(d, dict):
        d = {f: getattr(d, f) for f in RpcParams._fields}
    missing = set(RpcParams._fields) - set(d)
    if missing:
        raise ValueError(f'RPC fields missing: {sorted(missing)}')
    kw = {}
    for f in RpcParams._fields:
        v = np.asarray(d[f], dtype=np.float64)
        kw[f] = v if v.ndim else float(v)
    return RPCModel(**kw)


def config_from_state(d: dict) -> Config:
    """The port's Config from the JAX ``Config.to_dict()``.  An image
    entry may carry its loaded camera under ``rpcm`` (a JAX ``RPCModel``
    or the dict of its fields), which ``to_dict`` leaves out; it becomes
    the port's :class:`RPCModel` (:func:`rpc_from_state`)."""
    d = {k: _plain(v) for k, v in d.items()}
    if 'images' in d:
        d['images'] = [
            dict(img, rpcm=rpc_from_state(img['rpcm']))
            if isinstance(img, dict) and img.get('rpcm') is not None
            else img for img in d['images']]
    return Config.from_user_dict(d)
