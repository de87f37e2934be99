"""State carried across from the JAX package.

s2p has no learned weights: the state that decides what stage 4 computes
is the matcher's configuration.  These functions take the plain dicts the
JAX package produces (``dataclasses.asdict`` of its ``MgmVariant`` and
``SgmParams``, and ``Config.to_dict()``) and build the port's own classes, so that both
packages run on exactly the same settings.  Nothing of the JAX package is
imported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import Config
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


def config_from_state(d: dict) -> Config:
    """The port's Config from the JAX ``Config.to_dict()``."""
    return Config.from_user_dict({k: _plain(v) for k, v in d.items()})
