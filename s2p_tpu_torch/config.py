"""Immutable pipeline configuration (the port's own copy).

The fields, their JSON names and their defaults are those of the s2p JSON
config schema (reference s2p ``config.py``), so one config file drives
either package, and ``Config.dump_json`` writes the same ``config.json``
as the JAX package's.  ``state.config_from_state`` builds this class from
the dict of the JAX package's ``Config.to_dict()``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Optional

import numpy as np

# JSON keys that are not valid python identifiers
_ALIASES = {'3d_filtering_r': 'filtering_3d_r',
            '3d_filtering_n': 'filtering_3d_n'}
_ALIASES_INV = {v: k for k, v in _ALIASES.items()}


@dataclasses.dataclass(frozen=True)
class ImageSpec:
    """One input image: path, camera model, and optional masks."""
    img: str
    rpc: Any = None          # path / dict, as given by the user
    rpcm: Any = None         # the loaded RPCModel (geo/rpc.py)
    clr: Optional[str] = None
    cld: Optional[str] = None
    roi: Optional[str] = None
    wat: Optional[str] = None

    def to_dict(self):
        """The image's config entry, without the loaded camera."""
        d = {'img': self.img}
        for f in ('rpc', 'clr', 'cld', 'roi', 'wat'):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        return d


@dataclasses.dataclass(frozen=True)
class Config:
    """All pipeline parameters; defaults mirror the s2p config schema."""

    # inputs / outputs
    out_dir: str = 's2p_output'
    temporary_dir: str = 's2p_tmp'
    clean_tmp: bool = True
    clean_intermediate: bool = False
    full_img: bool = False
    images: tuple = ()
    roi: Optional[dict] = None
    roi_geojson: Any = None

    # tiling
    tile_size: int = 800
    horizontal_margin: int = 50
    vertical_margin: int = 10

    # execution
    max_processes: Optional[int] = None
    max_processes_stereo_matching: Optional[int] = None
    omp_num_threads: int = 1
    timeout: int = 600
    debug: bool = False

    # DSM
    dsm_resolution: float = 4.0
    dsm_radius: float = 0.0
    dsm_sigma: Optional[float] = None

    # SIFT / pointing
    relative_sift_match_thresh: bool = True
    sift_match_thresh: float = 0.6
    sift_device: str = 'auto'
    n_gcp_per_axis: int = 5
    epipolar_thresh: float = 0.5
    max_pointing_error: float = 10.0

    # disparity range policy
    disp_range_extra_margin: float = 0.2
    max_disp_range: Optional[int] = None
    disp_range_method: str = 'wider_sift_exogenous'
    disp_range_exogenous_low_margin: float = -10.0
    disp_range_exogenous_high_margin: float = 100.0
    disp_min: Optional[float] = None
    disp_max: Optional[float] = None
    alt_min: Optional[float] = None
    alt_max: Optional[float] = None

    # rectification
    rectification_method: str = 'rpc'
    register_with_shear: bool = True

    # masks
    border_margin: int = 10
    msk_erosion: int = 2

    # fusion (triplet mode)
    fusion_operator: str = 'average_if_close'
    fusion_thresh: float = 3.0

    # DEMs
    rpc_alt_range_scale_factor: float = 1.0
    use_srtm: bool = False
    exogenous_dem: Optional[str] = None
    exogenous_dem_geoid_mode: bool = True

    # stereo matching
    matching_algorithm: str = 'mgm'
    census_ncc_win: int = 5
    stereo_speckle_filter: int = 25
    stereo_regularity_multiplier: float = 1.0
    mgm_nb_directions: int = 8
    mgm_timeout: int = 600
    mgm_leftright_threshold: float = 1.0
    mgm_leftright_control: int = 1
    mgm_mindiff_control: int = -1

    # postprocessing
    filtering_3d_r: Optional[float] = None
    filtering_3d_n: Optional[int] = None
    cargarse_basura: bool = True

    # output CRS
    out_crs: Optional[str] = None
    out_geoid: bool = False

    # computed at build time
    gsd: Optional[float] = None
    neighborhood_dirs: Optional[list] = None

    @classmethod
    def field_names(cls):
        return {f.name for f in dataclasses.fields(cls)}

    @classmethod
    def from_user_dict(cls, d: dict) -> 'Config':
        """Build a Config from a user dict (the s2p JSON schema)."""
        known = cls.field_names()
        kwargs = {}
        for k, v in d.items():
            key = _ALIASES.get(k, k)
            if key == 'images':
                v = tuple(img if isinstance(img, ImageSpec) else ImageSpec(**img)
                          for img in v)
            if key in known:
                kwargs[key] = v
            else:
                warnings.warn(f'ignoring unknown parameter {k}.')
        return cls(**kwargs)

    def replace(self, **kw) -> 'Config':
        return dataclasses.replace(self, **kw)

    def to_dict(self):
        """The config as the s2p JSON schema's dict: JSON key names, each
        image's entry without its camera, and the fields computed at build
        time only where they are set."""
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == 'images':
                v = [img.to_dict() for img in v]
            if v is None and f.name in ('gsd', 'neighborhood_dirs',
                                        'roi_geojson'):
                continue
            d[_ALIASES_INV.get(f.name, f.name)] = v
        return d

    def dump_json(self, path):
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, indent=2, default=_json_default)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(f'not JSON serializable: {o!r}')


def read_config_file(config_file: str) -> dict:
    """A JSON config file as a plain user dict, its relative paths
    (``out_dir``, ``roi_geojson``, ``exogenous_dem`` and each image's
    files) resolved against the file's directory; the dict can be edited
    before it goes to :func:`s2p_tpu_torch.pipeline.main`."""
    with open(config_file, 'r') as f:
        user_cfg = json.load(f)

    def absolutize(p):
        if not os.path.isabs(p):
            return os.path.join(os.path.abspath(os.path.dirname(config_file)),
                                p)
        return p

    if 'out_dir' in user_cfg:
        user_cfg['out_dir'] = absolutize(user_cfg['out_dir'])
    for k in ('roi_geojson', 'exogenous_dem'):
        if isinstance(user_cfg.get(k), str):
            user_cfg[k] = absolutize(user_cfg[k])
    for img in user_cfg.get('images', []):
        for d in ('img', 'rpc', 'clr', 'cld', 'roi', 'wat'):
            if isinstance(img.get(d), str):
                img[d] = absolutize(img[d])
    return user_cfg
