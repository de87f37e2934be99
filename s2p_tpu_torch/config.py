"""Immutable pipeline configuration (the port's own copy).

The fields, their JSON names and their defaults are those of the s2p JSON
config schema (reference s2p ``config.py``), so one config file drives
either package.  ``state.config_from_state`` builds this class from the
dict of the JAX package's ``Config.to_dict()``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

# JSON keys that are not valid python identifiers
_ALIASES = {'3d_filtering_r': 'filtering_3d_r',
            '3d_filtering_n': 'filtering_3d_n'}


@dataclasses.dataclass(frozen=True)
class ImageSpec:
    """One input image: path, camera model, and optional masks."""
    img: str
    rpc: Any = None
    clr: Optional[str] = None
    cld: Optional[str] = None
    roi: Optional[str] = None
    wat: Optional[str] = None


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
