"""Several processes over one scene or one batch of tiles: the process
group and tile blocks (:mod:`.distributed`), the matcher and the global
mean over ranks (:mod:`.mesh`), and the halo exchange of the rasterizer
and the global pointing fit (:mod:`.halo`)."""

from .mesh import TileMesh, batch_tiles, sharded_matching_step  # noqa: F401
from .halo import sharded_dsm, distributed_pointing_fit  # noqa: F401
