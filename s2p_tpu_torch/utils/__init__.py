"""Post-processing tools of a finished run (the port's copy of
``s2p_tpu/utils/``, host numpy on the port's ``geo`` modules): mosaics,
tile maps, cloud exporters, rescaling, NITF RPC extraction."""

from . import exporters, mosaic, scale, tilemap  # noqa: F401
