"""Tile validity masks: the erosion step of stage 4.

Counterpart of ``erosion`` in ``s2p_tpu/core/masking.py``; the GML and
raster mask readers are stage-1 work (ROADMAP M9).
"""

from __future__ import annotations

from ..ops.morphology import binary_erosion


def erosion(mask, radius):
    """Disk erosion of a boolean mask."""
    return binary_erosion(mask, radius)
