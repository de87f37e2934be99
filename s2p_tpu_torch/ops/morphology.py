"""Disk erosion of validity masks (the reference's ``morsi`` step).

Counterpart of ``disk`` and ``binary_erosion`` in
``s2p_tpu/ops/morphology.py``; the other ops of that module are off the
stage-4 path and not ported yet (ROADMAP M12).
"""

from __future__ import annotations

import numpy as np


def disk(radius: int):
    """Boolean disk structuring element of the given radius."""
    r = int(radius)
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    return (xx * xx + yy * yy) <= r * r


def binary_erosion(mask, radius):
    """Erode a boolean mask with a disk (skipped for radius < 2, as the
    reference's masking step does)."""
    if radius < 2:
        return np.asarray(mask).astype(bool)
    from scipy import ndimage
    return ndimage.binary_erosion(np.asarray(mask).astype(bool),
                                  structure=disk(int(radius)))
