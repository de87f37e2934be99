"""Multi-pair height-map fusion (the triplet's stage 5d).

A copy of ``s2p_tpu/core/fusion.py`` (host numpy): merge the n - 1
per-pair height maps of a tile after subtracting each pair's global mean
offset.  The ``average_if_close`` operator takes the nanmedian where the
stack's spread is within a threshold and NaN elsewhere, vectorized over
the whole stack.
"""

from __future__ import annotations

import numpy as np


def average_if_close_stack(x, threshold):
    """Per-pixel nanmedian of the stack where nanmax - nanmin <= threshold,
    NaN elsewhere.

    Args:
        x: (h, w, n) stack.
    """
    with np.errstate(invalid='ignore'):
        spread = np.nanmax(x, axis=2) - np.nanmin(x, axis=2)
        med = np.nanmedian(x, axis=2)
    out = np.where(spread > threshold, np.nan, med)
    return out


def merge_n_arrays(maps, offsets, averaging='average_if_close', threshold=1):
    """Merge n equally-sized height maps with per-map offsets.

    Args:
        maps: list of (h, w) arrays.
        offsets: list of scalars subtracted from each map before averaging;
            their mean is added back after.
        averaging: 'average_if_close' or a numpy reduction name like
            'np.nanmedian'.
        threshold: the spread above which ``average_if_close`` gives NaN.

    Returns:
        (h, w) float64 merged array.
    """
    assert len(maps) == len(offsets)
    x = np.stack([np.asarray(m, dtype=np.float64) - o
                  for m, o in zip(maps, offsets)], axis=2)
    if averaging == 'average_if_close':
        avg = average_if_close_stack(x, threshold)
    else:
        name = averaging.split('.')[-1]
        with np.errstate(invalid='ignore'):
            avg = getattr(np, name)(x, axis=2)
    return avg + np.mean(offsets)
