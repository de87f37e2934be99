"""Morphological and connected-component raster ops.

Counterpart of ``s2p_tpu/ops/morphology.py``: the disk erosion of
validity masks (the reference's ``morsi`` step), the NaN-ignoring square
min and max (``morphoop``), the removal of small connected components of
height and disparity maps, and the ``cargarse_basura`` despeckling of the
triplet's height maps (stage 5d).

:func:`morphoop` runs as torch code on the device the caller names (the
JAX package's is a jitted jnp program, not a Pallas kernel).  The
connected components under a value-similarity edge predicate are solved
exactly on the host with scipy's sparse union-find, as there: the grids
are tile-sized.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve


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


def morphoop(img, operation, size, device=None):
    """NaN-ignoring min (``operation`` 'min') or max (anything else) over
    the size x size square about each pixel of a float image.

    NaN pixels and the border take +inf (min) or -inf (max), so a window
    of NaN only gives that infinity; the reduction is the JAX package's
    shifted ``minimum``/``maximum`` over the window's size * size offsets,
    on float32 tensors on ``device`` (None: CUDA, raising without it).
    Returns a float32 numpy array.  Equal to the JAX package's by value
    (the sign of a zero may differ)."""
    dev = resolve(device)
    x = torch.as_tensor(np.asarray(img, dtype=np.float32), device=dev)
    big = float('inf') if operation == 'min' else float('-inf')
    reduce = torch.minimum if operation == 'min' else torch.maximum
    filled = torch.where(torch.isnan(x), big, x)
    r = size // 2
    pad = torch.nn.functional.pad(filled, (r, r, r, r), value=big)
    h, w = x.shape
    acc = None
    for dy in range(size):
        for dx in range(size):
            win = pad[dy:dy + h, dx:dx + w]
            acc = win if acc is None else reduce(acc, win)
    return acc.cpu().numpy()


def _similarity_components(img, valid, tol):
    """Exact connected components of ``valid`` pixels where 4-neighbours
    connect iff |img[p] - img[q]| <= tol.

    Returns (labels, sizes): labels is -1 outside ``valid``.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    h, w = img.shape
    idx = np.arange(h * w).reshape(h, w)

    rows = []
    cols = []
    # vertical edges
    ev = valid[:-1] & valid[1:] & (np.abs(img[:-1] - img[1:]) <= tol)
    rows.append(idx[:-1][ev])
    cols.append(idx[1:][ev])
    # horizontal edges
    eh = valid[:, :-1] & valid[:, 1:] & (np.abs(img[:, :-1] - img[:, 1:])
                                         <= tol)
    rows.append(idx[:, :-1][eh])
    cols.append(idx[:, 1:][eh])

    r = np.concatenate(rows)
    c = np.concatenate(cols)
    g = coo_matrix((np.ones(len(r), dtype=np.int8), (r, c)),
                   shape=(h * w, h * w))
    n, lab = connected_components(g, directed=False)
    lab = lab.reshape(h, w)
    # restrict to valid pixels; component sizes over valid pixels only
    lab = np.where(valid, lab, -1)
    sizes = np.bincount(lab[valid], minlength=n)
    return lab, sizes


def remove_small_components(img, min_area=200, connect_tol=5.0):
    """NaN-out connected components smaller than ``min_area`` pixels; two
    finite 4-neighbours belong to one component when their values differ
    by at most ``connect_tol`` (imscript's ``remove_small_cc``)."""
    img = np.asarray(img, dtype=np.float32).copy()
    valid = np.isfinite(img)
    if not valid.any():
        return img
    lab, sizes = _similarity_components(np.nan_to_num(img), valid,
                                        connect_tol)
    small = sizes < min_area
    kill = valid & small[np.maximum(lab, 0)]
    img[kill] = np.nan
    return img


def despeckle_height_map(img, se=5, diff_thresh=5.0, min_area=200,
                         connect_tol=5.0, device=None):
    """Height-map clean-up, the ``cargarse_basura`` steps:

    1. NaN-out pixels where the local (se x se) max - min range exceeds
       ``diff_thresh`` metres (:func:`morphoop` on ``device``);
    2. remove connected components smaller than ``min_area`` pixels
       (host).
    """
    img = np.asarray(img, dtype=np.float32)
    mx = morphoop(img, 'max', se, device)
    mn = morphoop(img, 'min', se, device)
    rng = np.abs(mx - mn)
    out = np.where(rng > diff_thresh, np.nan, img)
    return remove_small_components(out, min_area, connect_tol)


def remove_small_disparity_speckles(disp, valid, min_area=25, tol=1.0):
    """Speckle filter for disparity maps (mgm's REMOVESMALLCC stage): the
    validity with connected regions smaller than ``min_area`` removed,
    where pixels connect when |d1 - d2| <= tol."""
    disp = np.asarray(disp, dtype=np.float32)
    valid = np.asarray(valid).astype(bool)
    if not valid.any():
        return valid
    lab, sizes = _similarity_components(np.nan_to_num(disp), valid, tol)
    small = sizes < min_area
    return valid & ~small[np.maximum(lab, 0)]
