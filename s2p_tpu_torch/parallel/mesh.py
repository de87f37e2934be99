"""Tile batches over the ranks of a process group.

Counterpart of ``s2p_tpu/parallel/mesh.py``.  The JAX package shards the
tile axis of a batch over a device mesh inside one program; the port
splits it into contiguous blocks over the ranks of the gloo group
(:mod:`.distributed`), one device per rank, and gathers the results on
every rank.  In one process (no group) the mesh has one rank and the
functions run the whole batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as tdist

from ..device import resolve
from .distributed import partition_tiles, process_count, process_index


class TileMesh:
    """The ranks of the process group (or this process alone): their
    count ``n``, this process's ``rank`` and its ``device``.

    ``device`` None takes CUDA device ``rank % device_count`` (raising
    without CUDA); "cpu" runs the plain versions."""

    def __init__(self, device=None):
        self.n = process_count()
        self.rank = process_index()
        dev = resolve(device)
        if device is None:
            dev = torch.device('cuda', self.rank % torch.cuda.device_count())
        self.device = dev

    def block(self, items):
        """This rank's contiguous block of ``items``."""
        return partition_tiles(items, self.rank, self.n)

    def gather(self, obj):
        """Every rank's ``obj``, in rank order (a list of one in one
        process)."""
        if self.n == 1:
            return [obj]
        out = [None] * self.n
        tdist.all_gather_object(out, obj)
        return out

    def all_sum(self, t):
        """The sum over ranks of a tensor, on the tensor's device (the
        reduction itself runs on the CPU, as gloo takes it)."""
        if self.n == 1:
            return t
        c = t.detach().cpu().contiguous()
        tdist.all_reduce(c)
        return c.to(t.device)


def batch_tiles(images, pad_shape=None, pad_value=np.nan, multiple=8):
    """Stack variable-shaped tile rasters into one padded batch.

    Args:
        images: list of 2D arrays.
        pad_shape: target (h, w); defaults to the max shape rounded up to
            ``multiple``.
    Returns:
        (batch (n, H, W) float32, list of the original (h, w))."""
    shapes = [im.shape for im in images]
    if pad_shape is None:
        H = max(s[0] for s in shapes)
        W = max(s[1] for s in shapes)
        H = int(math.ceil(H / multiple)) * multiple
        W = int(math.ceil(W / multiple)) * multiple
    else:
        H, W = pad_shape
    out = np.full((len(images), H, W), pad_value, dtype=np.float32)
    for k, im in enumerate(images):
        h, w = im.shape
        out[k, :h, :w] = im
    return out, shapes


def sharded_matching_step(mesh: TileMesh, im1_batch, im2_batch,
                          disp_min: int, disp_max: int, params=None):
    """The census + SGM matcher (:func:`ops.sgm.sgm_match`) over a tile
    batch split in contiguous blocks over the mesh's ranks.

    Args:
        im1_batch, im2_batch: (n, H, W) arrays, n a multiple of mesh.n.
    Returns:
        dict of (n, H, W) numpy outputs on every rank: 'disp', 'valid'
        and 'confidence'."""
    from ..ops.sgm import SgmParams, sgm_match

    params = params or SgmParams()
    n = len(im1_batch)
    if n % mesh.n:
        raise ValueError(f'{n} tiles do not split over {mesh.n} ranks')
    outs = []
    for a, b in zip(mesh.block(list(im1_batch)), mesh.block(list(im2_batch))):
        r = sgm_match(a, b, disp_min, disp_max, params, device=mesh.device)
        outs.append({k: v.cpu().numpy() for k, v in r.items()})
    blocks = [o for part in mesh.gather(outs) for o in part]
    return {k: np.stack([o[k] for o in blocks])
            for k in ('disp', 'valid', 'confidence')}


def global_mean_height_allreduce(mesh: TileMesh, alt_batch):
    """Mean of the finite altitudes of a batch of per-tile grids: each
    rank's ``nansum`` and finite count over its block, summed over the
    ranks."""
    n = len(alt_batch)
    if n % mesh.n:
        raise ValueError(f'{n} tiles do not split over {mesh.n} ranks')
    block = mesh.block(list(alt_batch))
    alts = torch.as_tensor(np.asarray(block, np.float32), device=mesh.device)
    s = mesh.all_sum(torch.nansum(alts).reshape(1))
    cnt = mesh.all_sum(torch.isfinite(alts).sum().to(torch.float32)
                       .reshape(1))
    return float((s / torch.clamp(cnt, min=1.0))[0])
