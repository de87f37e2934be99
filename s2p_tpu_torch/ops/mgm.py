"""The MGM path aggregation (Facciolo BMVC'15) as a skewed wavefront.

Counterpart of ``s2p_tpu/ops/mgm.py``.  The MGM recursion at a pixel reads
the aggregated costs of up to ``tsgm`` causal neighbours of the raster
traversal (W, NE, N, NW for a top-down, left-right raster).  Skewed along
``t = x + 2y``, every such neighbour lies in one of the three previous
diagonals:

    W  = (y, x-1)   -> t-1, same row
    NE = (y-1, x+1) -> t-1, row above
    N  = (y-1, x)   -> t-2, row above
    NW = (y-1, x-1) -> t-3, row above

so a loop over t with a carry of three (n_dir, H, D) slabs evaluates the
raster-order recursion exactly, each step a vectorised min-convolution.
One forward loop runs the traversals whose primary direction is causal;
flipping the volume gives the other ones.  The result applies the
binary's overcount fix ``S - (n - 1) * cost``.

The float32 order is the JAX package's: at each step, each traversal sums
its neighbours' terms in its fan's order, divides by their count and adds
the cost; the traversals' volumes add in direction order.  The loop is
plain torch on the tensors' device (no kernel: the JAX function reaches
no Pallas kernel), so on a GPU each step is a few dozen small launches.
"""

from __future__ import annotations

import torch

# causal neighbours as (slab, row shift): slab 0/1/2 = diagonals t-1/t-2/
# t-3, shift 1 reads the row above
_W, _NE, _N, _NW = ('W', 'NE', 'N', 'NW')
_NEIGHBOR_TAPS = {_W: (0, 0), _NE: (0, 1), _N: (1, 1), _NW: (2, 1)}

# the neighbour set of each primary direction, in TSGM order (the JAX
# package's candidate fans)
_FANS = {
    'a': {'E': (_W, _N, _NW, _NE), 'SE': (_NW, _N, _W, _NE),
          'S': (_N, _W, _NW, _NE), 'SW': (_NE, _N, _NW, _W)},
    'b': {'E': (_W, _NW, _NE, _N), 'SE': (_NW, _N, _W, _NE),
          'S': (_N, _NW, _NE, _W), 'SW': (_NE, _N, _NW, _W)},
    'd': {'E': (_W, _N, _NW, _NE), 'SE': (_NW, _W, _N, _NE),
          'S': (_N, _W, _NW, _NE), 'SW': (_NE, _NW, _N, _W)},
    'c': {'E': (_W, _N, _NE, _NW), 'SE': (_NW, _N, _W, _NE),
          'S': (_N, _NE, _NW, _W), 'SW': (_NE, _N, _W, _NW)},
}

_BIG = 1e30


def _skew(vol, W, H):
    """(H, W, ...) -> (T, H, ...) with skew[t, y] = vol[y, t - 2y], zero
    where t - 2y lies outside [0, W)."""
    T = W + 2 * (H - 1)
    dev = vol.device
    padded = torch.cat([vol, torch.zeros_like(vol[:, :1])], dim=1)
    ts = torch.arange(T, device=dev)[:, None]
    ys = torch.arange(H, device=dev)[None, :]
    xs = ts - 2 * ys
    xs = torch.where((xs >= 0) & (xs < W), xs, W)
    return padded[ys, xs]


def _unskew(skewed, W, H):
    """(T, H, ...) -> (H, W, ...), the inverse of :func:`_skew`."""
    dev = skewed.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    return skewed[xs + 2 * ys, ys]


def _min_conv(L, p1, p2):
    """min(L[d], L[d +- 1] + P1, min_d L + P2) - min_d L on the last axis;
    ``p2`` broadcasts against L's leading axes."""
    big = torch.full_like(L[..., :1], _BIG)
    lm = torch.cat([big, L[..., :-1]], dim=-1)
    lp = torch.cat([L[..., 1:], big], dim=-1)
    m = L.amin(dim=-1, keepdim=True)
    return torch.minimum(torch.minimum(L, torch.minimum(lm, lp) + p1),
                         m + p2) - m


def _argmin_last(L):
    """Lowest index of the minimum over the last axis, as int32."""
    D = L.shape[-1]
    mn = L.amin(dim=-1, keepdim=True)
    ids = torch.arange(D, device=L.device)
    return torch.where(L == mn, ids, D).amin(dim=-1).to(torch.int32)


def _half_pass(cost, p1, p2_map, tsgm: int, directions, fan: str = 'a'):
    """The causal traversals of one raster order.

    Args:
        cost: (H, W, D) float32, finite.
        p1: float; p2_map: (H, W) float32 per-pixel P2.
        directions: primary direction names of :data:`_FANS`.
    Returns:
        (S (H, W, D) the traversals' volumes summed in order, votes
        (n_dir, H, W) int32 the WTA of each traversal)."""
    H, W, D = cost.shape
    dev = cost.device
    T = W + 2 * (H - 1)
    nd = len(directions)
    skew_c = _skew(cost, W, H)                               # (T, H, D)
    skew_p2 = _skew(p2_map.to(torch.float32)[..., None], W, H)  # (T, H, 1)
    ys = torch.arange(H, device=dev)
    p1 = torch.tensor(p1, dtype=torch.float32, device=dev)
    # the neighbours of each TSGM level, one per traversal
    levels = [[_FANS[fan][d][j] for d in directions] for j in range(tsgm)]
    zero_row = torch.zeros((nd, 1, D), dtype=torch.float32, device=dev)
    slabs = [torch.zeros((nd, H, D), dtype=torch.float32, device=dev)
             for _ in range(3)]
    S_skew = torch.empty((T, H, D), dtype=torch.float32, device=dev)
    votes_skew = torch.empty((T, nd, H), dtype=torch.int32, device=dev)
    for t in range(T):
        c_t, p2_t = skew_c[t], skew_p2[t]
        x = t - 2 * ys
        cur_ok = (x >= 0) & (x < W)
        ok = {_W: cur_ok & (x >= 1),
              _NE: cur_ok & (ys >= 1) & (x + 1 < W),
              _N: cur_ok & (ys >= 1),
              _NW: cur_ok & (ys >= 1) & (x >= 1)}
        above = [torch.cat([zero_row, s[:, :-1]], dim=1) for s in slabs]
        contrib = torch.zeros((nd, H, D), dtype=torch.float32, device=dev)
        cnt = torch.zeros((nd, H), dtype=torch.float32, device=dev)
        for names in levels:
            Lnb = torch.stack([
                (above if _NEIGHBOR_TAPS[n][1] else slabs)
                [_NEIGHBOR_TAPS[n][0]][k] for k, n in enumerate(names)])
            okk = torch.stack([ok[n] for n in names])        # (nd, H)
            mc = _min_conv(Lnb, p1, p2_t)
            contrib = contrib + torch.where(okk[..., None], mc, 0.0)
            cnt = cnt + okk.to(torch.float32)
        L = c_t + contrib / torch.clamp(cnt, min=1.0)[..., None]
        L = torch.where(cur_ok[:, None], L, 0.0)
        S_t = L[0]
        for k in range(1, nd):
            S_t = S_t + L[k]
        S_skew[t] = S_t
        votes_skew[t] = _argmin_last(L)
        slabs = [L, slabs[0], slabs[1]]
    S = _unskew(S_skew, W, H)                                # (H, W, D)
    votes = _unskew(votes_skew.transpose(1, 2), W, H)        # (H, W, nd)
    return S, votes.permute(2, 0, 1)


def mgm_aggregate(cost, p1, p2, nb_dir: int = 8, tsgm: int = 3,
                  p2_map=None, overcount_fix: bool = True, fan: str = 'a'):
    """The MGM aggregation over ``nb_dir`` traversals.

    Args:
        cost: (H, W, D) float32 matching cost, finite everywhere.
        p1, p2: scalar penalties.
        nb_dir: 2, 4 or 8 traversals (the mgm ``-O`` flag).
        tsgm: causal neighbours per traversal (1 to 4).
        p2_map: optional (H, W) per-pixel P2.
        overcount_fix: subtract (nb_dir - 1) * cost from the sum.
        fan: the neighbour order of :data:`_FANS`.
    Returns:
        (S (H, W, D) float32, votes (n_trav, H, W) int32)."""
    H, W, D = cost.shape
    cost = cost.to(torch.float32)
    if p2_map is None:
        p2_map = torch.full((H, W), float(p2), dtype=torch.float32,
                            device=cost.device)
    p1 = float(torch.tensor(p1, dtype=torch.float32))
    if nb_dir >= 8:
        dirs = ('E', 'SE', 'S', 'SW')
    elif nb_dir >= 4:
        dirs = ('E', 'S')
    else:
        dirs = ('E',)
    S_f, votes_f = _half_pass(cost, p1, p2_map, tsgm, dirs, fan)
    S_b, votes_b = _half_pass(cost.flip(0, 1), p1, p2_map.flip(0, 1), tsgm,
                              dirs, fan)
    S = S_f + S_b.flip(0, 1)
    votes = torch.cat([votes_f, votes_b.flip(1, 2)], dim=0)
    if overcount_fix:
        S = S - (2 * len(dirs) - 1) * cost
    return S, votes
