"""Census transform of the classic SGM matcher.

Counterpart of ``census_transform`` in ``s2p_tpu/ops/census.py``: the
signature of a pixel has one bit per neighbour of its win x win window,
set where the neighbour is below the centre.  NaN centres compare as 0,
window samples outside the image as +inf (never below the centre), and a
pixel is valid when it and its whole window are finite.  The port keeps
one 32-bit word per pixel, so windows up to 5x5.
"""

from __future__ import annotations

import torch


def census_transform(img, win: int = 5):
    """(signature, valid) of a (..., h, w) image.

    Returns the signatures as int32 bit patterns of shape (..., h, w) and
    the validity mask (bool, same shape)."""
    nbits = win * win - 1
    if nbits > 31:
        raise NotImplementedError('census windows above 5x5 need several '
                                  'signature words (ROADMAP M12)')
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    r = win // 2
    finite = torch.isfinite(img)
    center = torch.nan_to_num(img)
    pad = torch.nn.functional.pad(center, (r, r, r, r), value=float('inf'))
    pad_fin = torch.nn.functional.pad(finite.to(torch.uint8), (r, r, r, r),
                                      value=0) == 1
    sig = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    valid = finite
    bit = 0
    for dy in range(win):
        for dx in range(win):
            if dy == r and dx == r:
                continue
            nb = pad[..., dy:dy + h, dx:dx + w]
            sig = sig | ((nb < center).to(torch.int32) << bit)
            valid = valid & pad_fin[..., dy:dy + h, dx:dx + w]
            bit += 1
    return sig, valid
