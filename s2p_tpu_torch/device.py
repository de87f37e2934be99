"""Device resolution for the port's entry points.

``None`` means the GPU: an entry point never drops to the CPU on its own.
The CPU is used only when the caller names it, as the tests do.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` resolves to ``cuda`` and raises if CUDA is not available;
    ``"cpu"`` (or any explicit device) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                's2p_tpu_torch runs on CUDA by default and no CUDA device '
                'is available; pass device="cpu" to run the plain PyTorch '
                'versions of the kernels on the CPU')
        return torch.device('cuda')
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} requested but CUDA is not '
                           'available')
    return dev
