"""PyTorch/CUDA port of the s2p_tpu satellite stereo pipeline.

The port runs on an NVIDIA GPU: plain array code is PyTorch, and every
Pallas kernel of ``s2p_tpu`` is a CUDA kernel under ``csrc/``, built with
``nvcc`` at first use and bound through ``ctypes`` (``ops/_build.py``).
Every kernel has a plain PyTorch version beside it that runs on the CPU.

The package imports torch, numpy and scipy only.  Its entry points take
``device=None`` and then run on CUDA; they raise when CUDA is missing
unless the caller asks for ``device="cpu"``.

Ported so far: stage 4 (stereo matching) with the default ``mgm`` matcher,
through :func:`s2p_tpu_torch.pipeline.stereo_matching_all`; the single-tile
``mgm`` entry and the classic SGM census matcher (``ops/mgm_flow.py``,
``ops/sgm.py``); and stage 5 in pair mode (triangulation, the 3D filter
and the tile's ``cloud.ply``), through
:func:`s2p_tpu_torch.pipeline.disparity_to_ply_all`.
"""
