"""PyTorch/CUDA port of the s2p_tpu satellite stereo pipeline.

The port runs on an NVIDIA GPU: plain array code is PyTorch, and every
Pallas kernel of ``s2p_tpu`` is a CUDA kernel under ``csrc/``, built with
``nvcc`` at first use and bound through ``ctypes`` (``ops/_build.py``).
Every kernel has a plain PyTorch version beside it that runs on the CPU.

The package imports torch, numpy and scipy only.  Its entry points take
``device=None`` and then run on CUDA; they raise when CUDA is missing
unless the caller asks for ``device="cpu"``.

Ported so far: a pair scene from its config file to its ``dsm.tif``,
through :func:`s2p_tpu_torch.pipeline.main` (or ``python3 -m
s2p_tpu_torch.cli config.json``): the config, RPC loading, the tiling and
its masks, stages 1 to 5 on the device (SIFT pointing, the global
pointing fit, rectification, ``mgm`` matching, triangulation) and stages
6 and 7 on the host (the tile DSMs and their mosaic), for two images
or more; the matchers ``mgm``, ``mgm_multi``, ``mgm_multi_lsd``, ``sgbm``
and the ``hirschmuller08`` variants (``ops/mgm_flow.py``, ``ops/sgm.py``
with the MGM wavefront of ``ops/mgm.py``); and several processes over one
scene on a gloo group (``parallel/``).  Not yet: SIFT's host route and
the matchers ``hirschmuller02``, ``msmw*`` and ``tvl1``.
"""
