"""Several processes over one scene: initialization, tile blocks, barriers.

Counterpart of ``s2p_tpu/parallel/distributed.py`` on ``torch.distributed``
with the gloo backend.  Each process owns a contiguous block of the tile
list (:func:`partition_tiles`) and runs the per-tile stages on it; the
processes share the output directory, and the stages meet at barriers
(:func:`barrier`); the global steps (stage 2, 5c and 7) run on the
primary (:func:`is_primary`).  Gloo, not NCCL: the processes' collectives
carry a few bytes between stages, and gloo lets several processes share
one GPU, which NCCL refuses.

The run is configured by :func:`init`'s arguments or, when they are
omitted, by the variables ``S2P_TPU_COORDINATOR`` (``host:port`` of the
rendezvous, which process 0 opens), ``S2P_TPU_NUM_PROCESSES`` and
``S2P_TPU_PROCESS_ID``.  In one process every function is the identity.
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as tdist

# a stage may take long on one process while the others wait at its
# barrier
_TIMEOUT = datetime.timedelta(hours=6)


def init(coordinator_address=None, num_processes=None, process_id=None):
    """Join the process group when a run of several processes is
    configured; a no-op otherwise, and when the group is already up.

    Returns (process count, process index)."""
    coordinator_address = coordinator_address or \
        os.environ.get('S2P_TPU_COORDINATOR')
    num_processes = num_processes if num_processes is not None else \
        int(os.environ.get('S2P_TPU_NUM_PROCESSES', '0') or 0)
    process_id = process_id if process_id is not None else \
        int(os.environ.get('S2P_TPU_PROCESS_ID', '-1'))
    if (coordinator_address and num_processes > 1
            and not tdist.is_initialized()):
        tdist.init_process_group('gloo',
                                 init_method=f'tcp://{coordinator_address}',
                                 world_size=num_processes, rank=process_id,
                                 timeout=_TIMEOUT)
    return process_count(), process_index()


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def partition_tiles(items, index=None, count=None):
    """The contiguous block of ``items`` owned by process ``index`` of
    ``count`` (default this process): items[n*i//c : n*(i+1)//c]."""
    count = count if count is not None else process_count()
    index = index if index is not None else process_index()
    n = len(items)
    lo = (n * index) // count
    hi = (n * (index + 1)) // count
    return items[lo:hi]


def barrier(name='stage'):
    """Wait for every process (a stage boundary); a no-op in one process.
    ``name`` labels the boundary for the reader."""
    if process_count() > 1:
        tdist.barrier()


def is_primary() -> bool:
    return process_index() == 0
