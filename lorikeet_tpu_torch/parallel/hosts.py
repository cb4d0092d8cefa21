"""Multi-process work distribution: which share of the genomes this process
takes.  Counterpart of lorikeet_tpu/parallel/hosts.py with
``torch.distributed`` in place of ``jax.distributed``; ``host_shard`` is
imported from there unchanged."""
from __future__ import annotations

import os


def distributed_context():
    """(process_index, process_count) for the current run.

    Honours an explicit LORIKEET_PROCESS_INDEX/COUNT override (launchers
    that shard before any process group exists, and tests), else asks an
    initialised ``torch.distributed`` process group; single-process when
    neither is available."""
    env_idx = os.environ.get("LORIKEET_PROCESS_INDEX")
    env_cnt = os.environ.get("LORIKEET_PROCESS_COUNT")
    if env_cnt is not None:
        return int(env_idx or 0), int(env_cnt)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
