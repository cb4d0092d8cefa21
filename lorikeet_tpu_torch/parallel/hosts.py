"""Multi-process work distribution: which share of the genomes this process
takes.  Counterpart of lorikeet_tpu/parallel/hosts.py with
``torch.distributed`` in place of ``jax.distributed``."""
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


def group_rank_world(group=None) -> tuple:
    """(rank, world size) in ``group`` (None: the default group) of an
    initialised ``torch.distributed``; (0, 1) when there is none."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def host_shard(items: list, process_index: int = None,
               process_count: int = None) -> list:
    """Deterministic round-robin shard of independent work items for this
    host.  Round-robin (not block) so that genome-size skew spreads evenly
    when inputs are sorted by size."""
    if process_count is None:
        process_index, process_count = distributed_context()
    if process_count <= 1:
        return list(items)
    return [x for i, x in enumerate(items)
            if i % process_count == process_index]


def even_shares(n_items: int, n: int) -> list:
    """(lo, hi) of each of ``n`` contiguous shares of ``n_items`` items, in
    order: the shares differ by at most one item, the larger ones first, so
    that with fewer items than shares the last ones are empty."""
    per, extra = divmod(n_items, n)
    cuts = [i * per + min(i, extra) for i in range(n + 1)]
    return list(zip(cuts[:-1], cuts[1:]))
