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


def initialize_distributed(coordinator: str = None, num_processes: int = None,
                           process_id: int = None, device=None) -> tuple:
    """Bring up the default ``torch.distributed`` process group when a
    coordinator address (``host:port``) is supplied; a no-op otherwise.
    Returns the (process_index, process_count) in effect.

    The group is NCCL over the cards, the rank's card (``process_id``
    modulo the visible cards) bound first, unless ``device="cpu"`` asks for
    the host, which gets gloo.  Without a card and without that request it
    is an error, never a silent gloo group."""
    if coordinator:
        import torch
        import torch.distributed as dist
        if num_processes is None or process_id is None:
            raise ValueError("initialize_distributed: a coordinator needs "
                             "num_processes and process_id (nothing on "
                             "the machine names them)")
        if device is not None and torch.device(device).type == "cpu":
            backend = "gloo"
        else:
            from lorikeet_tpu_torch.device import require_cuda
            require_cuda()
            torch.cuda.set_device(process_id % torch.cuda.device_count())
            backend = "nccl"
        dist.init_process_group(backend, init_method="tcp://" + coordinator,
                                world_size=num_processes, rank=process_id)
    return distributed_context()
