"""The devices of a run: the process-wide device list that ``--devices``
sets, and the region-batch step over the ranks of a ``torch.distributed``
group.

Counterpart of lorikeet_tpu/parallel/sharding.py.  The reference scales with
shared-memory thread pools (rayon par_iter over contigs/chunks/regions,
reference/src/haplotype/haplotype_caller_engine.rs:443-465,
assembly_region_walker.rs:139-141) and reduces per-chunk results with
fold/reduce (:599-619).  The JAX package's process-wide mesh
(``configure_mesh`` / ``get_mesh``) becomes a process-wide list of torch
devices (``configure_devices`` / ``get_devices``): one process drives every
card of the list, as one JAX process drives its mesh.  The pair-HMM
dispatch splits each batch's table blocks over the list
(ops/pairhmm_cuda.py), the activity chain splits the position axis over it
(parallel/pipeline.py), and the pool's device service serves both to the
``-t`` workers (parallel/pool.py).  The group form below splits a pair
batch over the ranks of a process group instead, one card each: per-pair
likelihood evaluation is embarrassingly parallel, and the [samples,
positions] depth matrices reduce with ``all_reduce``; with no group
initialised it runs at world size 1.
"""
from __future__ import annotations

import numpy as np
import torch

from lorikeet_tpu_torch.ops.pairhmm_cuda import (
    pairhmm_forward_sharded, rank_share,
)

#: the devices of this run, set once by configure_devices (None: never
#: configured, which means the first visible card)
_DEVICES: list | None = None


def visible_cards() -> list:
    """Every CUDA card this process sees, in order: what ``--devices``
    picks from.  One small function, so that a caller can put other
    devices in the cards' place (the tests: CPU devices, which run the
    kernels' plain versions)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _cards(n) -> list:
    """The first ``n`` visible cards (every one when ``n`` is None): an
    error without a card, and an error naming both counts when fewer than
    ``n`` are visible (never fewer devices than asked for)."""
    cards = visible_cards()
    if not cards:
        from lorikeet_tpu_torch.device import require_cuda
        require_cuda()
        raise RuntimeError("no CUDA device: torch.cuda.device_count() is 0")
    if n is not None and n > len(cards):
        raise ValueError(f"--devices {n}: only {len(cards)} CUDA device(s) "
                         "are visible")
    return cards if n is None else cards[:n]


def configure_devices(spec="auto", on_card: bool = True) -> list:
    """Resolve the ``--devices`` knob and make it the process's device
    list: 'auto' = every visible card, N = the first N, None / 0 / 1 = one
    card.  ``on_card`` False (``--force-cpu``) makes the list the CPU,
    whatever the spec.  Returns the list."""
    global _DEVICES
    if not on_card:
        devices = [torch.device("cpu")]
    elif spec == "auto":
        devices = _cards(None)
    elif spec in (None, "none"):
        devices = _cards(1)
    else:
        try:
            n = int(spec)
        except (TypeError, ValueError):
            raise ValueError(f"--devices {spec!r}: want 'auto' or a count "
                             "of cards") from None
        if n < 0:
            raise ValueError(f"--devices {n}: want 'auto' or a count of "
                             "cards")
        devices = _cards(max(n, 1))
    _DEVICES = devices
    return list(devices)


def get_devices() -> list:
    """The process's device list (see configure_devices); before any
    configuration, the first visible card (an error without one)."""
    return list(_DEVICES) if _DEVICES is not None else _cards(1)


def region_batch_step(group=None, n_samples: int = 8, device="cuda"):
    """The multi-card unit of work: flat-kernel pair-HMM likelihoods for a
    batch of (read, hap) pairs with the pairs split over the group's ranks,
    plus an all-reduced [samples, positions] depth reduction mirroring the
    reference's rayon fold over chunk depth arrays
    (haplotype_caller_engine.rs:599-619).

    Returns ``step(haps, hap_lens, reads, read_lens, quals, iq, dq, gcp,
    sample_ids, depths) -> (lk [B], total [n_samples, P])`` as numpy; every
    rank passes the whole batch and gets the whole result."""
    device = torch.device(device)

    def step(haps, hap_lens, reads, read_lens, quals, iq, dq, gcp,
             sample_ids, depths):
        lk = pairhmm_forward_sharded(haps, hap_lens, reads, read_lens, quals,
                                     iq, dq, gcp, device=device, group=group)
        depths = np.asarray(depths, np.float32)
        lo, hi, _, world = rank_share(len(sample_ids), group)
        sid = torch.from_numpy(
            np.asarray(sample_ids[lo:hi], np.int64)).to(device)
        dep = torch.from_numpy(depths[lo:hi]).to(device)
        total = torch.zeros((n_samples,) + depths.shape[1:],
                            dtype=torch.float32, device=device)
        total.index_add_(0, sid, dep)
        if world > 1:
            import torch.distributed as dist
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return lk, total.cpu().numpy()

    return step


def demo_inputs(n_pairs: int, n_samples: int = 2, R: int = 16, H: int = 32,
                seed: int = 0):
    """Tiny synthetic sharded-step inputs (for dry runs and tests)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    haps = bases[rng.integers(0, 4, (n_pairs, H))]
    reads = np.stack([h[:R] for h in haps])
    return (
        haps, np.full(n_pairs, H, np.int32),
        reads, np.full(n_pairs, R, np.int32),
        np.full((n_pairs, R), 30, np.uint8), np.full((n_pairs, R), 45, np.uint8),
        np.full((n_pairs, R), 45, np.uint8), np.full((n_pairs, R), 10, np.uint8),
        rng.integers(0, n_samples, n_pairs).astype(np.int32),
        rng.random((n_pairs, 8), np.float32),
    )
