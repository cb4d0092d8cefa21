"""The region-batch step over the ranks of a ``torch.distributed`` group.

Counterpart of lorikeet_tpu/parallel/sharding.py.  The reference scales with
shared-memory thread pools (rayon par_iter over contigs/chunks/regions,
reference/src/haplotype/haplotype_caller_engine.rs:443-465,
assembly_region_walker.rs:139-141) and reduces per-chunk results with
fold/reduce (:599-619).  Here the pair batch is split over the ranks of a
process group, one card each: per-pair likelihood evaluation is
embarrassingly parallel, and the [samples, positions] depth matrices reduce
with ``all_reduce``.  The JAX package's mesh (``make_mesh`` / ``set_mesh``)
has no counterpart: the group is an argument, and with no group initialised
every function here runs at world size 1.
"""
from __future__ import annotations

import numpy as np
import torch

from lorikeet_tpu_torch.ops.pairhmm_cuda import (
    pairhmm_forward_sharded, rank_share,
)


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
